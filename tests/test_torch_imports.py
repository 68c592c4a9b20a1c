"""Guards of the PyTorch/CUDA port's boundaries.

- No module of ``pmv_tpu_torch`` and not ``chip_smoke.py`` imports ``jax`` or
  anything of ``pmv_tpu`` (checked on the syntax tree, and by importing every
  module in a subprocess in which ``jax`` cannot be imported).
- ``OdometryPipeline(cfg)`` with no device raises on a machine without a CUDA
  device instead of running on the CPU.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pmv_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pmv_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_has_the_expected_modules():
    for name in (
        "pmv_tpu_torch.config", "pmv_tpu_torch.cli", "pmv_tpu_torch.convert",
        "pmv_tpu_torch.core.geometry", "pmv_tpu_torch.frontend.lk_kernels",
        "pmv_tpu_torch.frontend.capture", "pmv_tpu_torch.frontend.min_eig",
        "pmv_tpu_torch.solvers.five_point", "pmv_tpu_torch.ba.schur_lm",
        "pmv_tpu_torch.pipeline.fused", "pmv_tpu_torch.pipeline.odometry",
    ):
        assert name in MODULES


def test_every_module_imports_with_jax_blocked():
    """Import every port module where ``import jax`` (or ``pmv_tpu``) fails;
    none of them may need it, nor triton or a compiler, at import time."""
    code = textwrap.dedent(
        f"""
        import importlib, sys
        for blocked in ("jax", "jaxlib", "pmv_tpu", "triton"):
            sys.modules[blocked] = None   # makes `import blocked` raise ImportError
        sys.path.insert(0, {str(ROOT)!r})
        for name in {MODULES!r}:
            importlib.import_module(name)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "pmv_tpu") and sys.modules[m] is not None]
        assert not leaked, leaked
        print("imported", len({MODULES!r}))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert f"imported {len(MODULES)}" in out.stdout


def test_no_device_means_gpu_and_raises_without_one(tmp_path):
    """device=None resolves to CUDA; on a machine without a CUDA device that
    is an error, never a silent CPU run. (On a machine with one, the pipeline
    must land on it.)"""
    import torch

    from pmv_tpu_torch.config import VOConfig
    from pmv_tpu_torch.io import synthetic
    from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

    seq = synthetic.make_sequence(n_frames=2, shape=(48, 64), density=5)
    paths = synthetic.write_kitti_layout(seq, tmp_path)
    cfg = VOConfig(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], frames=2,
    )
    if torch.cuda.is_available():
        assert OdometryPipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            OdometryPipeline(cfg)
    assert OdometryPipeline(cfg, device="cpu").device.type == "cpu"


def test_cli_run_without_gpu_fails(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    from pmv_tpu_torch import cli
    from pmv_tpu_torch.io import synthetic

    seq = synthetic.make_sequence(n_frames=2, shape=(48, 64), density=5)
    paths = synthetic.write_kitti_layout(seq, tmp_path)
    ini = tmp_path / "cfg.ini"
    ini.write_text(
        "map_scale = 1\nframes = 2\n" + "".join(f"{k} = {v}\n" for k, v in paths.items())
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", str(ini)])


def test_unported_options_are_refused_not_ignored(tmp_path):
    from pmv_tpu_torch.config import VOConfig
    from pmv_tpu_torch.io import synthetic
    from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

    seq = synthetic.make_sequence(n_frames=6, shape=(48, 64), density=5)
    paths = synthetic.write_kitti_layout(seq, tmp_path)
    base = dict(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], frames=6, init_frames=2, feature_capacity=16,
        map_capacity=64, lk_window=9, lk_levels=1,
    )
    for extra in (
        {"matcher": "knn"}, {"cont_tri": 1}, {"extractor": "fast"},
        {"essential_solver": "eight_point"}, {"video_path": "x.avi"},
        {"checkpoint_path": "x.npz"},
    ):
        with pytest.raises(NotImplementedError):
            OdometryPipeline(VOConfig(**base, **extra), device="cpu").run()
