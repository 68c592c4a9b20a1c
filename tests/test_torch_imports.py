"""Guards of the PyTorch/CUDA port's boundaries.

- No module of ``pmv_tpu_torch`` and not ``chip_smoke.py`` imports ``jax``,
  anything of ``pmv_tpu`` or anything under ``scripts/`` (checked on the
  syntax tree, and by importing every module in a subprocess in which
  ``jax`` cannot be imported).
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
    return top in ("jax", "jaxlib", "pmv_tpu", "scripts")


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
        "pmv_tpu_torch.frontend.fast", "pmv_tpu_torch.frontend.knn_matcher",
        "pmv_tpu_torch.solvers.five_point", "pmv_tpu_torch.ba.schur_lm",
        "pmv_tpu_torch.pipeline.fused", "pmv_tpu_torch.pipeline.odometry",
        "pmv_tpu_torch.utils.checkpoint", "pmv_tpu_torch.utils.profiling",
        "pmv_tpu_torch.viz.render", "pmv_tpu_torch.viz.video",
        "pmv_tpu_torch.viz.pointcloud", "pmv_tpu_torch.io.native",
        "pmv_tpu_torch.parallel", "pmv_tpu_torch.parallel.pose_graph",
        "pmv_tpu_torch.parallel.dist_ba", "pmv_tpu_torch.parallel.global_refine",
        "pmv_tpu_torch.parallel.multi_seq", "pmv_tpu_torch.pipeline.segmented",
        "pmv_tpu_torch.parallel.mesh", "pmv_tpu_torch.parallel.probe", "pmv_tpu_torch.bench",
        "pmv_tpu_torch.parity_sweep", "pmv_tpu_torch.diag", "pmv_tpu_torch.scaling_bench",
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
    """Every option of ``run`` is ported, and so is the steady-state step
    (refused before): it runs. The options that were refused before run
    now; a mesh argument that is not a ``parallel.mesh.Mesh`` is refused."""
    import torch

    from pmv_tpu_torch.config import VOConfig
    from pmv_tpu_torch.io import synthetic
    from pmv_tpu_torch.pipeline import fused
    from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

    seq = synthetic.make_sequence(n_frames=6, shape=(48, 64), density=5)
    paths = synthetic.write_kitti_layout(seq, tmp_path)
    base = dict(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], frames=6, init_frames=2, feature_capacity=16,
        map_capacity=64, lk_window=9, lk_levels=1, traj_cap=16,
        error_path=str(tmp_path / "err.txt"),
    )
    for extra in ({"cont_tri": 1}, {"video_path": str(tmp_path / "x.avi")},
                  {"checkpoint_path": str(tmp_path / "x.npz")}, {"live_every": 2, "chunk_frames": 2}):
        pipe = OdometryPipeline(VOConfig(**base, **extra), device="cpu")
        assert pipe.run()["frames"] >= 2
    assert (tmp_path / "x.npz").exists() and (tmp_path / "map_live.png").exists()
    state = fused.init_state(
        [torch.zeros((48, 64)), torch.zeros((24, 32))], pipe.tables[0],
        pipe.map, fused.StepConfig(lk_levels=1, lk_window=9, traj_cap=16),
    )
    state, stats = fused.chunk_step(
        state, torch.zeros((1, 48, 64), dtype=torch.uint8), [1.0], None, pipe.K,
        fused.StepConfig(lk_levels=1, lk_window=9, traj_cap=16), steady=True)
    assert state.k == 1 and not bool(stats[0]["used_pnp"])  # an empty map: no PnP frame
    from pmv_tpu_torch.parallel import dist_ba, multi_seq

    for refused in (lambda: dist_ba.make_distributed_ba(mesh=object()),
                    lambda: multi_seq.make_batched_chunk_step(object(), fused.StepConfig())):
        with pytest.raises(TypeError, match="mesh"):
            refused()
