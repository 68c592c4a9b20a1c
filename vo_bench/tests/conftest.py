"""Fixtures of the benchmark's own tests (run with ``python -m pytest
vo_bench/tests`` from the root of the repository)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from vo_bench import cells

# tests/test_torch_bench.py's 96x160 run, as VOConfig keys
TINY = dict(init_frames=2, min_tracked_features=100, tracked_features_tol=48, bundle_size=4,
            max_iterations=3, feature_capacity=128, map_capacity=512, grid_rows=96,
            grid_cols=160, lk_window=15, lk_levels=2, traj_cap=64, chunk_frames=4)
TINY_SCENE = {"family": "corridor", "shape": [96, 160], "K": "default", "density": 200.0}
# Limits of the tiny cell, set from CPU readings of seeds 11-14 (program:
# lk_px <= 1.9e-4, corner_rel <= 1.4e-7, pose_rad <= 4.7e-4, tri_rel <=
# 3.6e-4, ba_rise < 0, gate_rel <= 7.7e-8, ba_gain_ratio <= 1.0010; the
# TF32 control: >= 0.062, 4.7e-4, 3.1e-3, 7.9e-3, 8.1e-4, 3.7e-4 and 2418).
# ``essential_support`` is not held here: with the tiny cell's 3-4
# bootstraps of 49-85 correspondences the control holds as many as the
# reference (-0.0047 to 0.0037, seeds 11-14), so no limit separates it from
# the program (-0.0034 to 0); test_vo_bench_judge holds it on 16 scenes of
# the cells' 300.
TINY_LIMITS = {"repeat": 0.0, "lk_px": 0.005, "corner_rel": 1e-5, "pose_rad": 1.2e-3,
               "tri_rel": 2e-3, "ba_rise": 1e-4, "gate_rel": 1e-5, "ba_gain_ratio": 10.0}
SAMPLES = {"lk": 8, "corners": 4, "essential": 4, "pose": 4, "ba": 12, "gate": 100000, "stitch": 100000}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided here, never while a module is
    imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)


def write_bench(root: Path, cell: str = "tiny.corridor16", segments: int = 1, frames: int = 16,
                limits: dict = TINY_LIMITS, vo_config: dict = TINY,
                stages: dict | None = None) -> tuple[Path, Path]:
    """A benchmark in ``root`` that holds one cell of the tiny configuration
    (or ``vo_config``), written as a later change would add one: a
    configuration file, a traffic file, a cell file, the repository's metric
    readers, the stage files ``stages`` (name: source), and entries in a
    copy of ``BENCHMARK.json``. Returns (BENCHMARK.json, its vo_bench)."""
    here = root / "vo_bench"
    for sub in ("configs", "traffic", "workloads"):
        (here / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(cells.HERE / "metrics", here / "metrics", dirs_exist_ok=True)
    config, traffic = cell.split(".", 1)
    (here / "configs" / f"{config}.json").write_text(json.dumps({"name": config, "vo_config": vo_config}))
    for name, source in (stages or {}).items():
        (here / "stages").mkdir(exist_ok=True)
        (here / "stages" / f"{name}.py").write_text(source)
    (here / "traffic" / f"{traffic}.json").write_text(json.dumps(
        {"name": traffic, "scene": TINY_SCENE, "frames": frames, "segments": segments}))
    (here / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"name": cell, "samples": SAMPLES, "limits": limits}))
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name=config, file=f"vo_bench/configs/{config}.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=cell, config=config, traffic=traffic))
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + [cell]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root / "BENCHMARK.json", here


# Stage files as a later change would add them (vo_bench/judge.py's
# docstring): a toy stage stacked on the built-in ``gate`` stage's function,
# and one on the kNN matcher, which no built-in stage wraps.
GATE_STAGE = '''"""Toy stage: the motion gate's new rotation stays a rotation."""
import torch

from vo_bench import record

POINTS = [("pmv_tpu_torch.pipeline.fused", "motion_gate")]
NUMBERS = ["toy_orth", "toy_calls"]


def keep(arguments):
    return {"scale": record._copy(arguments["scale"])}


def judge(rec, index, drv, control):
    R = rec["out"][0].double()
    return {"toy_orth": float((R @ R.T - torch.eye(3, dtype=R.dtype)).abs().max()), "sum.calls": 1.0}


def summed(sums):
    return {"toy_calls": sums["sum.calls"]}
'''
KNN_STAGE = '''"""Toy stage: the kNN matcher keeps no slot the previous frame did not hold."""
from vo_bench import record

POINTS = [("pmv_tpu_torch.frontend.knn_matcher", "knn_match")]
NUMBERS = ["knn_new_slots"]


def keep(arguments):
    return {"valid": record._copy(arguments["prev_table"].valid)}


def keep_out(out):
    return record._copy(out.valid)


def judge(rec, index, drv, control):
    return {"knn_new_slots": float((rec["out"] & ~rec["args"]["valid"]).sum())}
'''
