"""Runs of the harness on the CPU at the tiny 96x160 size: the last line's
keys, a cell that exists only as data, the correctness check against the
control and against faults planted in the timed path, and what a run
imports."""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import pytest
import torch

from vo_bench import cells, control, run
from vo_bench.tests.conftest import TINY_LIMITS, write_bench

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def tiny_run(tmp_path, trace: int = 0, segments: int = 1, frames: int = 16):
    bench, here = write_bench(tmp_path, segments=segments, frames=frames)
    args = run.parse(["--workload", "tiny.corridor16", "--seed", "3000000001", "--seconds", "0.5",
                      "--trace", str(trace)])
    return run.run(args, torch.device("cpu"), time.perf_counter(), bench_file=bench, here=here,
                   data_root=tmp_path / "data")


def test_a_cell_written_as_data_runs_and_prints_the_contract_keys(tmp_path):
    res = tiny_run(tmp_path)
    line = json.loads(json.dumps(res))
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 16
    assert set(line["metrics"]) == {"vo_frames_per_sec", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["compared"]) == set(TINY_LIMITS)
    assert all(v["value"] <= v["limit"] for v in line["compared"].values())


def test_a_traced_run_prints_the_per_layer_metrics(tmp_path):
    res = json.loads(json.dumps(tiny_run(tmp_path, trace=1)))
    assert list(res) == KEYS and res["correct"] is True
    got = set(res["metrics"])
    # the device's metrics come from the card's trace: none on the CPU
    assert got == {"entry_overhead_share", "step_ms.pnp", "step_ms.bootstrap", "bootstrap_share",
                   "ba_call_ms"}
    assert 0 < res["metrics"]["bootstrap_share"]["value"] < 1


def test_a_segmented_cell_compares_the_stitch(tmp_path):
    bench, here = write_bench(tmp_path, segments=2, frames=24,
                              limits=dict(TINY_LIMITS, stitch_rel=1e-9))
    args = run.parse(["--workload", "tiny.corridor16", "--seed", "7", "--seconds", "0.1", "--trace", "0"])
    res = run.run(args, torch.device("cpu"), time.perf_counter(), bench_file=bench, here=here,
                  data_root=tmp_path / "data")
    assert res["compared"]["stitch_rel"]["value"] == 0.0


def _frozen_state(orig):
    @functools.wraps(orig)
    def step(state, *a, **k):
        _, src, stats = orig(state, *a, **k)
        return state, src, stats
    return step


def _half_the_tracks(orig):
    @functools.wraps(orig)
    def track(*a, **k):
        table, blocks = orig(*a, **k)
        valid = table.valid.clone()
        valid[::2] = False
        return table._replace(valid=valid), blocks
    return track


def _pose_moved(orig):
    @functools.wraps(orig)
    def gate(*a, **k):
        R, t, R_s, t_s, acc = orig(*a, **k)
        return R, t + 0.01, R_s, t_s, acc
    return gate


def _ba_unchanged(orig):
    @functools.wraps(orig)
    def solve(tr, lm, *a, **k):
        _, _, stats = orig(tr, lm, *a, **k)
        return tr.clone(), lm.clone(), stats
    return solve


@pytest.mark.parametrize("where,fault", [
    ("pmv_tpu_torch.pipeline.fused.frame_step", _frozen_state),
    ("pmv_tpu_torch.pipeline.steps.track_step_cached", _half_the_tracks),
    ("pmv_tpu_torch.pipeline.fused.motion_gate", _pose_moved),
    ("pmv_tpu_torch.ba.schur_lm.ba_solve_grid", _ba_unchanged),
], ids=["step_returns_its_state", "half_the_tracks_dropped", "pose_altered_where_made",
        "ba_returns_its_input"])
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, monkeypatch, where, fault):
    import importlib

    mod_name, attr = where.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    res = tiny_run(tmp_path)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["compared"].values())


@pytest.mark.parametrize("seed", [11, 12])
def test_the_control_fails_where_the_program_passes(tmp_path, seed):
    bench, here = write_bench(tmp_path)
    cell = cells.find("tiny.corridor16", bench, here)
    r = control.readings(cell, seed, torch.device("cpu"), data_root=tmp_path / "data")
    lim = {k: v for k, v in TINY_LIMITS.items() if k != "repeat"}
    assert all(r["program"][k] <= lim[k] for k in lim), r["program"]
    assert all(r["control"][k] > lim[k] for k in lim), r["control"]


@pytest.mark.card
def test_the_control_fails_at_the_cells_size_on_the_card(card):
    cell = cells.find("kitti07_ba5x5.corridor118")
    r = control.readings(cell, 6000000001, card)
    lim = {k: v for k, v in cell.spec["limits"].items() if k != "repeat"}
    assert all(r["program"][k] <= lim[k] for k in lim if k in r["program"]), r["program"]
    assert any(r["control"][k] > lim[k] for k in lim if k in r["control"]), r["control"]


def test_a_run_imports_neither_jax_nor_the_jax_package(tmp_path):
    """The top-level name of every module a CPU run loads, compared whole
    (``pmv_tpu_torch`` begins with ``pmv_tpu``); the harness also loads no
    module of ``pmv_tpu_torch/bench.py``, ``chip_smoke.py`` or ``scripts/``."""
    code = f"""
import json, sys, time, torch
from pathlib import Path
from vo_bench import run
from vo_bench.tests.conftest import write_bench
root = Path({str(tmp_path)!r})
bench, here = write_bench(root)
args = run.parse(["--workload", "tiny.corridor16", "--seed", "5", "--seconds", "0.1", "--trace", "1"])
run.run(args, torch.device("cpu"), time.perf_counter(), bench_file=bench, here=here, data_root=root / "data")
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=cells.ROOT, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "pmv_tpu"}
    assert "pmv_tpu_torch" in tops
    assert not {"pmv_tpu_torch.bench", "chip_smoke", "scripts"} & set(mods)


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import vo_bench.judge, vo_bench.reference.ba, vo_bench.reference.image; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=cells.ROOT)
    tops = set(eval(out.stdout))  # a list of module names printed by the child
    assert not tops & {"pmv_tpu_torch", "pmv_tpu", "jax", "jaxlib", "flax"}
