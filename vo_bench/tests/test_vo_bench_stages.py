"""Stages of the comparison added as files (``stages/<stage>.py``), at the
tiny 96x160 size on the CPU: a toy stage is recorded and judged, a fault in
the function it wraps turns ``correct`` false, a stage that no limit names
leaves the built-in readings as they were, and a kNN + FAST cell written as
data alone runs correct with a stage on its matcher."""

from __future__ import annotations

import functools
import time

import pytest
import torch

from vo_bench import cells, control, data, judge, run
from vo_bench.tests.conftest import GATE_STAGE, KNN_STAGE, TINY, TINY_LIMITS, write_bench

SEED = 3000000001


def tiny_run(root, stages=None, limits=TINY_LIMITS, vo_config=TINY):
    bench, here = write_bench(root, limits=limits, vo_config=vo_config, stages=stages)
    args = run.parse(["--workload", "tiny.corridor16", "--seed", str(SEED), "--seconds", "0.3",
                      "--trace", "0"])
    return run.run(args, torch.device("cpu"), time.perf_counter(), bench_file=bench, here=here,
                   data_root=root / "data")


def test_a_stage_file_is_recorded_and_judged(tmp_path):
    res = tiny_run(tmp_path, {"toy": GATE_STAGE}, dict(TINY_LIMITS, toy_orth=1e-4))
    assert res["correct"] is True
    assert set(res["compared"]) == set(TINY_LIMITS) | {"toy_orth"}
    # the toy and the built-in gate stage wrap one function; both recorded
    assert 0 <= res["compared"]["toy_orth"]["value"] <= 1e-4
    assert res["compared"]["gate_rel"]["value"] <= TINY_LIMITS["gate_rel"]


def test_readings_take_each_call_of_a_stage_file_with_its_index(tmp_path):
    bench, here = write_bench(tmp_path, stages={"toy": GATE_STAGE})
    cell = cells.find("tiny.corridor16", bench, here)
    detail = []
    r = control.readings(cell, 12, torch.device("cpu"), data_root=tmp_path / "data", detail=detail,
                         control=False, here=here)
    toy = [(j, n) for stage, j, n, _ in detail[0]["calls"] if stage == "toy"]
    # one gate call in each frame step, each judged (no sample count: all)
    assert len(toy) > 8 and toy == [(j, j) for j in range(len(toy))]
    assert r["program"]["toy_calls"] == len(toy) and r["program"]["toy_orth"] < 1e-4


def _rotation_scaled(orig):
    @functools.wraps(orig)
    def gate(*a, **k):
        R, t, R_s, t_s, acc = orig(*a, **k)
        return R * 1.01, t, R_s, t_s, acc
    return gate


def test_a_fault_in_a_stage_files_function_is_not_correct(tmp_path, monkeypatch):
    from pmv_tpu_torch.pipeline import fused

    monkeypatch.setattr(fused, "motion_gate", _rotation_scaled(fused.motion_gate))
    res = tiny_run(tmp_path, {"toy": GATE_STAGE}, {"repeat": 0.0, "toy_orth": 1e-4})
    assert res["correct"] is False
    assert res["compared"]["toy_orth"]["value"] > 1e-4


def test_a_stage_file_leaves_the_built_in_readings_as_they_were(tmp_path):
    """No limit names the stage: the cell's readings are those of a tree
    without it. A limit names it: the built-in readings still are (stage
    files draw from the seed after the built-in stages)."""
    plain = tiny_run(tmp_path / "plain")["compared"]
    unnamed = tiny_run(tmp_path / "unnamed", {"toy": GATE_STAGE})["compared"]
    named = tiny_run(tmp_path / "named", {"toy": GATE_STAGE}, dict(TINY_LIMITS, toy_orth=1e-4))["compared"]
    assert unnamed == plain
    assert {k: v for k, v in named.items() if k != "toy_orth"} == plain


KNN_FAST = dict(TINY, matcher="knn", extractor="fast")
KNN_LIMITS = dict({k: v for k, v in TINY_LIMITS.items() if k not in ("lk_px", "corner_rel")},
                  knn_new_slots=0.0)


def test_a_knn_fast_cell_written_as_data_is_correct_with_a_stage_on_its_matcher(tmp_path):
    res = tiny_run(tmp_path, {"knn": KNN_STAGE}, KNN_LIMITS, KNN_FAST)
    assert res["correct"] is True, res["compared"]
    assert set(res["compared"]) == set(KNN_LIMITS)

    # the recorded drive: one kNN call in each frame step, and no LK call
    bench, here = write_bench(tmp_path / "again", limits=KNN_LIMITS, vo_config=KNN_FAST,
                              stages={"knn": KNN_STAGE})
    cell = cells.find("tiny.corridor16", bench, here)
    paths, frames = data.materialize(cell.traffic, SEED, tmp_path / "data")
    cfg = run.vo_config(cell, paths, int(cell.traffic["frames"]), SEED)
    calls, _, _, _ = run.recorded_drive(cell, cfg, frames, torch.device("cpu"), judge.stage_files(here))
    assert [c["n"] for c in calls["knn"]] == [c["n"] for c in calls["frame"]] == list(range(len(calls["frame"])))
    assert "lk" not in calls and len(calls["frame"]) > 0


BAD = {
    "a_built_in_name": ({"gate": GATE_STAGE}, "built-in stage"),
    "a_built_in_number": ({"toy": GATE_STAGE.replace('"toy_calls"', '"gate_rel"')}, "gate_rel taken"),
    "another_files_number": ({"toy": GATE_STAGE, "toy2": GATE_STAGE}, "toy_calls, toy_orth taken"),
    "no_judge": ({"toy": GATE_STAGE.replace("def judge(", "def judged(")}, "lacks judge"),
}


@pytest.mark.parametrize("stages,message", BAD.values(), ids=BAD.keys())
def test_a_stage_file_that_breaks_the_contract_is_refused(tmp_path, stages, message):
    _, here = write_bench(tmp_path, stages=stages)
    with pytest.raises(ValueError, match=message):
        judge.stage_files(here)


def test_a_stage_number_outside_its_numbers_is_refused(tmp_path):
    _, here = write_bench(tmp_path, stages={"toy": GATE_STAGE.replace('"toy_orth": float', '"toy_x": float')})
    stages = judge.stage_files(here)
    calls = {"toy": [{"n": 0, "args": {}, "out": (torch.eye(3),)}]}
    with pytest.raises(ValueError, match="toy_x"):
        judge.judge(calls, None, {}, 0, stages=stages)


def test_a_missing_stages_folder_means_no_stage_files(tmp_path):
    assert judge.stage_files(tmp_path) == {}
