"""The benchmark's files: BENCHMARK.json against the contract it is
written to, and every configuration, traffic, cell, metric and stage file
found by its name."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from vo_bench import cells, judge

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vo_bench"] and not BENCH["paths"][0].endswith("_torch")
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_the_contract_keys_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vo_bench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    c = cells.find(cell)
    assert c.config["vo_config"]["dtype"] == "float32"
    assert c.traffic["frames"] > 0 and c.traffic["segments"] >= 1
    assert c.spec["limits"]["repeat"] == 0.0
    assert {m["name"] for m in c.end_to_end} == {"vo_frames_per_sec", "setup_s"}
    assert c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_each_limit_and_sample_count_names_what_the_comparison_has(cell):
    """A limit names ``repeat``, a built-in stage's number or a stage
    file's (one on anything else would read "missing" in every run); a
    sample count names a built-in stage or a stage file."""
    stages = judge.stage_files(cells.HERE)
    numbers = {"repeat", *(n for names in judge.NUMBERS.values() for n in names),
               *(n for mod in stages.values() for n in mod.NUMBERS)}
    spec = cells.find(cell).spec
    assert set(spec["limits"]) <= numbers
    assert set(spec["samples"]) <= {*judge.STAGES, *stages}


def test_stage_files_have_names_and_numbers_of_their_own():
    stages = judge.stage_files(cells.HERE)  # refuses a taken name or number
    assert all(NAME.match(s) for s in stages)
    assert not set(stages) & {*judge.STAGES, "frame", "ba_step"}
    numbers = [n for mod in stages.values() for n in mod.NUMBERS]
    assert len(numbers) == len(set(numbers))
    assert not set(numbers) & {"repeat", *(n for names in judge.NUMBERS.values() for n in names)}


def test_loading_a_stage_file_imports_nothing_of_the_program(tmp_path):
    """The repository's stage files and two that wrap the program's
    functions, loaded: no module of the port, the JAX package or JAX."""
    code = f"""
import json, sys
from pathlib import Path
from vo_bench import cells, judge
from vo_bench.tests.conftest import GATE_STAGE, KNN_STAGE, write_bench
_, here = write_bench(Path({str(tmp_path)!r}), stages={{"toy": GATE_STAGE, "knn": KNN_STAGE}})
loaded = {{**judge.stage_files(cells.HERE), **judge.stage_files(here)}}
print(json.dumps([sorted(loaded), sorted({{m.split(".")[0] for m in sys.modules}})]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=cells.ROOT)
    loaded, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"toy", "knn"} <= set(loaded)
    assert not set(tops) & {"pmv_tpu_torch", "pmv_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=[m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_its_reader(metric):
    mod = cells.metric_reader(metric["name"])
    assert (mod.UNIT, mod.MOVES, mod.SOURCE) == (metric["unit"], metric["moves"], metric["source"])


def test_a_reader_with_nothing_to_read_returns_nothing():
    from types import SimpleNamespace

    empty = SimpleNamespace(drives=[], spans=[], trace=None, cfg=None, shape=(370, 1226), segments=1)
    for m in BENCH["per_layer"]:
        assert cells.metric_reader(m["name"]).read(empty) is None


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.find("no_such.cell")


def test_lk_level_bytes_at_main_shapes():
    """The byte bound of chip_smoke.py at main's shapes (N 512, window 21,
    search 10, Rg 55), level by level; their mean is PERF.md's 0.002353 ms."""
    lk = cells.metric_reader("lk_level_roofline")
    sizes = [(370, 1226), (185, 613), (92, 306), (46, 153), (23, 76)]
    got = [lk.level_bytes(h, w, 512, 21, 10) for h, w in sizes]
    assert got[0] == (370 * 1226 + 512 * (24 * 24 + 6)) * 4 + 512 * (55 * 55 + 5) * 4 + 512
    assert got[1] == (185 * 613 + 512 * 582) * 4 + 512 * 3030 * 4 + 512
    mean_ms = sum(got) / len(got) / lk.PEAK_BYTES_PER_S * 1e3
    assert abs(mean_ms - 0.002353) < 5e-7


@pytest.mark.parametrize("stress", [{}, {"noise_std": 4.0, "vignette": 0.3}], ids=["corridor", "photo"])
def test_the_drives_are_the_ports_synthetic_sequence(tmp_path, stress):
    """The frozen scene generator writes the frames, calibration and poses
    that the port's ``io.synthetic`` writes, byte for byte."""
    import filecmp

    import numpy as np

    from pmv_tpu_torch.io import synthetic
    from vo_bench import data

    traffic = {"scene": {"family": "corridor", "shape": [96, 160], "K": "kitti", "density": 150.0,
                         "speed": 1.0, "yaw_rate": 0.004, **stress}, "frames": 20}
    paths, frames = data.materialize(traffic, 2**31 + 7, tmp_path / "made")
    seq = synthetic.make_sequence(n_frames=20, shape=(96, 160), K=synthetic.KITTI_K, density=150.0,
                                  speed=1.0, yaw_rate=0.004, seed=2**31 + 7, **stress)
    port = synthetic.write_kitti_layout(seq, tmp_path / "port")
    assert np.array_equal(frames, seq["images"].astype(np.uint8))
    for k in ("camera_calibration", "poses"):
        assert filecmp.cmp(paths[k], port[k], shallow=False)
    assert filecmp.cmp(f"{paths['image_dir']}/000013.png", f"{port['image_dir']}/000013.png", shallow=False)
    again, frames2 = data.materialize(traffic, 2**31 + 7, tmp_path / "made")  # from the cache
    assert again == paths and np.array_equal(frames, frames2)
