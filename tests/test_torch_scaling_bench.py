"""``python -m pmv_tpu_torch.scaling_bench`` on the CPU at a tiny size,
against ``scripts/scaling_bench.py``'s rows.

``scripts/scaling_bench.py`` sets XLA's flags and JAX's platform when it is
imported, so the keys of its rows are read from its syntax tree (the dict
literals each leg appends), and ``SCALING.json``'s for the full-width rows.
The legs run at a tiny size: ``dist_ba`` at lm 1 and 2 over gloo, the
work sweep at one per-shard size, ``multi_seq`` at B 1 and 2 for one chunk,
the full-width leg at 96x160 for 4 frames.
"""

import ast
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pmv_tpu_torch import scaling_bench as sb
from pmv_tpu_torch.parallel import multi_seq

# One thread: see tests/test_torch_odometry.py.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_SCRIPT = ROOT / "scripts" / "scaling_bench.py"
CPU = torch.device("cpu")


def jax_row_keys(function: str) -> set:
    """The keys of the dict literal that ``function`` of the JAX script
    appends to its rows."""
    tree = ast.parse(JAX_SCRIPT.read_text(), filename=str(JAX_SCRIPT))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "append" and n.args and isinstance(n.args[0], ast.Dict))
    return {ast.literal_eval(k) for k in call.args[0].keys}


@pytest.fixture(scope="module")
def legs():
    return {
        "dist_ba": sb.bench_dist_ba("cpu", iters=2, Ls=64, shards=(1, 2), repeats=1),
        "dist_ba_worksweep": sb.bench_dist_ba_worksweep("cpu", iters=2, sweep=(64,), repeats=1),
        "multi_seq": sb.bench_multi_seq(CPU, batches=(1, 2), repeats=1, chunks=1),
        "multi_seq_full": sb.bench_multi_seq_full(CPU, batches=(1, 2), frames=4, C=2, shape=(96, 160)),
    }


@pytest.mark.parametrize("leg,function", [("dist_ba", "bench_dist_ba"),
                                          ("dist_ba_worksweep", "bench_dist_ba_worksweep"),
                                          ("multi_seq", "bench_multi_seq")])
def test_rows_carry_the_jax_scripts_keys(legs, leg, function):
    want = jax_row_keys(function)
    assert len(legs[leg]) >= 1
    for row in legs[leg]:
        assert want <= set(row), (leg, want - set(row))
        assert all(np.isfinite(v) for k, v in row.items() if isinstance(v, float)), row


def test_full_width_rows_carry_the_tpu_rows_keys(legs):
    want = set(json.loads((ROOT / "SCALING.json").read_text())["tpu_multiseq_dp_per_chip"][0])
    rows = legs["multi_seq_full"]
    assert [r["B"] for r in rows] == [1, 2] and [r["frames"] for r in rows] == [4, 8]
    for row in rows:
        assert want == set(row)
        assert row["compute_s"] > 0 and row["e2e_s"] > 0


def test_dist_ba_rows_count_the_collectives(legs):
    """One shard issues the solve's collectives too (a group of one), and
    two shards the same calls; an LM iteration's all-reduces carry the same
    numbers (the reduced camera system does not grow with the landmarks),
    the final gathers more."""
    one, two = legs["dist_ba"]
    assert (one["lm_shards"], two["lm_shards"]) == (1, 2)
    assert two["landmarks_total"] == 2 * one["landmarks_total"] == 128
    assert one["collectives"] == two["collectives"] > 0
    assert one["collective_bytes_per_iteration"] == two["collective_bytes_per_iteration"] > 0
    assert two["collective_bytes"] > one["collective_bytes"] > one["collective_bytes_per_iteration"]
    assert one["weak_efficiency"] == 1.0 and two["backend"] == "gloo"


def test_worksweep_baseline_is_pinned_on_the_cpu(legs):
    (row,) = legs["dist_ba_worksweep"]
    assert row["baseline"] == "one shard pinned to one core"
    assert row["weak_efficiency_at_2"] == row["sec_1shard_pinned"] / row["sec_2shards_2x_work"]


def test_a_sequence_steps_alike_alone_and_in_a_batch():
    """Sequence 0's poses after two chunks are the same, bit for bit, at B=1
    and B=2 (its own generator, its own states)."""
    finals = {}
    for B in (1, 2):
        state, imgs, K, cfg = sb.small_states(B, CPU, frames=8)
        step = multi_seq.make_batched_chunk_step(None, cfg, device=CPU)
        finals[B], _ = sb.run_batch(step, state, torch.from_numpy(imgs), K, 4, CPU)
    assert finals[1].k == finals[2].k == 8
    assert torch.equal(finals[1].t_hist[0], finals[2].t_hist[0])
    assert torch.equal(finals[1].R_hist[0], finals[2].R_hist[0])
    assert not torch.equal(finals[2].t_hist[0], finals[2].t_hist[1])  # other data, other poses


def test_main_writes_its_output_and_never_scaling_json(legs, tmp_path, monkeypatch, capsys):
    """``main`` prints every row, writes them to ``--out`` (default
    ``artifacts/torch/scaling.json``) with the device, leaves the JAX
    package's ``SCALING.json`` as it is, and exits 1 when a leg fails."""
    scaling = ROOT / "SCALING.json"
    before = hashlib.sha256(scaling.read_bytes()).hexdigest()
    for leg, fn in (("dist_ba", "bench_dist_ba"), ("dist_ba_worksweep", "bench_dist_ba_worksweep"),
                    ("multi_seq", "bench_multi_seq"), ("multi_seq_full", "bench_multi_seq_full")):
        monkeypatch.setattr(sb, fn, lambda *a, rows=legs[leg], **k: [dict(r) for r in rows])
    monkeypatch.setattr(sb, "_pinned_multi_seq_seconds", lambda: 2.0)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out" / "scaling.json"
    assert sb.main(["--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["device"] == "cpu" and got["failed"] == []
    for leg in legs:
        assert [{k: v for k, v in r.items() if k != "weak_efficiency_vs_pinned_core"}
                for r in got[leg]] == legs[leg]
    assert all("weak_efficiency_vs_pinned_core" in r for r in got["multi_seq"])
    printed = capsys.readouterr().out
    assert printed.count("\n{") == sum(len(v) for v in legs.values())

    def boom(*a, **k):
        raise RuntimeError("leg failed")

    monkeypatch.setattr(sb, "bench_multi_seq_full", boom)
    assert sb.main(["--device", "cpu", "--out", str(out)]) == 1
    assert json.loads(out.read_text())["failed"] == ["multi_seq_full"]
    assert sb.OUT == Path("artifacts/torch/scaling.json")
    assert hashlib.sha256(scaling.read_bytes()).hexdigest() == before
    assert not (tmp_path / "SCALING.json").exists()


def test_no_device_means_gpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the no-GPU check is for machines without a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        sb.main([])
    assert list(tmp_path.iterdir()) == []
