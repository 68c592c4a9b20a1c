"""The program's tracer (``pmv_tpu_torch/utils/profiling.py``): spans and
counters off and on, per-thread stacks, the frame prefetcher's ingest spans
and skip counter, and the spans of ``OdometryPipeline.run()`` and
``SegmentedPipeline.run()`` on the CPU, which must leave every output bit
for bit as an untraced run gives it."""

import json
import threading

import numpy as np
import pytest
import torch

from pmv_tpu_torch.config import VOConfig
from pmv_tpu_torch.io import png, synthetic
from pmv_tpu_torch.io.prefetch import FramePrefetcher
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline
from pmv_tpu_torch.pipeline.segmented import SegmentedPipeline
from pmv_tpu_torch.utils import profiling

# One thread, as in the port's other CPU tests (tests/test_torch_odometry.py).
torch.set_num_threads(1)

SHAPE = (96, 160)
FRAMES = 16
RUN_CFG = dict(
    frames=FRAMES, init_frames=2, min_tracked_features=100, tracked_features_tol=48,
    bundle_size=4, max_iterations=3, feature_capacity=128, map_capacity=512,
    grid_rows=96, grid_cols=160, lk_window=15, lk_levels=2, traj_cap=32,
    chunk_frames=4, seed=0,
)
STAGES = ("frontend", "readback", "frontend.reseed", "solvers.pnp", "solvers.bootstrap", "step.gate")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    seq = synthetic.make_sequence(n_frames=FRAMES, shape=SHAPE, density=200, seed=3)
    return synthetic.write_kitti_layout(seq, tmp_path_factory.mktemp("kitti"))


def _cfg(paths, **kw):
    return VOConfig(image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
                    poses=paths["poses"], **{**RUN_CFG, **kw})


def _ancestors(sp):
    out = []
    while sp.parent is not None:
        sp = sp.parent
        out.append(sp.name)
    return out


def _outputs(pipe):
    return (np.stack(pipe.R), np.stack(pipe.t), pipe.frame_stats,
            [(tb.xy, tb.valid, tb.landmark) for tb in pipe.tables], (pipe.map.xyz, pipe.map.alive))


def _same(a, b):
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
            and len(a[3]) == len(b[3])
            and all(torch.equal(x, y) for ta, tb in zip(a[3], b[3]) for x, y in zip(ta, tb))
            and all(torch.equal(x, y) for x, y in zip(a[4], b[4])))


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------


class TestTracer:
    def test_off_records_nothing(self):
        assert profiling._current is None
        a, b = profiling.span("frame"), profiling.span("ba")
        assert a is b  # one shared no-op object
        with a as sp:
            profiling.count("ingest.skipped")
        assert sp is None
        t = profiling.Tracer()
        with profiling.span("frame"):
            profiling.count("x", 3)
        assert t.spans == [] and t.counters == {}

    def test_nesting_parents_and_counters(self):
        t = profiling.Tracer()
        with profiling.tracing(t):
            with profiling.span("run.chunk"):
                with profiling.span("frame") as f:
                    with profiling.span("solvers.pnp"):
                        profiling.count("c")
                    with profiling.span("ba"):
                        profiling.count("c", 2)
            profiling.count("ingest.skipped")
        assert profiling._current is None
        by = {s.name: s for s in t.spans}
        assert [s.name for s in t.spans] == ["solvers.pnp", "ba", "frame", "run.chunk"]  # closing order
        assert by["solvers.pnp"].parent is f and by["ba"].parent is f
        assert f.parent is by["run.chunk"] and by["run.chunk"].parent is None
        assert t.counters == {"c": 3, "ingest.skipped": 1}
        assert all(s.start_ns <= s.end_ns for s in t.spans)
        assert by["run.chunk"].start_ns <= f.start_ns and f.end_ns <= by["run.chunk"].end_ns
        assert {s.thread for s in t.spans} == {threading.get_ident()}

    def test_tracing_nests_and_restores(self):
        outer, inner = profiling.Tracer(), profiling.Tracer()
        with profiling.tracing(outer):
            with profiling.tracing(inner):
                with profiling.span("a"):
                    pass
            with profiling.tracing(None):
                with profiling.span("off"):
                    pass
            with profiling.span("b"):
                pass
        assert [s.name for s in inner.spans] == ["a"] and [s.name for s in outer.spans] == ["b"]

    def test_each_thread_has_its_own_stack(self):
        t = profiling.Tracer()
        opened, release = threading.Event(), threading.Event()

        def worker():
            with profiling.span("ingest.decode"):
                opened.set()
                release.wait(10)

        with profiling.tracing(t):
            with profiling.span("frame") as f:
                th = threading.Thread(target=worker)
                th.start()
                assert opened.wait(10)
                with profiling.span("readback") as r:
                    release.set()
                    th.join(10)
        dec = t.named("ingest.decode")[0]
        assert dec.parent is None and dec.thread != f.thread
        assert r.parent is f  # the worker's open span is not on this thread's stack


# --------------------------------------------------------------------------
# ingest
# --------------------------------------------------------------------------


def _write_frames(d, n):
    files = []
    for k in range(n):
        f = d / f"{k:06d}.png"
        png.write_png(f, (np.arange(24 * 32, dtype=np.uint32).reshape(24, 32) * (k + 1) % 256).astype(np.uint8))
        files.append(f)
    return files


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "one_corrupt_file"])
def test_prefetcher_spans_and_skip_count(tmp_path, corrupt):
    files = _write_frames(tmp_path, 4)
    if corrupt:
        bad = tmp_path / "bad.png"
        bad.write_bytes(b"not a png")
        files.insert(2, bad)
    t = profiling.Tracer()
    with profiling.tracing(t):
        got = list(FramePrefetcher(files))
    assert [i for i, _ in got] == [i for i, f in enumerate(files) if f.name != "bad.png"]
    assert len(t.named("ingest.decode")) == len(files)  # one per file decoded
    assert len(t.named("ingest.wait")) == len(files)  # one per item the producer hands over
    assert t.counters.get("ingest.skipped", 0) == int(corrupt)
    main = threading.get_ident()
    assert all(s.thread != main and s.parent is None for s in t.named("ingest.decode"))
    assert all(s.thread == main for s in t.named("ingest.wait"))
    # without a tracer the same frames, and nothing recorded
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, FramePrefetcher(files)))


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(paths):
    """One untraced and one traced run() of each pipeline on the CPU."""
    out = {}
    for kind in ("sequential", "segmented"):
        make = (lambda: OdometryPipeline(_cfg(paths), device="cpu")) if kind == "sequential" else (
            lambda: SegmentedPipeline(_cfg(paths), segments=2, device="cpu"))
        plain = make()
        plain.run()
        traced, tracer = make(), profiling.Tracer()
        with profiling.tracing(tracer):
            traced.run()
        out[kind] = (plain, traced, tracer)
    return out


@pytest.mark.parametrize("kind", ["sequential", "segmented"])
def test_tracing_leaves_the_outputs_bit_for_bit(runs, kind):
    plain, traced, _ = runs[kind]
    assert _same(_outputs(plain), _outputs(traced))
    assert plain.frame_stats == traced.frame_stats and len(plain.frame_stats) > 0


@pytest.mark.parametrize("kind", ["sequential", "segmented"])
def test_one_frame_span_per_frame_step(runs, kind):
    _, pipe, t = runs[kind]
    frames = t.named("frame")
    assert len(frames) == len(pipe.frame_stats)
    outer = "run.chunk" if kind == "sequential" else "multi_seq.state"
    assert all(outer in _ancestors(f) for f in frames)
    assert len(t.named("readback")) == len(frames) and len(t.named("frontend")) == len(frames)
    n_pnp = sum(bool(s["used_pnp"]) for s in pipe.frame_stats)
    assert len(t.named("solvers.pnp")) == n_pnp
    assert len(t.named("solvers.bootstrap")) == len(frames) - n_pnp
    assert len(t.named("frontend.reseed")) == sum(bool(s["reseed"]) for s in pipe.frame_stats)
    assert len(t.named("ba")) == pipe._ba_calls > 0
    for name in ("ba.window", "ba.solve", "ba.scatter"):
        assert len(t.named(name)) == pipe._ba_calls
        assert all(_ancestors(s)[0] == "ba" for s in t.named(name))


@pytest.mark.parametrize("kind", ["sequential", "segmented"])
def test_every_stage_span_lies_inside_a_frame(runs, kind):
    _, _, t = runs[kind]
    for s in t.spans:
        if s.name.startswith("solvers.") or s.name in ("ba", *STAGES):
            assert _ancestors(s)[0] == "frame", (s.name, _ancestors(s))
            assert s.parent.start_ns <= s.start_ns <= s.end_ns <= s.parent.end_ns


def test_entry_spans_of_the_sequential_run(runs):
    _, pipe, t = runs["sequential"]
    C = RUN_CFG["chunk_frames"]
    n = len(pipe.frame_stats)
    assert [len(t.named(k)) for k in ("run.init", "run.readback")] == [1, 1]
    assert len(t.named("run.chunk")) == len(t.named("run.upload")) == -(-n // C)
    assert all(_ancestors(s) == ["run.chunk"] for s in t.named("run.upload"))
    # a frame handed out by the prefetchers for each init frame and step
    waits = t.named("ingest.wait")
    assert len(waits) == RUN_CFG["init_frames"] + n and t.counters.get("ingest.skipped", 0) == 0
    assert len(t.named("ingest.decode")) >= len(waits)


def test_entry_spans_of_the_segmented_run(runs):
    _, pipe, t = runs["segmented"]
    chunks = len(t.named("run.chunk"))
    assert chunks == -(-pipe.segment_length // RUN_CFG["chunk_frames"])
    assert len(t.named("multi_seq.state")) == len(t.named("multi_seq.put")) == 2 * chunks
    assert [len(t.named(k)) for k in ("segmented.seed", "segmented.stitch", "run.readback")] == [1, 1, 1]
    assert _ancestors(t.named("segmented.stitch")[0]) == ["run.readback"]


def test_checkpoint_save_span(paths, tmp_path):
    t = profiling.Tracer()
    with profiling.tracing(t):
        OdometryPipeline(_cfg(paths, frames=10, checkpoint_path=str(tmp_path / "s.npz"),
                              checkpoint_every=4), device="cpu").run()
    saves = t.named("checkpoint.save")
    assert len(saves) >= 2 and all(s.parent is None for s in saves)
    assert (tmp_path / "s.npz").exists()


def test_trace_annotates_the_program_spans(paths, tmp_path):
    pipe = OdometryPipeline(_cfg(paths, frames=6), device="cpu")
    with profiling.trace(tmp_path / "t", "cpu") as tracer:
        pipe.run()
    assert profiling._current is None
    assert len(tracer.named("frame")) == len(pipe.frame_stats) > 0
    events = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"frame", "frontend", "readback", "run.chunk"} <= names
