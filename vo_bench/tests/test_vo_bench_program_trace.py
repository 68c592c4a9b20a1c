"""The program trace (``vo_bench/program_trace.py``) and its six readers: the
span readers on a 96x160 CPU measurement, the device readers without a card
and without a program tracer, and the attribution of launches, blocking
calls and idle gaps to program spans on a made-up CUPTI timeline."""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest
import torch

from vo_bench import cells, program_trace, run
from vo_bench.tests.conftest import write_bench

# One math-library thread, as a benchmark run has (vo_bench/__main__.py).
torch.set_num_threads(1)

SPAN_READERS = ("frame_ms.p95", "ingest_wait_ms", "decode_ms")
DEVICE_READERS = ("host_syncs_per_frame", "launches_per_frame.solvers", "launches_per_frame.ba")


def _read(name, data):
    return cells.metric_reader(name).read(data)


def _tiny(tmp_path, frames: int = 16):
    bench, here = write_bench(tmp_path, frames=frames)
    cell = cells.find("tiny.corridor16", bench, here)
    from vo_bench import data as data_mod

    paths, frames_arr = data_mod.materialize(cell.traffic, 3000000005, tmp_path / "data")
    cfg = run.vo_config(cell, paths, int(cell.traffic["frames"]), 3000000005)
    return cfg, frames_arr


def test_a_traced_cpu_measurement_gives_the_span_metrics(tmp_path):
    cfg, frames_arr = _tiny(tmp_path)
    ns = SimpleNamespace(drives=[], spans=[], trace=None, cfg=cfg, shape=frames_arr.shape[1:], segments=1)
    ns.program = program_trace.measure(ns, device="cpu", min_frames=20)
    p = ns.program
    assert len(p.drives) == 2 and len(p.frame_ms) >= 20
    got = {k: _read(k, ns) for k in SPAN_READERS + DEVICE_READERS}
    assert all(got[k] is not None and got[k] > 0 for k in SPAN_READERS), got
    assert got["frame_ms.p95"] >= sorted(p.frame_ms)[len(p.frame_ms) // 2]
    assert all(got[k] is None for k in DEVICE_READERS)  # no card: no device trace
    assert p.skipped == 0 and p.waits == len(p.decode_ms) >= 2 * 16  # a wait for each decoded frame


def test_too_few_frames_give_no_percentile():
    p = program_trace.ProgramTrace(frame_ms=[1.0] * 199, wait_ms=1.0, waits=4, skipped=1,
                                   decode_ms=[2.0], drives=[(1, 1.0)])
    assert p.frame_ms_p95 is None and p.ingest_wait_ms == pytest.approx(1 / 3)
    q = program_trace.ProgramTrace(frame_ms=[float(i) for i in range(1, 201)], wait_ms=0.0, waits=0,
                                   skipped=0, decode_ms=[], drives=[])
    assert q.frame_ms_p95 == 190.0 and sum(v > q.frame_ms_p95 for v in q.frame_ms) == 10
    assert q.ingest_wait_ms is None and q.decode_mean_ms is None


def test_readers_read_nothing_without_a_device_trace_or_a_tracer(tmp_path, monkeypatch):
    cfg, frames_arr = _tiny(tmp_path)
    plain = SimpleNamespace(drives=[], spans=[], trace=None, cfg=cfg, shape=frames_arr.shape[1:], segments=1)
    assert all(_read(k, plain) is None for k in SPAN_READERS + DEVICE_READERS)
    assert plain.program is None
    # a program without the tracer (the parent of the change that added it)
    from pmv_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "tracing")
    traced = SimpleNamespace(drives=[], spans=[], trace=SimpleNamespace(frames=4, launches=1), cfg=cfg,
                             shape=frames_arr.shape[1:], segments=1)
    t0 = time.perf_counter()
    assert all(_read(k, traced) is None for k in SPAN_READERS + DEVICE_READERS)
    assert time.perf_counter() - t0 < 5  # no drive was run


# --------------------------------------------------------------------------
# attribution on a made-up timeline
# --------------------------------------------------------------------------

OFF = 5_000_000  # trace time = perf_counter_ns + OFF


class Ev:
    def __init__(self, name, start, dur, corr, cuda):
        self._n, self._s, self._d, self._c, self._cuda = name, start, dur, corr, cuda

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def end_ns(self):
        return self._s + self._d

    def correlation_id(self):
        return self._c


def _span(name, start, end, parent=None):
    from pmv_tpu_torch.utils.profiling import Span

    s = Span(name)
    s.parent, s.thread, s.start_ns, s.end_ns = parent, threading.get_ident(), start, end
    return s


def test_attribution_on_a_made_up_timeline():
    corr = iter(range(1, 1000))
    ev = []

    def api(name, h, dur=200):  # a runtime call at host time h
        c = next(corr)
        ev.append(Ev(name, h + OFF, dur, c, False))
        return c

    def launch(h, d_start, d_dur=100, copy=None):
        c = api("cudaLaunchKernel" if copy is None else "cudaMemcpyAsync", h)
        ev.append(Ev(copy or "kernel_x", d_start + OFF, d_dur, c, True))

    pre = [(100, 1100), (1200, 2200)]
    post = [(60_000, 61_000), (61_100, 62_100)]
    for h0, h1 in pre + post:
        api("cudaDeviceSynchronize", h0 + 300, 400)
    t0, h_stop, t1 = 3000, 59_000, 62_500
    frame = _span("frame", 10_000, 50_000)
    spans = [frame, _span("solvers.pnp", 11_000, 20_000, frame), _span("ba", 30_000, 45_000, frame),
             _span("readback", 21_000, 22_000, frame), _span("run.chunk", 9_000, 51_000)]
    frame.parent = spans[-1]
    ba_solve = _span("ba.solve", 31_000, 44_000, spans[2])
    spans.append(ba_solve)
    for h in (12_000, 13_000, 14_000):
        launch(h, h + 50)  # three in solvers.pnp
    for h in (32_000, 33_000):
        launch(h, h + 50)  # two in ba.solve (inside ba)
    launch(46_000, 46_050)  # one in frame
    launch(55_000, 55_050)  # one outside every span
    launch(21_100, 21_200, 300, copy="Memcpy DtoH (Device -> Pageable)")  # ends at 21_500
    api("cudaStreamSynchronize", 21_150, 400)  # the readback's wait
    api("cudaStreamSynchronize", 34_000)  # a wait inside ba.solve
    ev.append(Ev("kernel_orphan", 40_000 + OFF, 100, 999_999, True))  # no runtime record: device time
    t = SimpleNamespace(spans=spans, named=lambda n: [s for s in spans if s.name == n])
    a = program_trace.attribute(ev, t, threading.get_ident(), pre, post, t0, h_stop, t1, frames=2)
    assert a.launches == 8 and a.unlinked == 1
    assert a.launches_in == {"solvers": 3, "ba": 3}
    assert a.syncs == 2 and a.own_syncs == 2  # the post brackets are after h_stop
    by = a.by_span
    assert by["solvers.pnp"][1] == 3 and by["ba.solve"][1] == 3 and by["frame"][1] == 1
    assert by[program_trace.OUTSIDE][1] == 1
    assert by["readback"][2] == 1 and by["ba.solve"][2] == 1
    # offset bounds hold OFF, and every idle second lies in the window
    (lo0, hi0), (lo1, hi1) = a.offset_ns
    assert lo0 <= OFF <= hi0 and lo1 <= OFF <= hi1
    busy = 7 * 100 + 300 + 100
    assert sum(v[0] for v in by.values()) == pytest.approx((t1 - t0 - busy) * 1e-9, abs=2e-9)
    # the readback ends 500 ns after its copy's end, on the host's clock
    assert a.readback_gap_us == [pytest.approx(0.5, abs=0.1)]
    p = program_trace.ProgramTrace([], 0.0, 0, 0, [], [], device=a)
    assert p.per_frame("solvers") == 1.5 and p.per_frame("ba") == 1.5 and p.per_frame("syncs") == 1.0
