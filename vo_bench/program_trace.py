"""The program's own spans and counters in a traced run, with the device
trace's kernel launches, blocking runtime calls and idle gaps attributed to
them.

The harness's traced window (:func:`vo_bench.run.traced_window`) times the
stages from outside, each ended by a synchronise. This measurement follows
the check of a traced run and reads the tracer inside the program
(``pmv_tpu_torch.utils.profiling``: ``span``, ``count``, ``tracing``). It
runs in a process of its own (``python3 -m vo_bench.program_trace``), since
a process that has run ``torch.profiler`` launches more slowly after it
(cell 1 on an H100: drives with the tracer on at 7.4 frames/s after the
window's profile, 11.9 in a fresh process). There:

1. the benchmark's warm drive, then drives of the cell with the tracer on
   and nothing else (no synchronise, no profiler) until ``MIN_FRAMES`` frame
   steps have been seen, so that the 95th percentile of the ``frame`` spans
   has ten or more beyond it: cells 1 and 2 take two drives of 118 frames,
   cell 3 one of 598;
2. one more drive with the tracer on under ``torch.profiler`` (CUDA
   activity: CUPTI's kernel, copy and runtime-call records) for as many
   frame steps as the window's device trace held, then cut off. Each
   kernel's host launch time comes from the runtime record of the same
   correlation id; host and trace clocks are tied by bracketing
   ``torch.cuda.synchronize`` calls before and after the profiled stretch
   with ``perf_counter_ns``.

It is taken once per run, by the first reader that asks (:func:`of`), and
kept on the readers' namespace as ``data.program``. It is None where the
harness took no device trace (no card) or where the program has no tracer,
and then every reader of it reads nothing. One table per traced run goes to
standard error: the profiled stretch's idle time, launches and blocking
calls by the innermost program span open at each, and the clock tie.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MIN_FRAMES = 200  # frame spans for the p95: ten or more lie beyond it
MAX_DRIVES = 8
BRACKETS = 8  # synchronise calls that tie the clocks, at each end of the profile
TIMEOUT_S = 1800
OUTSIDE = "(no program span)"
# Runtime and driver calls that block the host until the device is done
# (a device-to-host copy in PyTorch is an async copy and a stream
# synchronise: it counts once, by its synchronise).
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cudaMemcpy2D", "cudaMemcpyFromSymbol", "cudaMemcpyToSymbol", "cudaMemset",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2",
    "cuMemcpyHtoD_v2", "cuMemcpy",
})


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Attributed:
    """The profiled stretch: launches, blocking calls and idle seconds by
    the innermost program span open at each (host side), and the counts
    inside any span of a family."""

    frames: int  # frame steps in the stretch
    window_s: float
    launches: int = 0
    syncs: int = 0
    own_syncs: int = 0  # this measurement's own synchronises, left out
    unlinked: int = 0  # kernels with no runtime record of their correlation id
    by_span: dict = field(default_factory=dict)  # innermost span -> [idle_s, launches, syncs]
    launches_in: dict = field(default_factory=dict)  # "solvers" / "ba" -> launches inside
    offset_ns: list = field(default_factory=list)  # [low, high] at the start, at the end
    readback_gap_us: list = field(default_factory=list)
    readback_copies: list = field(default_factory=list)  # [gap, copy start - call, copy] us


@dataclass
class ProgramTrace:
    frame_ms: list  # every frame span of the unprofiled drives
    wait_ms: float  # summed ingest.wait
    waits: int
    skipped: int
    decode_ms: list
    drives: list  # (frames, wall s) of the unprofiled drives
    min_frames: int = MIN_FRAMES
    device: Attributed | None = None

    @property
    def frame_ms_p95(self):
        if not self.frame_ms or len(self.frame_ms) < self.min_frames:
            return None
        s = sorted(self.frame_ms)
        return s[-(-95 * len(s) // 100) - 1]  # nearest rank

    @property
    def ingest_wait_ms(self):
        handed = self.waits - self.skipped
        return self.wait_ms / handed if handed > 0 else None

    @property
    def decode_mean_ms(self):
        return sum(self.decode_ms) / len(self.decode_ms) if self.decode_ms else None

    def per_frame(self, what: str):
        d = self.device
        if d is None or not d.frames:
            return None
        n = d.syncs if what == "syncs" else d.launches_in.get(what, 0)
        return n / d.frames

    @classmethod
    def from_json(cls, d: dict) -> "ProgramTrace":
        dev = d.pop("device")
        return cls(**d, device=Attributed(**dev) if dev is not None else None)


def of(data):
    """The measurement for the readers' namespace ``data``, taken on the
    first call and kept as ``data.program``."""
    if not hasattr(data, "program"):
        data.program = None
        if getattr(data, "trace", None) is not None and getattr(data, "cfg", None) is not None:
            try:
                data.program = measure(data)
            except Exception:  # a reading that cannot be taken is left out, not the run
                log("vo_bench: the program trace failed:\n" + traceback.format_exc())
    return data.program


def _profiling():
    from pmv_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "tracing") else None


def measure(data, device: str = "cuda:0", min_frames: int = MIN_FRAMES) -> ProgramTrace | None:
    """Run the measurement in a process of its own for the drive
    configuration ``data.cfg`` and ``data.segments``; None for a program
    without the tracer. Its report goes to this process's standard error."""
    if _profiling() is None:
        return None
    trace = getattr(data, "trace", None)
    job = {"cfg": dataclasses.asdict(data.cfg), "segments": int(data.segments), "device": device,
           "min_frames": min_frames, "frames": int(trace.frames) if trace is not None else 0,
           "window_launches": int(trace.launches) if trace is not None else None}
    proc = subprocess.run([sys.executable, "-m", "vo_bench.program_trace"], input=json.dumps(job),
                          capture_output=True, text=True, cwd=ROOT, timeout=TIMEOUT_S,
                          env=dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1"))
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        log(f"vo_bench: the program trace's process exited {proc.returncode}")
        return None
    return ProgramTrace.from_json(json.loads(proc.stdout.strip().splitlines()[-1]))


def collect(cfg, segments: int, device, min_frames: int = MIN_FRAMES) -> ProgramTrace | None:
    """Drives with the tracer on until ``min_frames`` frame spans."""
    from pmv_tpu_torch.utils import profiling
    from vo_bench import run as harness

    frame_ms, decode_ms, drives = [], [], []
    wait_ms, waits, skipped = 0.0, 0, 0
    while len(frame_ms) < min_frames and len(drives) < MAX_DRIVES:
        tracer = profiling.Tracer()
        with profiling.tracing(tracer):
            d = harness.drive(cfg, segments, device)
        if not d.ok:
            return None
        drives.append((d.frames, d.wall_s))
        frame_ms += [s.ms for s in tracer.named("frame")]
        decode_ms += [s.ms for s in tracer.named("ingest.decode")]
        w = tracer.named("ingest.wait")
        wait_ms += sum(s.ms for s in w)
        waits += len(w)
        skipped += tracer.counters.get("ingest.skipped", 0)
    return ProgramTrace(frame_ms, wait_ms, waits, skipped, decode_ms, drives, min_frames)


class _Enough(Exception):
    """Ends the profiled drive once its frame steps are traced."""


def _brackets(device, n: int) -> list:
    import torch

    out = []
    for _ in range(n):
        h0 = time.perf_counter_ns()
        torch.cuda.synchronize(device)
        out.append((h0, time.perf_counter_ns()))
    return out


def profiled(cfg, segments: int, device, want: int) -> Attributed:
    """One drive under the profiler and the tracer, cut after ``want`` frame
    steps (or at its end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pmv_tpu_torch.utils import profiling
    from vo_bench import record
    from vo_bench import run as harness

    tracer = profiling.Tracer()
    state = {"n": 0, "h_stop": None, "t1": None}
    prof = profile(activities=[ProfilerActivity.CUDA])
    pre, post = [], []

    def stop():
        state["h_stop"] = time.perf_counter_ns()
        post.extend(_brackets(device, BRACKETS))
        state["t1"] = time.perf_counter_ns()
        prof.stop()

    def frame(orig):
        def wrapped(*a, **k):
            out = orig(*a, **k)
            state["n"] += 1
            if state["n"] >= want:
                stop()
                raise _Enough
            return out
        return wrapped

    pipe = harness.make_pipeline(cfg, segments, device)
    torch.cuda.synchronize(device)
    prof.start()
    try:
        pre.extend(_brackets(device, BRACKETS))
        t0 = time.perf_counter_ns()
        with record.patched({"frame": frame}), profiling.tracing(tracer):
            pipe.run()
        stop()  # a drive shorter than the window's stretch
    except _Enough:
        pass
    finally:
        if state["t1"] is None:
            prof.stop()
    del pipe
    events = prof.profiler.kineto_results.events()
    return attribute(events, tracer, threading.get_ident(), pre, post, t0, state["h_stop"],
                     state["t1"], state["n"])


def _tie(records: list, brackets: list):
    """(low, high) bounds of trace time minus ``perf_counter_ns`` from the
    synchronise records that fell in the host brackets: of the ways to line
    the brackets up with consecutive records (the profiler may add a
    synchronise of its own), the narrowest that holds; None if none does."""
    best = None
    for k in range(len(records) - len(brackets) + 1):
        lo, hi = -(1 << 62), 1 << 62
        for (h0, h1), (s, e) in zip(brackets, records[k:]):
            lo, hi = max(lo, e - h1), min(hi, s - h0)
        if lo <= hi and (best is None or hi - lo < best[1] - best[0]):
            best = [lo, hi]
    return best


class _Stacks:
    """The program spans of one thread as change points: the path of span
    names open from each point on."""

    def __init__(self, spans: list):
        ev = []
        for i, s in enumerate(spans):
            ev.append((s.start_ns, 1, i))
            ev.append((s.end_ns, 0, i))
        ev.sort()
        self.times, self.paths, open_ = [-(1 << 62)], [()], []
        for t, kind, i in ev:
            if kind:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            path = tuple(spans[j].name for j in open_)
            if self.times[-1] == t:
                self.paths[-1] = path
            else:
                self.times.append(t)
                self.paths.append(path)

    def at(self, t: int) -> tuple:
        return self.paths[bisect.bisect_right(self.times, t) - 1]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def attribute(events, tracer, main_thread: int, pre, post, t0: int, h_stop: int, t1: int,
              frames: int) -> Attributed:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_ev, api = [], {}
    syncs_host = []
    first = last = None  # the first and the last launch or copy call
    for e in events:
        if e.device_type() == cuda:
            dev_ev.append(e)
        else:
            name = e.name()
            s = e.start_ns()
            api[e.correlation_id()] = s
            if name in SYNC_CALLS:
                syncs_host.append((s, e.end_ns(), name))
            elif "LaunchKernel" in name or "Memcpy" in name or "Memset" in name:
                first = s if first is None else min(first, s)
                last = s if last is None else max(last, s)
    syncs_host.sort()
    dsync = [(s, e) for s, e, n in syncs_host if n == "cudaDeviceSynchronize"]
    # The brackets are the device synchronises before the drive's first
    # launch and after its last.
    tie0 = _tie([r for r in dsync if first is None or r[0] < first], pre)
    tie1 = _tie([r for r in dsync if last is None or r[0] > last], post)
    if tie0 is None and tie1 is None:
        raise RuntimeError(f"no clock tie from {len(dsync)} synchronise records")
    mid0 = (tie0[0] + tie0[1]) // 2 if tie0 else (tie1[0] + tie1[1]) // 2
    mid1 = (tie1[0] + tie1[1]) // 2 if tie1 else mid0

    def host(t_trace: int) -> int:  # trace time -> perf_counter_ns, drift taken as linear
        f = (t_trace - mid0 - t0) / max(1, t1 - t0)
        return t_trace - int(mid0 + (mid1 - mid0) * min(1.0, max(0.0, f)))

    main = _Stacks(sorted((s for s in tracer.spans if s.thread == main_thread), key=lambda s: s.start_ns))
    out = Attributed(frames=frames, window_s=(t1 - t0) * 1e-9, offset_ns=[tie0, tie1])
    by = defaultdict(lambda: [0.0, 0, 0])
    inside = defaultdict(int)
    intervals = []
    for e in dev_ev:
        s, d = e.start_ns(), e.duration_ns()
        name = e.name()
        h_dev = host(s)
        if h_dev + d < t0 or h_dev > t1:
            continue
        intervals.append((max(h_dev, t0), min(h_dev + d, t1)))
        if _is_copy(name):
            continue
        h = api.get(e.correlation_id())
        if h is None:
            out.unlinked += 1
            h = h_dev
        else:
            h = host(h)
        if not t0 <= h <= t1:
            continue
        out.launches += 1
        path = main.at(h)
        by[path[-1] if path else OUTSIDE][1] += 1
        if any(p.startswith("solvers.") for p in path):
            inside["solvers"] += 1
        if "ba" in path:
            inside["ba"] += 1
    for s, e, name in syncs_host:
        h = host(s)
        if h < t0 or h > t1:
            continue
        if h >= h_stop:
            out.own_syncs += 1
            continue
        out.syncs += 1
        path = main.at(h)
        by[path[-1] if path else OUTSIDE][2] += 1
    intervals.sort()
    cur = t0
    for s, e in intervals:
        if s > cur:
            path = main.at((cur + s) // 2)
            by[path[-1] if path else OUTSIDE][0] += (s - cur) * 1e-9
        cur = max(cur, e)
    if t1 > cur:
        path = main.at((cur + t1) // 2)
        by[path[-1] if path else OUTSIDE][0] += (t1 - cur) * 1e-9
    out.by_span = dict(by)
    out.launches_in = dict(inside)
    # The clock tie: each readback span waits for the device-to-host copy
    # it launched; the gap is from the copy's end to the span's end.
    d2h = []
    for e in dev_ev:
        if "DtoH" in e.name():
            h = api.get(e.correlation_id())
            if h is not None:
                d2h.append((host(h), host(e.start_ns()), host(e.start_ns() + e.duration_ns())))
    d2h.sort()
    starts = [c[0] for c in d2h]
    for sp in tracer.named("readback"):
        if sp.thread != main_thread or not t0 <= sp.start_ns <= h_stop:
            continue
        i = bisect.bisect_right(starts, sp.end_ns) - 1
        if i >= 0 and starts[i] >= sp.start_ns:
            call, c0, c1 = d2h[i]
            out.readback_gap_us.append((sp.end_ns - c1) * 1e-3)
            out.readback_copies.append([(sp.end_ns - c1) * 1e-3, (c0 - call) * 1e-3, (c1 - c0) * 1e-3])
    return out


def report(pt: ProgramTrace, window_launches, drives_s: float, profile_s: float) -> None:
    n = len(pt.frame_ms)
    p95 = pt.frame_ms_p95
    beyond = sum(v > p95 for v in pt.frame_ms) if p95 is not None else 0
    fps = sum(f for f, _ in pt.drives) / max(1e-9, sum(w for _, w in pt.drives))
    log(f"vo_bench: program trace: {len(pt.drives)} drive(s) with the tracer on, {fps:.4f} frames/s, "
        f"{drives_s:.1f} s; {n} frame spans, median {statistics.median(pt.frame_ms) if n else None} ms, "
        f"p95 {p95} ms ({beyond} beyond); ingest.wait {pt.ingest_wait_ms} ms a frame over "
        f"{pt.waits - pt.skipped} frames, ingest.decode {pt.decode_mean_ms} ms over "
        f"{len(pt.decode_ms)}, skipped {pt.skipped}")
    d = pt.device
    if d is None:
        log(f"vo_bench: program trace: no profiled stretch ({profile_s:.1f} s)")
        return
    log(f"vo_bench: program trace: profiled {d.frames} frame steps in {d.window_s:.3f} s "
        f"({profile_s:.1f} s with the profile's processing); clock offset bounds (ns) at the "
        f"start {d.offset_ns[0]}, at the end {d.offset_ns[1]}")
    known = sum(v[1] for k, v in d.by_span.items() if k != OUTSIDE)
    ksyncs = sum(v[2] for k, v in d.by_span.items() if k != OUTSIDE)
    log(f"vo_bench: program trace: launches {d.launches} (the window's device trace: "
        f"{window_launches}), {d.unlinked} without a runtime record; inside a program span {known} "
        f"({known / max(1, d.launches):.4f}); solvers {d.launches_in.get('solvers', 0)}, "
        f"ba {d.launches_in.get('ba', 0)}; blocking calls {d.syncs} (inside a span {ksyncs}, "
        f"{ksyncs / max(1, d.syncs):.4f}), the measurement's own {d.own_syncs}")
    gaps = sorted(d.readback_gap_us)
    if len(gaps) > 1:
        log(f"vo_bench: program trace: readback end after its copy's end: median "
            f"{statistics.median(gaps):.3f} us, quartiles "
            f"{[round(q, 3) for q in statistics.quantiles(gaps, n=4)]} us, max {gaps[-1]:.3f} us, "
            f"min {gaps[0]:.3f} us, {len(gaps)} spans")
        ext = sorted(d.readback_copies)
        log(f"vo_bench: program trace: readbacks at the ends, [gap, copy start after its call, "
            f"copy] us: {[[round(v, 3) for v in c] for c in ext[:3] + ext[-3:]]}")
    log("vo_bench: program trace by innermost span: span | idle s | launches | blocking calls")
    for k, (idle, la, sy) in sorted(d.by_span.items(), key=lambda kv: -kv[1][0]):
        log(f"  {k} | {idle:.6f} | {la} | {sy}")


def main() -> int:
    """The measurement's own process: a job on standard input (JSON: the
    drive configuration, segments, device, frame steps to profile), the
    result as the last line of standard output."""
    job = json.loads(sys.stdin.read())
    import torch

    from pmv_tpu_torch.config import VOConfig
    from vo_bench import run as harness

    cfg = VOConfig(**job["cfg"])
    segments, device = job["segments"], torch.device(job["device"])
    torch.set_num_threads(1)
    warm = dataclasses.replace(cfg, frames=harness.warm_frames(cfg, segments))
    if not harness.drive(warm, segments, device).ok:
        raise RuntimeError("the warm drive failed")
    t0 = time.perf_counter()
    pt = collect(cfg, segments, device, job["min_frames"])
    if pt is None:
        raise RuntimeError("a drive with the tracer on failed")
    t1 = time.perf_counter()
    if device.type == "cuda" and job["frames"] > 0:
        pt.device = profiled(cfg, segments, device, job["frames"])
    report(pt, job["window_launches"], t1 - t0, time.perf_counter() - t1)
    print(json.dumps(dataclasses.asdict(pt)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
