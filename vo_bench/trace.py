"""The device trace of one drive: ``torch.profiler`` with CUDA activity
(CUPTI), read as kernel intervals. Gives the union of device activity
(``busy_s``), the kernels by name, and the device's idle gaps, each named
by the harness's host span that was open at the gap's middle."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    frames: int  # frame steps inside the traced window
    kernels: dict = field(default_factory=dict)  # name -> [launches, seconds]
    copies: dict = field(default_factory=dict)  # memcpy / memset name -> [count, seconds]
    idle_by_span: dict = field(default_factory=dict)  # host span -> idle seconds

    @property
    def launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def profiled(fn, device, spans, frames: int = 0):
    """Run ``fn()`` with the profiler on; returns (its result, DeviceTrace).
    ``spans`` is the :class:`vo_bench.record.Spans` the wrapped stages
    append to while ``fn`` runs (host clock, ``perf_counter_ns``). With
    ``frames`` > 0 the profiler stops after that many frame steps of the
    drive, which then runs on untraced: the traced window is the drive's
    start up to there."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    state = {"t1": None}

    def stop(n_frames: int) -> None:
        if state["t1"] is None and frames and n_frames >= frames:
            torch.cuda.synchronize(device)
            state["t1"], state["frames"] = time.perf_counter_ns(), n_frames
            prof.stop()

    spans.after_frame = stop
    prof.start()
    try:
        torch.cuda.synchronize(device)
        h_mark = time.perf_counter_ns()
        torch.zeros(1, device=device)  # the marker kernel that ties the clocks
        torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        out = fn()
        if state["t1"] is None:
            torch.cuda.synchronize(device)
            state["t1"] = time.perf_counter_ns()
            state["frames"] = sum(s.name.startswith("frame_step") for s in spans.spans)
            prof.stop()
    finally:
        spans.after_frame = None
        if state["t1"] is None:
            prof.stop()
    t1 = state["t1"]
    ev = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: e.start_ns())
    # The first device event is the marker, launched just after h_mark: the
    # offset maps host times onto the trace's clock (to a few microseconds).
    off = ev[0].start_ns() - h_mark if ev else 0
    w0, w1 = t0 + off, t1 + off
    kernels: dict = defaultdict(lambda: [0, 0.0])
    copies: dict = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in ev:
        s, d = e.start_ns(), e.duration_ns()
        if s + d <= w0 or s >= w1:
            continue
        name = e.name()
        agg = copies if _is_copy(name) else kernels
        agg[name][0] += 1
        agg[name][1] += d * 1e-9
        intervals.append((max(s, w0), min(s + d, w1)))
    busy, gaps, cur_s, cur_e = 0, [], None, w0
    for s, e in intervals:  # sorted by start
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, w1))
    host = sorted((sp.start_ns + off, sp.end_ns + off, sp.name) for sp in spans.spans)
    starts = [h[0] for h in host]
    idle: dict = defaultdict(float)
    for gs, ge in gaps:
        if ge <= gs:
            continue
        mid = (gs + ge) // 2
        i = bisect.bisect_right(starts, mid) - 1  # the steps' spans do not overlap
        inside = i >= 0 and mid < host[i][1]
        idle[host[i][2] if inside else "run, outside frame_step and ba_step"] += (ge - gs) * 1e-9
    return out, DeviceTrace(window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9, frames=state["frames"],
                            kernels=dict(kernels), copies=dict(copies), idle_by_span=dict(idle))
