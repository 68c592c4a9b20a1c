"""Kernel launches per frame step whose runtime call falls inside the
program's ``ba`` span (``pipeline/fused.py``: ``ba_step``, the sliding-window
Schur LM): CUPTI's kernels in the program trace's profiled stretch
(:mod:`vo_bench.program_trace`), each placed by the host time of its launch,
over the stretch's frame steps."""

from vo_bench import program_trace

UNIT, MOVES, SOURCE = "launches/frame", "vo_frames_per_sec", "device_trace"


def read(data):
    p = program_trace.of(data)
    return None if p is None else p.per_frame("ba")
