"""95th percentile of one frame step's host time, in ms: the program's
``frame`` spans (``pipeline/fused.py`` ``chunk_step``: the frame step, the
BA that follows it when due and the map snapshot row), over the drives that
the program trace (:mod:`vo_bench.program_trace`) runs with the tracer on
and nothing else, at least 200 frame steps (nearest rank). The latency one
frame takes as a camera at 10 Hz feels it."""

from vo_bench import program_trace

UNIT, MOVES, SOURCE = "ms", "vo_frames_per_sec", "program_span"


def read(data):
    p = program_trace.of(data)
    return None if p is None else p.frame_ms_p95
