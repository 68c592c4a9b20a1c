"""Mean time to decode one frame, in ms: the program's ``ingest.decode``
spans (``io/prefetch.py``, on the producer thread: the native or the Python
PNG decoder) in the program trace's drives (:mod:`vo_bench.program_trace`)."""

from vo_bench import program_trace

UNIT, MOVES, SOURCE = "ms", "vo_frames_per_sec", "program_span"


def read(data):
    p = program_trace.of(data)
    return None if p is None else p.decode_mean_ms
