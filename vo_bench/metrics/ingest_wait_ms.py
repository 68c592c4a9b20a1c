"""Mean time the loop waits for the frame prefetcher, in ms per frame handed
out: the program's ``ingest.wait`` spans (``io/prefetch.py``, the
consumer's ``queue.get``) over the frames the prefetchers handed out, in the
program trace's drives (:mod:`vo_bench.program_trace`). Near 0 while decode
keeps ahead of the device loop."""

from vo_bench import program_trace

UNIT, MOVES, SOURCE = "ms", "vo_frames_per_sec", "program_span"


def read(data):
    p = program_trace.of(data)
    return None if p is None else p.ingest_wait_ms
