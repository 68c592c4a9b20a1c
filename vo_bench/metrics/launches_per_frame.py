"""CUDA kernel launches in the traced window over the frame steps in it (the
per-frame step's, the BA's and the entry's launches, per tracked frame):
the dispatch count that bounds the host-bound loop."""

UNIT, MOVES, SOURCE = "launches/frame", "vo_frames_per_sec", "device_trace"


def read(data):
    t = data.trace
    return t.launches / t.frames if t is not None and t.frames else None
