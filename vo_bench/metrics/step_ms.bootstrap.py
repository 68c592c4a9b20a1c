"""Mean host time of one call of fused.frame_step on a bootstrap frame, in
ms: the harness's span around the call, ended by a device synchronise, over
every such call of the traced window."""

UNIT, MOVES, SOURCE = "ms", "vo_frames_per_sec", "host_clock"


def read(data):
    t = [(s.end_ns - s.start_ns) * 1e-6 for s in data.spans if s.name == "frame_step.bootstrap"]
    return sum(t) / len(t) if t else None
