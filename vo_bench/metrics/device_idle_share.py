"""1 - the union of the device's activity intervals (kernels and copies,
CUPTI through ``torch.profiler``) over the traced window's wall time (the first drive of a traced run, or
its first frame steps where the cell says so)."""

UNIT, MOVES, SOURCE = "share", "vo_frames_per_sec", "device_trace"


def read(data):
    t = data.trace
    return 1.0 - t.busy_s / t.window_s if t is not None and t.window_s > 0 else None
