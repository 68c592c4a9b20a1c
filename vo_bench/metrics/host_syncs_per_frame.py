"""Blocking runtime calls per frame step: CUPTI's records of
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and the synchronous copies (a device-to-host copy
counts once, by its synchronise) in the program trace's profiled stretch
(:mod:`vo_bench.program_trace`), less the measurement's own, over its frame
steps. Each is a point where the host waits for the device."""

from vo_bench import program_trace

UNIT, MOVES, SOURCE = "syncs/frame", "vo_frames_per_sec", "device_trace"


def read(data):
    p = program_trace.of(data)
    return None if p is None else p.per_frame("syncs")
