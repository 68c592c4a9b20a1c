"""Share of a drive's wall time outside the program's own run timer: 1 - sum
of ``pipe.runtime`` (``utils.profiling.Stopwatch``, which synchronises the
card) over the sum of the drives' wall time, over the traced window's
drives. What it holds: construction, ``initialise``, the init state and the
read-backs after the timer stops."""

UNIT, MOVES, SOURCE = "share", "vo_frames_per_sec", "program_span"


def read(data):
    ok = [d for d in data.drives if d.ok]
    wall = sum(d.wall_s for d in ok)
    return 1.0 - sum(d.runtime_s for d in ok) / wall if wall > 0 else None
