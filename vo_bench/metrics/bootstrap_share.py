"""Bootstrap (five-point) frames over tracked frames, from the drives'
``frame_stats`` (``used_pnp``), read after each drive. A count: it repeats
exactly for a seed."""

UNIT, MOVES, SOURCE = "share", "vo_frames_per_sec", "program_counter"


def read(data):
    stats = [s for d in data.drives if d.ok for s in d.frame_stats]
    return sum(not s["used_pnp"] for s in stats) / len(stats) if stats else None
