"""``lk_level_kernel`` (``csrc/lk.cu``, one launch per pyramid level of a
tracked frame) against its byte bound, in %: the bound of every launch of
the profiled drive over the kernel's device time there (CUPTI).

The bound counts each input byte read once and each output byte written
once, over 3.35 TB/s (NVIDIA's H100 SXM data sheet), as the port's
``chip_smoke.py`` counts it: read the level's pixels under the regions
(at most the level), the (win+3)^2 patch of each cached block and 6 values
per feature; write each (Rg, Rg) region, its origin, position, min_eig
(5 values) and the ``ok`` byte. Launches are taken to spread evenly over
the levels, as every tracked frame launches each level once."""

UNIT, MOVES, SOURCE = "%", "vo_frames_per_sec", "device_trace"
PEAK_BYTES_PER_S = 3.35e12
KERNEL = "lk_level_kernel"


def level_bytes(H: int, W: int, N: int, win: int, search: int) -> int:
    Rg = win + 3 * search + 4
    return (min(H * W, N * Rg * Rg) + N * ((win + 3) ** 2 + 6)) * 4 + N * (Rg * Rg + 5) * 4 + N


def read(data):
    t = data.trace
    if t is None:
        return None
    hits = [v for k, v in t.kernels.items() if KERNEL in k]
    n, secs = sum(c for c, _ in hits), sum(s for _, s in hits)
    if n == 0 or secs <= 0:
        return None
    cfg = data.cfg
    search = cfg.lk_search if cfg.lk_search > 0 else max(4, cfg.lk_window // 2)
    H, W = data.shape
    sizes = [(H, W)]
    for _ in range(cfg.lk_levels):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    per = [level_bytes(h, w, cfg.feature_capacity, cfg.lk_window, search) for h, w in sizes]
    bound_s = n * (sum(per) / len(per)) / PEAK_BYTES_PER_S
    return 100.0 * bound_s / secs
