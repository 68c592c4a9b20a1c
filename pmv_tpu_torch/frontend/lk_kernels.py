"""Lucas-Kanade level kernels — wrappers of the CUDA kernels in
``csrc/lk.cu`` and their plain versions.

Replace the two TPU kernels of ``pmv_tpu/frontend/pallas_lk.py``
(``_level_call``): ``_make_template_kernel`` -> :func:`lk_template`,
``_make_iter_kernel`` -> :func:`lk_iterate`. On a tracked frame
:func:`lk_iterate` also does what the TPU capture kernel
(``pmv_tpu/frontend/pallas_capture.py``) does there: it reads its own search
region from the unpadded level and returns it as the next frame's template
block, so a level costs two launches and the region makes no round trip
through device memory.

Bound on this card: bytes for both by the roofline. ``lk_template`` reads
only the (win+3)^2 floats of each cached block that its bilinear taps touch
(it does not stage the block) and writes T/Ix/Iy. ``lk_iterate`` reads the
level's pixels under the regions and T/Ix/Iy once and writes the region, its
origin and two floats per feature; its ``iters`` iterations run out of
shared memory and registers, and what really bounds it is the latency of
that dependent chain (two warps iterate, with one reduction and one barrier
between them per iteration, while the block's other warps write the region
out). One thread block per feature; reductions in a fixed order, so results
repeat run to run but differ from the plain version's summation order (hence
a tolerance for positions; the region and origins are exact).
"""

from __future__ import annotations

import torch

from pmv_tpu_torch import build
from pmv_tpu_torch.frontend import lucas_kanade as lk
from pmv_tpu_torch.frontend.capture import capture_level_plain

Tensor = torch.Tensor

# Block sizes ``csrc/lk.cu`` instantiates lk_iterate for, and the one the
# tracker uses: the fastest of the three at the default loop's shapes on an
# H100 (PERF.md has the times of each).
ITERATE_THREADS_BUILT = (128, 256, 448)
ITERATE_THREADS = 256
# The kernel deals the window out in row strips of 7 taps, at most three to
# each of 64 lanes: win * ceil(win / 7) <= 192.
ITERATE_MAX_WIN = 35

# Plain PyTorch versions, used for CPU tensors and as the yardsticks the
# kernels are held against on the card.
lk_template_plain = lk.template_stats


def lk_iterate_plain(level: Tensor, T: Tensor, Ix: Tensor, Iy: Tensor,
                     stats: Tensor, guess_padded: Tensor,
                     win: int, search: int, iters: int):
    """Plain version of :func:`lk_iterate`: pad-and-gather the region, then
    the plain iteration loop on it."""
    region, r0, c0 = capture_level_plain(level, guess_padded, win, search)
    g = lk._iterate(region, r0, c0, T, Ix, Iy, stats, guess_padded, win, iters)
    return g, region, r0, c0


def lk_template(blk: Tensor, raw_r: Tensor, raw_c: Tensor, win: int):
    """Template statistics of one level: blk (N, Rg, Rg) cached blocks,
    raw_r/raw_c (N,) float offsets of the (win+2)^2 window inside the block
    (clipped inside). Returns (T, Ix, Iy (N, win, win), stats (N, 5) =
    [Gxx, Gxy, Gyy, inv_det, min_eig])."""
    if blk.device.type == "cpu":
        return lk_template_plain(blk, raw_r, raw_c, win)
    dev = blk.device
    N, Rg, _ = blk.shape
    if Rg < win + 3:
        raise ValueError(f"lk_template: block {Rg} too small for window {win}")
    build.check(blk, "blk", torch.float32, (N, Rg, Rg), dev)
    build.check(raw_r, "raw_r", torch.float32, (N,), dev)
    build.check(raw_c, "raw_c", torch.float32, (N,), dev)
    T = torch.empty((N, win, win), dtype=torch.float32, device=dev)
    Ix = torch.empty_like(T)
    Iy = torch.empty_like(T)
    stats = torch.empty((N, 5), dtype=torch.float32, device=dev)
    build.launch(
        "pmv_lk_template", dev,
        blk.data_ptr(), raw_r.data_ptr(), raw_c.data_ptr(), N, Rg, win,
        lk.template_limit(Rg, win),
        T.data_ptr(), Ix.data_ptr(), Iy.data_ptr(), stats.data_ptr(),
    )
    lk_template.launches += 1
    return T, Ix, Iy, stats


def lk_iterate(level: Tensor, T: Tensor, Ix: Tensor, Iy: Tensor, stats: Tensor,
               guess_padded: Tensor, win: int, search: int, iters: int,
               *, threads: int = ITERATE_THREADS):
    """Capture each feature's (Rg, Rg) search region of the unpadded (H, W)
    ``level`` around ``guess_padded`` ((N, 2) as (u, v), in the coordinates
    of the level edge-padded by ``lk._pad_for(win, search)``) and run
    ``iters`` LK updates of the guess inside it. Returns (refined guess
    (N, 2), region (N, Rg, Rg), reg_r0, reg_c0 (N,) int32 origins in padded
    coordinates); the region is the next frame's template block.

    ``threads`` is the kernel's block size, one of ITERATE_THREADS_BUILT;
    callers leave it alone, the block-size trial of ``chip_smoke.py`` sets it.
    """
    if level.device.type == "cpu":
        return lk_iterate_plain(level, T, Ix, Iy, stats, guess_padded, win, search, iters)
    dev = level.device
    H, W = level.shape
    N = guess_padded.shape[0]
    Rg = lk.region_size(win, search)
    if threads not in ITERATE_THREADS_BUILT or win > ITERATE_MAX_WIN:
        raise ValueError(
            f"lk_iterate: no kernel for {threads} threads at window {win} "
            f"(built: {ITERATE_THREADS_BUILT}, windows up to {ITERATE_MAX_WIN})")
    build.check(level, "level", torch.float32, (H, W), dev)
    for name, t in (("T", T), ("Ix", Ix), ("Iy", Iy)):
        build.check(t, name, torch.float32, (N, win, win), dev)
    build.check(stats, "stats", torch.float32, (N, 5), dev)
    build.check(guess_padded, "guess_padded", torch.float32, (N, 2), dev)
    out = torch.empty((N, 2), dtype=torch.float32, device=dev)
    region = torch.empty((N, Rg, Rg), dtype=torch.float32, device=dev)
    r0 = torch.empty((N,), dtype=torch.int32, device=dev)
    c0 = torch.empty((N,), dtype=torch.int32, device=dev)
    build.launch(
        "pmv_lk_iterate", dev,
        level.data_ptr(), H, W, lk._pad_for(win, search),
        T.data_ptr(), Ix.data_ptr(), Iy.data_ptr(), stats.data_ptr(),
        guess_padded.data_ptr(), N, Rg, win, iters, lk.iterate_limit(Rg, win),
        threads, out.data_ptr(), region.data_ptr(), r0.data_ptr(), c0.data_ptr(),
    )
    lk_iterate.launches += 1
    return out, region, r0, c0


lk_template.launches = 0
lk_iterate.launches = 0
