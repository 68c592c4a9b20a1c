"""Lucas-Kanade level kernel — wrapper of the CUDA kernel in ``csrc/lk.cu``
and its plain versions.

:func:`lk_track_level` is one pyramid level of a tracked frame in one launch.
It replaces both TPU kernels of ``pmv_tpu/frontend/pallas_lk.py``
(``_level_call``: ``_make_template_kernel`` and ``_make_iter_kernel``), the
scalar lines of ``pallas_lk._track_level_cached`` around them and, on a
tracked frame, the TPU capture kernel (``pmv_tpu/frontend/pallas_capture.py``):
the block derives the template window's offset and the ``ok`` flag, computes
the template from the previous frame's cached block, reads its own search
region from the unpadded level, iterates in it and returns it as the next
frame's template block. T, Ix, Iy and the template statistics live in
registers and never reach device memory; the region makes no round trip.

Bound on this card: bytes by the roofline (each level pixel under a region
read once, the (win+3)^2 floats of each cached block that the template's
taps touch, the region written, a few scalars per feature). What really
bounds it is latency: the block's dependent accesses and the chain of
``iters`` iterations. The design starts the patch's and the region's
asynchronous copies back to back and computes the template under the
region's flight; two warps iterate, with one reduction and one barrier
between them per iteration, while the block's other warps write the region
out. One thread block per feature; reductions in a fixed order, so results
repeat run to run but differ from the plain version's summation order (hence
a tolerance for min_eig and positions; the region, its origins and ``ok`` are
exact).

The plain versions of the two stages, :data:`lk_template_plain` and
:func:`lk_iterate_plain`, are each held against its own TPU kernel in the
tests; :func:`lk_track_level_plain` is the scalar lines and the two of them.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch import build
from pmv_tpu_torch.frontend import lucas_kanade as lk
from pmv_tpu_torch.frontend.capture import capture_level_plain

Tensor = torch.Tensor

# Block sizes ``csrc/lk.cu`` instantiates the level kernel for, and the one
# the tracker uses: the fastest of the three at the default loop's shapes on
# an H100 (PERF.md has the times of each). The other two stay built because
# the order is a property of the kernel's registers and shared memory, which
# each change of ``lk.cu`` moves (448 threads lost a wave to 40 registers
# once, 256 needed ``__launch_bounds__`` to keep its loads in flight):
# ``chip_smoke.py`` holds and times all three in every run, so a change that
# reorders them shows in its ``ms_by_threads`` without a trial of its own.
LEVEL_THREADS_BUILT = (128, 256, 448)
LEVEL_THREADS = 256
# The kernel deals the window out in row strips of 7 taps, at most three to
# each of 64 lanes: win * ceil(win / 7) <= 192.
LEVEL_MAX_WIN = 35

# Plain PyTorch versions, used for CPU tensors and as the yardsticks the
# kernel is held against on the card.
lk_template_plain = lk.template_stats


def lk_iterate_plain(level: Tensor, T: Tensor, Ix: Tensor, Iy: Tensor,
                     stats: Tensor, guess_padded: Tensor,
                     win: int, search: int, iters: int):
    """Plain version of the kernel's capture and iteration stages:
    pad-and-gather the region around ``guess_padded`` ((u, v) in the
    coordinates of the level edge-padded by ``lk._pad_for``), then the plain
    iteration loop on it. Returns (refined padded guess, region, r0, c0)."""
    region, r0, c0 = capture_level_plain(level, guess_padded, win, search)
    g = lk._iterate(region, r0, c0, T, Ix, Iy, stats, guess_padded, win, iters)
    return g, region, r0, c0


def ok_limit(Rg: int, win: int) -> float:
    """Upper end of the range a template window's offset may lie in before
    the track is dropped. A float32 tensor compared with this Python float
    is compared with its float32 rounding, which is what the kernel is
    given."""
    return lk.template_limit(Rg, win) + 0.75


def lk_track_level_plain(blk: Tensor, blk_r0: Tensor, blk_c0: Tensor, level: Tensor,
                         pts_level: Tensor, guess: Tensor,
                         win: int, search: int, iters: int):
    """Plain version of :func:`lk_track_level`: the scalar lines, then
    :data:`lk_template_plain` and :func:`lk_iterate_plain`."""
    PAD = lk._pad_for(win, search)
    half = (win - 1) / 2.0
    hi = ok_limit(lk.region_size(win, search), win)
    raw_r = pts_level[:, 1] + PAD - half - 1.0 - blk_r0
    raw_c = pts_level[:, 0] + PAD - half - 1.0 - blk_c0
    # A feature that drifted outside its cached block would silently sample a
    # shifted (wrong) template — flag it instead; the caller drops the track.
    ok = (raw_r > -0.75) & (raw_r < hi) & (raw_c > -0.75) & (raw_c < hi)
    T, Ix, Iy, stats = lk_template_plain(blk, raw_r, raw_c, win)
    g, region, r0, c0 = lk_iterate_plain(
        level, T, Ix, Iy, stats, guess + PAD, win, search, iters)
    return g - PAD, stats[:, 4], ok, region, r0, c0


def lk_track_level(blk: Tensor, blk_r0: Tensor, blk_c0: Tensor, level: Tensor,
                   pts_level: Tensor, guess: Tensor, win: int, search: int, iters: int,
                   *, threads: int = LEVEL_THREADS, return_template: bool = False):
    """One LK level of a tracked frame. ``blk`` (N, Rg, Rg) are the previous
    frame's cached blocks of this level with int32 origins ``blk_r0``,
    ``blk_c0`` (N,) in the coordinates of the level edge-padded by
    ``lk._pad_for(win, search)``; ``level`` is this frame's unpadded (H, W)
    level; ``pts_level`` and ``guess`` (N, 2) as (u, v) are the previous
    positions and the starting guess in level coordinates.

    Returns (g, min_eig, ok, region, r0, c0): the guess after ``iters`` LK
    updates (level coordinates), the template's min-eigenvalue score, whether
    the template window lay inside its cached block (bool), and the (N, Rg,
    Rg) search region around the guess with its int32 origins in padded
    coordinates — the next frame's template block.

    ``threads`` is the kernel's block size, one of LEVEL_THREADS_BUILT;
    callers leave it alone, the block-size trial of ``chip_smoke.py`` sets
    it. ``return_template`` appends (T, Ix, Iy, stats), which the kernel then
    also writes out, for the check of its template stage; CUDA tensors only.
    """
    if level.device.type == "cpu":
        if return_template:
            raise ValueError("lk_track_level: return_template is for CUDA tensors")
        return lk_track_level_plain(blk, blk_r0, blk_c0, level, pts_level, guess,
                                    win, search, iters)
    dev = level.device
    H, W = level.shape
    N = pts_level.shape[0]
    Rg = lk.region_size(win, search)
    if threads not in LEVEL_THREADS_BUILT or win > LEVEL_MAX_WIN:
        raise ValueError(
            f"lk_track_level: no kernel for {threads} threads at window {win} "
            f"(built: {LEVEL_THREADS_BUILT}, windows up to {LEVEL_MAX_WIN})")
    build.check(level, "level", torch.float32, (H, W), dev)
    build.check(blk, "blk", torch.float32, (N, Rg, Rg), dev)
    build.check(blk_r0, "blk_r0", torch.int32, (N,), dev)
    build.check(blk_c0, "blk_c0", torch.int32, (N,), dev)
    build.check(pts_level, "pts_level", torch.float32, (N, 2), dev)
    build.check(guess, "guess", torch.float32, (N, 2), dev)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    g, min_eig, ok = empty((N, 2)), empty((N,)), empty((N,), torch.bool)
    region, r0, c0 = empty((N, Rg, Rg)), empty((N,), torch.int32), empty((N,), torch.int32)
    template = ()
    if return_template:
        template = tuple(empty((N, win, win)) for _ in range(3)) + (empty((N, 5)),)
    build.launch(
        "pmv_lk_track_level", dev,
        blk.data_ptr(), blk_r0.data_ptr(), blk_c0.data_ptr(),
        level.data_ptr(), H, W, lk._pad_for(win, search),
        pts_level.data_ptr(), guess.data_ptr(), N, Rg, win, iters,
        lk.template_limit(Rg, win), ok_limit(Rg, win), lk.iterate_limit(Rg, win), threads,
        g.data_ptr(), min_eig.data_ptr(), ok.data_ptr(),
        region.data_ptr(), r0.data_ptr(), c0.data_ptr(),
        *([t.data_ptr() for t in template] or [None] * 4),
    )
    lk_track_level.launches += 1
    return (g, min_eig, ok, region, r0, c0) + template


lk_track_level.launches = 0
