"""Batched pyramidal Lucas-Kanade sparse optical flow with cached templates
— PyTorch counterpart of ``pmv_tpu/frontend/lucas_kanade.py`` (itself a
rewrite of ``cv::calcOpticalFlowPyrLK(prev, next, pts, ..., Size(32, 32),
4)``, OpenCVLucasKanadeFM.cpp:15).

Per pyramid level and feature, a square *search region* block of the new
frame is captured once around the current guess; all LK iterations sample
inside it, and it doubles as the next frame's template source. Blocks are
feature-major ``(N, Rg, Rg)``.

A tracked frame costs two kernel launches per level: ``lk_template`` on the
cached block, then ``lk_iterate``, which captures the region itself, iterates
in it and returns it. The capture kernel ``capture_level`` runs only from
:func:`capture_blocks`, at init and after a reseed. All three read the
unpadded level at clamped coordinates; positions and origins stay in the
coordinates of the level edge-padded by :func:`_pad_for`, but no padded copy
is made on the card (the TPU package's ``jnp.pad`` per level and frame is
gone).

This module holds the pieces of the plain PyTorch versions of the three CUDA
kernels and the level/pyramid logic around them:

- :func:`_capture_region`   — gather of ``capture.capture_level_plain`` (on a
  padded level)
- :func:`template_stats`    — plain version of ``lk_kernels.lk_template``
- :func:`_iterate`          — the loop of ``lk_kernels.lk_iterate_plain``

:func:`_track_level_cached` and :func:`capture_blocks` call the wrappers in
``capture`` / ``lk_kernels``, which launch the kernels for CUDA tensors and
fall through to the plain versions for CPU tensors. (Those modules import
this one for the plain versions, hence the function-level imports below.)

Bilinear sampling is by direct indexing in the order the kernels use — row
blend, then column blend, each ``(1-f)*a + f*b``.

Convention: feature positions are (u=column, v=row) float32 pixels.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pad_for(win: int, search: int) -> int:
    """Edge padding (replication) under which every block slice fits; the
    offset between level coordinates and the padded coordinates that
    positions and block origins are kept in."""
    return win + 2 * search + 4


def region_size(win: int, search: int) -> int:
    """Side length of the per-feature search-region block,
    ``win + 3*search + 4``: the (win, win) sample window, +-search of
    iteration freedom, plus an extra 1.5*search margin + bilinear/gradient
    taps — sized so the block doubles as the NEXT frame's template source."""
    return win + 3 * search + 4


def _resolve_search(win: int, search: int | None) -> int:
    return max(4, win // 2) if search is None else search


def _sample_window(region: Tensor, lr: Tensor, lc: Tensor, win: int) -> Tensor:
    """Bilinear (N, win, win) windows from (N, Rg, Rg) regions at per-feature
    float top-left (lr, lc), pre-clipped so that all taps lie inside."""
    N, _, Rg = region.shape
    i0 = torch.floor(lr)
    fr = (lr - i0)[:, None, None]
    j0 = torch.floor(lc)
    fc = (lc - j0)[:, None, None]
    ar = torch.arange(win + 1, device=region.device)
    rows = i0.long()[:, None] + ar  # (N, win+1)
    raw = torch.gather(region, 1, rows[:, :, None].expand(N, win + 1, Rg))
    strip = (1.0 - fr) * raw[:, :-1] + fr * raw[:, 1:]  # (N, win, Rg)
    cols = j0.long()[:, None] + ar
    rawc = torch.gather(strip, 2, cols[:, None, :].expand(N, win, win + 1))
    return (1.0 - fc) * rawc[:, :, :-1] + fc * rawc[:, :, 1:]


def _template_stats(F: Tensor, win: int):
    """Template T, gradients and normal-matrix terms from a sampled
    (N, win+2, win+2) window F."""
    T = F[:, 1:-1, 1:-1]
    Ix = (F[:, 1:-1, 2:] - F[:, 1:-1, :-2]) * 0.5
    Iy = (F[:, 2:, 1:-1] - F[:, :-2, 1:-1]) * 0.5
    Gxx = torch.sum(Ix * Ix, dim=(1, 2))
    Gxy = torch.sum(Ix * Iy, dim=(1, 2))
    Gyy = torch.sum(Iy * Iy, dim=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    mean = (Gxx + Gyy) * 0.5
    rad = torch.sqrt(torch.clamp(((Gxx - Gyy) * 0.5) ** 2 + Gxy * Gxy, min=0.0))
    min_eig = (mean - rad) / (win * win)
    one = torch.ones_like(det)
    inv_det = torch.where(
        det > 1e-6, 1.0 / torch.where(det == 0, one, det), torch.zeros_like(det)
    )
    return T, Ix, Iy, Gxx, Gxy, Gyy, inv_det, min_eig


def template_limit(Rg: int, win: int) -> float:
    """Upper clip of the template window's offset inside its block."""
    return Rg - (win + 2) - 1e-5


def iterate_limit(Rg: int, win: int) -> float:
    """Upper clip of the sample window's offset inside its region."""
    return Rg - win - 1.000001


def template_stats(blk: Tensor, raw_r: Tensor, raw_c: Tensor, win: int):
    """Plain version of the ``lk_template`` kernel: sample the (win+2)^2
    window at the clipped offsets and derive the template statistics.
    Returns (T, Ix, Iy (N, win, win), stats (N, 5) = [Gxx, Gxy, Gyy,
    inv_det, min_eig])."""
    lim = template_limit(blk.shape[-1], win)
    F = _sample_window(
        blk, torch.clamp(raw_r, 0.0, lim), torch.clamp(raw_c, 0.0, lim), win + 2
    )
    T, Ix, Iy, Gxx, Gxy, Gyy, inv_det, min_eig = _template_stats(F, win)
    return T, Ix, Iy, torch.stack([Gxx, Gxy, Gyy, inv_det, min_eig], dim=-1)


def block_origins(shape, center: Tensor, win: int, search: int):
    """Integer top-left corners (r0, c0), int32, of the (Rg, Rg) blocks
    around float ``center`` positions in a padded image of ``shape``, clipped
    so that every block lies inside it."""
    H, W = shape
    Rg = region_size(win, search)
    half = (win - 1) / 2.0
    m = (Rg - win) // 2  # center the block on the capture position
    r0 = torch.clamp(
        torch.floor(center[:, 1] - half).to(torch.int32) - m, 0, max(H - Rg, 0)
    )
    c0 = torch.clamp(
        torch.floor(center[:, 0] - half).to(torch.int32) - m, 0, max(W - Rg, 0)
    )
    return r0, c0


def _capture_region(img_padded: Tensor, center: Tensor, win: int, search: int):
    """The gather of the ``capture_level`` kernel's plain version: slice the
    per-feature (Rg, Rg) search-region block around ``center`` (float
    positions in padded-image coords) out of the edge-padded level. Returns
    (region (N, Rg, Rg), r0, c0)."""
    Rg = region_size(win, search)
    r0, c0 = block_origins(img_padded.shape, center, win, search)
    ar = torch.arange(Rg, device=img_padded.device)
    rows = (r0.long()[:, None] + ar)[:, :, None]
    cols = (c0.long()[:, None] + ar)[:, None, :]
    return img_padded[rows, cols], r0, c0


def _iterate(region, reg_r0, reg_c0, T, Ix, Iy, stats, guess_padded,
             win: int, iters: int):
    """The loop of the ``lk_iterate`` kernel's plain version: the LK
    iterations on a captured region block; positions (u, v) in padded-image
    coords."""
    Rg = region.shape[-1]
    Gxx, Gxy, Gyy, inv_det = stats[:, 0], stats[:, 1], stats[:, 2], stats[:, 3]
    half = (win - 1) / 2.0
    lim = iterate_limit(Rg, win)
    r0 = reg_r0.to(guess_padded.dtype)
    c0 = reg_c0.to(guess_padded.dtype)
    g = guess_padded
    for _ in range(iters):
        lr = torch.clamp(g[:, 1] - half - r0, 0.0, lim)
        lc = torch.clamp(g[:, 0] - half - c0, 0.0, lim)
        I = _sample_window(region, lr, lc, win)
        r = T - I
        bx = torch.sum(r * Ix, dim=(1, 2))
        by = torch.sum(r * Iy, dim=(1, 2))
        du = (Gyy * bx - Gxy * by) * inv_det
        dv = (Gxx * by - Gxy * bx) * inv_det
        g = g + torch.stack([du, dv], dim=-1)
    return g


def _track_level_cached(
    blk: Tensor,       # (N, Rg, Rg) block of the PREV frame's level image
    blk_r0: Tensor,    # (N,) block origins in padded coords
    blk_c0: Tensor,
    next_img: Tensor,  # this frame's level image (unpadded)
    pts_level: Tensor,
    guess: Tensor,
    win: int,
    iters: int,
    search: int,
):
    """One LK level sampling the template from a cached region block.
    Returns (new guess, min_eig, ok, (region, r0, c0)) — the region block
    doubles as the next frame's template source."""
    from pmv_tpu_torch.frontend import lk_kernels

    PAD = _pad_for(win, search)
    Rg = region_size(win, search)
    half = (win - 1) / 2.0

    lim = template_limit(Rg, win)
    raw_r = pts_level[:, 1] + PAD - half - 1.0 - blk_r0
    raw_c = pts_level[:, 0] + PAD - half - 1.0 - blk_c0
    # A feature that drifted outside its cached block would silently sample a
    # shifted (wrong) template — flag it instead; the caller drops the track.
    ok = (raw_r > -0.75) & (raw_r < lim + 0.75) & (raw_c > -0.75) & (raw_c < lim + 0.75)
    guess_p = guess + PAD
    T, Ix, Iy, stats = lk_kernels.lk_template(blk, raw_r, raw_c, win)
    g, region, reg_r0, reg_c0 = lk_kernels.lk_iterate(
        next_img, T, Ix, Iy, stats, guess_p, win, search, iters
    )
    return g - PAD, stats[:, 4], ok, (region, reg_r0, reg_c0)


def capture_blocks(pyr, pts: Tensor, win: int = 32, search: int | None = None) -> tuple:
    """Per-level search-region blocks around ``pts`` — the template source
    for the NEXT ``track_cached`` call (used at init and after reseeding,
    when cached blocks don't cover the new feature positions)."""
    from pmv_tpu_torch.frontend import capture

    search = _resolve_search(win, search)
    PAD = _pad_for(win, search)
    out = []
    for lvl, img in enumerate(pyr):
        s = 2.0 ** lvl
        out.append(capture.capture_level(img, pts / s + PAD, win, search))
    return tuple(out)


def track_cached(
    blocks: tuple,
    next_pyr,
    pts: Tensor,
    valid: Tensor,
    win: int = 32,
    iters: int = 10,
    min_eig_threshold: float = 1e-4,
    search: int | None = None,
) -> tuple[Tensor, Tensor, tuple]:
    """Track (N, 2) points into ``next_pyr`` with the per-level templates
    taken from ``blocks`` (the region blocks returned by the previous call /
    capture_blocks); each level's iteration kernel captures the one new
    block the frame needs.

    Returns (new_pts, status, new_blocks). Status clears when the point
    leaves the image, drifts outside its cached block, or the normal matrix
    is degenerate (untextured window) — the mask-based equivalent of
    OpenCV's status output consumed at OpenCVLucasKanadeFM.cpp:21-30.
    """
    levels = len(next_pyr)
    H, W = next_pyr[0].shape
    search = _resolve_search(win, search)
    scale_top = 2.0 ** (levels - 1)
    guess = pts / scale_top
    min_eig0 = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    new_blocks = []
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        blk, br0, bc0 = blocks[lvl]
        guess, min_eig0, ok, captured = _track_level_cached(
            blk, br0, bc0, next_pyr[lvl], pts / s, guess, win, iters, search,
        )
        ok_all = ok_all & ok
        new_blocks.append(captured)
        if lvl > 0:
            guess = guess * 2.0
    new_pts = guess
    inside = (
        (new_pts[:, 0] >= 0)
        & (new_pts[:, 0] <= W - 1)
        & (new_pts[:, 1] >= 0)
        & (new_pts[:, 1] <= H - 1)
    )
    status = valid & inside & ok_all & (min_eig0 > min_eig_threshold)
    return new_pts, status, tuple(reversed(new_blocks))
