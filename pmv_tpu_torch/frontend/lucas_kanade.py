"""Batched pyramidal Lucas-Kanade sparse optical flow with cached templates
— PyTorch counterpart of ``pmv_tpu/frontend/lucas_kanade.py`` (itself a
rewrite of ``cv::calcOpticalFlowPyrLK(prev, next, pts, ..., Size(32, 32),
4)``, OpenCVLucasKanadeFM.cpp:15).

Per pyramid level and feature, a square *search region* block of the new
frame is captured once around the current guess; all LK iterations sample
inside it, and it doubles as the next frame's template source. Blocks are
feature-major ``(N, Rg, Rg)``.

A tracked frame costs one kernel launch per level: ``lk_track_level``
derives the template window's offset, computes the template from the cached
block, captures the new region itself, iterates in it and returns it. The
capture kernel ``capture_level`` runs only from :func:`capture_blocks`, at
init and after a reseed. Both read the unpadded level at clamped
coordinates; origins stay in the coordinates of the level edge-padded by
:func:`_pad_for`, but no padded copy is made on the card (the TPU package's
``jnp.pad`` per level and frame is gone).

This module holds the pieces of the plain PyTorch versions of the two CUDA
kernels and the pyramid logic around them:

- :func:`_capture_region`   — gather of ``capture.capture_level_plain`` (on a
  padded level)
- :func:`template_stats`    — plain version of the level kernel's template
  stage (``lk_kernels.lk_template_plain``)
- :func:`_iterate`          — the loop of ``lk_kernels.lk_iterate_plain``, the
  plain version of its iteration stage

The uncached tracker :func:`track` (the modular loop's, ``run_modular``) is
plain PyTorch on every device, as it is jnp in the JAX package: per level it
edge-pads both images, samples a fresh template window from the previous one
(clipped to the padded image) and iterates in a region of the new one. It
launches no kernel.

:func:`_track_level_cached` and :func:`capture_blocks` call the wrappers in
``lk_kernels`` / ``capture``, which launch the kernels for CUDA tensors and
fall through to the plain versions for CPU tensors. (Those modules import
this one for the plain versions, hence the function-level imports below.)

Bilinear sampling is by direct indexing in the order the kernels use — row
blend, then column blend, each ``(1-f)*a + f*b``.

Convention: feature positions are (u=column, v=row) float32 pixels.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch.frontend.image import _pad_edge

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


def bilinear_sample(img: Tensor, y: Tensor, x: Tensor) -> Tensor:
    """Pointwise bilinear sampling of ``img`` (H, W) at rows ``y`` and
    columns ``x`` (any equal shapes), clipped into the image (a utility:
    the tracker samples blocks)."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.000001)
    y = torch.clamp(y, 0.0, H - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    dx = x - x0
    dy = y - y0
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    return (
        img[y0, x0] * (1 - dy) * (1 - dx)
        + img[y0, x1] * (1 - dy) * dx
        + img[y1, x0] * dy * (1 - dx)
        + img[y1, x1] * dy * dx
    )


def _slice_blocks(img: Tensor, r0: Tensor, c0: Tensor, size: int) -> Tensor:
    """(N,) integer top-left corners -> (N, size, size) blocks of ``img``;
    starts are clamped so that the block stays in bounds (as
    ``lax.dynamic_slice`` clamps them in the JAX package)."""
    H, W = img.shape
    r0 = torch.clamp(r0.long(), 0, H - size)
    c0 = torch.clamp(c0.long(), 0, W - size)
    ar = torch.arange(size, device=img.device)
    return img[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]]


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
    """Plain version of the level kernel's template stage: sample the (win+2)^2
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
    return _slice_blocks(img_padded, r0, c0, Rg), r0, c0


def _iterate(region, reg_r0, reg_c0, T, Ix, Iy, stats, guess_padded,
             win: int, iters: int):
    """The loop of the level kernel's iteration stage, plain version: the LK
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

    g, min_eig, ok, region, reg_r0, reg_c0 = lk_kernels.lk_track_level(
        blk, blk_r0, blk_c0, next_img, pts_level, guess, win, search, iters
    )
    return g, min_eig, ok, (region, reg_r0, reg_c0)


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
    capture_blocks); each level's kernel captures the one new block the
    frame needs.

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


def _track_level(
    prev_img: Tensor,
    next_img: Tensor,
    pts_level: Tensor,
    guess: Tensor,
    win: int,
    iters: int,
    search: int,
) -> tuple[Tensor, Tensor]:
    """One pyramid level of LK with a fresh template. Returns (new guess
    (N, 2), min_eig (N,))."""
    # Pad all sides so every slice window fits regardless of feature
    # position (border behaviour = edge replication); pixel coordinates
    # shift by PAD.
    PAD = _pad_for(win, search)
    prev_img = _pad_edge(prev_img, PAD)
    next_img = _pad_edge(next_img, PAD)
    H, W = prev_img.shape
    half = (win - 1) / 2.0

    # --- template: fractional (win+2, win+2) window around pts, then T and
    # central-difference gradients ---
    TS = win + 4  # template block: win+2 sampled window + 2-tap margin
    tl_r = pts_level[:, 1] + PAD - half - 1.0
    tl_c = pts_level[:, 0] + PAD - half - 1.0
    tr0 = torch.clamp(torch.floor(tl_r), 0, H - TS)
    tc0 = torch.clamp(torch.floor(tl_c), 0, W - TS)
    base = _slice_blocks(prev_img, tr0.long(), tc0.long(), TS)
    F = _sample_window(
        base,
        torch.clamp(tl_r - tr0, 0.0, 1.0),
        torch.clamp(tl_c - tc0, 0.0, 1.0),
        win + 2,
    )  # (N, win+2, win+2)
    T, Ix, Iy, Gxx, Gxy, Gyy, inv_det, min_eig = _template_stats(F, win)

    # --- search region in the next image, loaded once per level ---
    region, reg_r0, reg_c0 = _capture_region(next_img, guess + PAD, win, search)
    stats = torch.stack([Gxx, Gxy, Gyy, inv_det, min_eig], dim=-1)
    g = _iterate(region, reg_r0, reg_c0, T, Ix, Iy, stats, guess + PAD, win, iters)
    return g - PAD, min_eig


def track(
    prev_pyr,
    next_pyr,
    pts: Tensor,
    valid: Tensor,
    win: int = 32,
    iters: int = 10,
    min_eig_threshold: float = 1e-4,
    search: int | None = None,
) -> tuple[Tensor, Tensor]:
    """Track (N, 2) points from prev to next through the pyramids, with a
    fresh template per level.

    Returns (new_pts (N, 2), status (N,) bool). Status clears when the point
    leaves the image or the normal matrix is degenerate (untextured window).
    """
    levels = len(prev_pyr)
    H, W = prev_pyr[0].shape
    search = _resolve_search(win, search)
    guess = pts / 2.0 ** (levels - 1)
    min_eig0 = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    for lvl in range(levels - 1, -1, -1):
        s = 2.0 ** lvl
        guess, min_eig0 = _track_level(
            prev_pyr[lvl], next_pyr[lvl], pts / s, guess, win, iters, search
        )
        if lvl > 0:
            guess = guess * 2.0
    new_pts = guess
    inside = (
        (new_pts[:, 0] >= 0)
        & (new_pts[:, 0] <= W - 1)
        & (new_pts[:, 1] >= 0)
        & (new_pts[:, 1] <= H - 1)
    )
    status = valid & inside & (min_eig0 > min_eig_threshold)
    return new_pts, status
