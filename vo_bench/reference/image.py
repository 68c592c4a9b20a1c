"""Pyramid, pyramidal Lucas-Kanade and the min-eigenvalue corner response,
as the port's configuration states them (window, search region, iterations,
central-difference gradients, 5-tap binomial blur, 2x2 average, bilinear
sampling), computed from the raw frames."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vo_bench.reference.prec import Prec


def pad_edge(x, pad: int):
    lead = x.shape[:-2]
    y = F.pad(x.reshape((1, -1) + x.shape[-2:]), (pad, pad, pad, pad), mode="replicate")
    return y.reshape(lead + y.shape[-2:])


def gaussian_blur5(img):
    k = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
    H, W = img.shape[-2], img.shape[-1]
    p = pad_edge(img, 2)
    h = sum(k[i] * p[..., :, i: i + W] for i in range(5))
    return sum(k[i] * h[..., i: i + H, :] for i in range(5))


def downsample2(img):
    H, W = img.shape[-2], img.shape[-1]
    x = img[..., : H // 2 * 2, : W // 2 * 2]
    return x.reshape(*x.shape[:-2], H // 2, 2, W // 2, 2).mean(dim=(-3, -1))


def build_pyramid(img, levels: int, P: Prec) -> list:
    pyr = [P.q(img)]
    for _ in range(levels):
        pyr.append(P.q(downsample2(gaussian_blur5(pyr[-1]))))
    return pyr


def min_eig_response(img, P: Prec):
    """Shi-Tomasi: the least eigenvalue of the 3x3-box-blurred structure
    tensor of central-difference gradients (zero at the border)."""
    img = P.q(img)
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[1:-1, 1:-1] = (img[1:-1, 2:] - img[1:-1, :-2]) * 0.5
    gy[1:-1, 1:-1] = (img[2:, 1:-1] - img[:-2, 1:-1]) * 0.5

    def blur(x):
        p = pad_edge(x, 1)
        h = (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3.0
        return P.q((h[:-2] + h[1:-1] + h[2:]) / 3.0)

    xx, yy, xy = blur(gx * gx), blur(gy * gy), blur(gx * gy)
    d = (xx - yy) * 0.5
    return P.q((xx + yy) * 0.5 - torch.sqrt(d * d + xy * xy))


def _slice_blocks(img, r0, c0, size: int):
    H, W = img.shape
    r0 = torch.clamp(r0.long(), 0, H - size)
    c0 = torch.clamp(c0.long(), 0, W - size)
    ar = torch.arange(size, device=img.device)
    return img[(r0[:, None] + ar)[:, :, None], (c0[:, None] + ar)[:, None, :]]


def _sample_window(region, lr, lc, win: int):
    """Bilinear (N, win, win) windows at float top-left (lr, lc): rows
    blended first, then columns."""
    N, _, Rg = region.shape
    i0 = torch.floor(lr)
    fr = (lr - i0)[:, None, None]
    j0 = torch.floor(lc)
    fc = (lc - j0)[:, None, None]
    ar = torch.arange(win + 1, device=region.device)
    raw = torch.gather(region, 1, (i0.long()[:, None] + ar)[:, :, None].expand(N, win + 1, Rg))
    strip = (1.0 - fr) * raw[:, :-1] + fr * raw[:, 1:]
    rawc = torch.gather(strip, 2, (j0.long()[:, None] + ar)[:, None, :].expand(N, win, win + 1))
    return (1.0 - fc) * rawc[:, :, :-1] + fc * rawc[:, :, 1:]


def _track_level(prev_img, next_img, pts, guess, win: int, iters: int, search: int, P: Prec):
    """One level: template around ``pts`` in the previous image, LK
    iterations from ``guess`` inside a (Rg, Rg) region of the next one
    (both images edge-replicated). Returns (guess, min_eig)."""
    PAD = win + 2 * search + 4
    Rg = win + 3 * search + 4
    prev_img = pad_edge(prev_img, PAD)
    next_img = pad_edge(next_img, PAD)
    H, W = prev_img.shape
    half = (win - 1) / 2.0
    TS = win + 4
    tl_r = pts[:, 1] + PAD - half - 1.0
    tl_c = pts[:, 0] + PAD - half - 1.0
    tr0 = torch.clamp(torch.floor(tl_r), 0, H - TS)
    tc0 = torch.clamp(torch.floor(tl_c), 0, W - TS)
    Fw = P.q(_sample_window(_slice_blocks(prev_img, tr0, tc0, TS),
                            torch.clamp(tl_r - tr0, 0.0, 1.0), torch.clamp(tl_c - tc0, 0.0, 1.0),
                            win + 2))
    T = Fw[:, 1:-1, 1:-1]
    Ix = (Fw[:, 1:-1, 2:] - Fw[:, 1:-1, :-2]) * 0.5
    Iy = (Fw[:, 2:, 1:-1] - Fw[:, :-2, 1:-1]) * 0.5
    Gxx = P.q(torch.sum(Ix * Ix, dim=(1, 2)))
    Gxy = P.q(torch.sum(Ix * Iy, dim=(1, 2)))
    Gyy = P.q(torch.sum(Iy * Iy, dim=(1, 2)))
    det = Gxx * Gyy - Gxy * Gxy
    rad = torch.sqrt(torch.clamp(((Gxx - Gyy) * 0.5) ** 2 + Gxy * Gxy, min=0.0))
    min_eig = ((Gxx + Gyy) * 0.5 - rad) / (win * win)
    inv_det = torch.where(det > 1e-6, 1.0 / torch.where(det == 0, torch.ones_like(det), det),
                          torch.zeros_like(det))
    # the search region around the guess, in padded coordinates
    m = (Rg - win) // 2
    center = guess + PAD
    r0 = torch.clamp(torch.floor(center[:, 1] - half).long() - m, 0, max(H - Rg, 0))
    c0 = torch.clamp(torch.floor(center[:, 0] - half).long() - m, 0, max(W - Rg, 0))
    region = _slice_blocks(next_img, r0, c0, Rg)
    lim = Rg - win - 1.000001
    g = center
    for _ in range(iters):
        lr = torch.clamp(g[:, 1] - half - r0.to(g.dtype), 0.0, lim)
        lc = torch.clamp(g[:, 0] - half - c0.to(g.dtype), 0.0, lim)
        r = T - _sample_window(region, lr, lc, win)
        bx = torch.sum(r * Ix, dim=(1, 2))
        by = torch.sum(r * Iy, dim=(1, 2))
        du = (Gyy * bx - Gxy * by) * inv_det
        dv = (Gxx * by - Gxy * bx) * inv_det
        g = P.q(g + torch.stack([du, dv], dim=-1))
    return g - PAD, min_eig


def track(prev_pyr, next_pyr, pts, valid, win: int, iters: int, search: int, P: Prec,
          min_eig_threshold: float = 1e-4):
    """Pyramidal LK of (N, 2) (u, v) positions from the previous pyramid to
    the next; returns (positions, status)."""
    levels = len(prev_pyr)
    H, W = prev_pyr[0].shape
    pts = P.q(pts)
    guess = pts / 2.0 ** (levels - 1)
    min_eig = torch.zeros_like(pts[:, 0])
    for lvl in range(levels - 1, -1, -1):
        guess, min_eig = _track_level(prev_pyr[lvl], next_pyr[lvl], pts / 2.0 ** lvl, guess,
                                      win, iters, search, P)
        if lvl > 0:
            guess = guess * 2.0
    inside = (guess[:, 0] >= 0) & (guess[:, 0] <= W - 1) & (guess[:, 1] >= 0) & (guess[:, 1] <= H - 1)
    return P.q(guess), valid & inside & (min_eig > min_eig_threshold)
