"""Patch-SSD k-nearest-neighbour feature matcher (the LK alternative) —
PyTorch counterpart of ``pmv_tpu/frontend/knn_matcher.py``.

Rewrite of kNNFeatureMatcher.cpp:3-122: extract ~1000 fresh corners in the
next frame; for each previous feature take its k=7 spatial nearest
neighbours (Chebyshev distance, matching ``Feature::distance``), pick the
best by SSD patch error, accept if the error is below the threshold (2.0),
and reject matches whose displacement exceeds 3x the mean displacement. The
reference's O(n^2) neighbour scans become one batched distance matrix +
top-k; the SSD comparisons one gather + reduction.

Ties: Chebyshev distances between integer corners tie all the time, and so
do SSD errors on flat patches. Both selections take the lowest index among
equals, as ``lax.top_k`` and ``jnp.argmin`` do in the JAX package: the
neighbours by a stable sort, the best of them by the least index that holds
the minimum.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch.core.state import FeatureTable
from pmv_tpu_torch.frontend.corners import top_k_stable
from pmv_tpu_torch.frontend.image import _pad_edge
from pmv_tpu_torch.frontend.lucas_kanade import _slice_blocks

Tensor = torch.Tensor


def _frac_shift(base: Tensor, dr: Tensor, dc: Tensor) -> Tensor:
    """Subpixel window from an integer base block: (N, S, S) + per-feature
    fractional offsets (dr, dc) in [0, 1) -> (N, S-1, S-1) bilinear windows,
    as a weighted sum of the 4 integer-shifted dense sub-blocks."""
    w00 = ((1 - dr) * (1 - dc))[:, None, None]
    w01 = ((1 - dr) * dc)[:, None, None]
    w10 = (dr * (1 - dc))[:, None, None]
    w11 = (dr * dc)[:, None, None]
    return (
        w00 * base[:, :-1, :-1]
        + w01 * base[:, :-1, 1:]
        + w10 * base[:, 1:, :-1]
        + w11 * base[:, 1:, 1:]
    )


def _patches(img: Tensor, xy: Tensor, window: int) -> Tensor:
    """(N, 2) centers -> (N, window, window) patches (border-replicated;
    the reference instead skips out-of-bounds pixels in the SSD sum)."""
    half = window // 2
    PAD = half + 2
    img_p = _pad_edge(img, PAD)
    H, W = img_p.shape
    # Clamp like a pointwise bilinear sampler: sample coords clip to the
    # unpadded frame (the bound is a float32 value, as in the JAX package).
    x = torch.clamp(xy[:, 0] + PAD, PAD, W - PAD - 1.000001)
    y = torch.clamp(xy[:, 1] + PAD, PAD, H - PAD - 1.000001)
    r0 = torch.floor(y).to(torch.int64) - half
    c0 = torch.floor(x).to(torch.int64) - half
    base = _slice_blocks(img_p, r0, c0, window + 1)  # (N, w+1, w+1)
    return _frac_shift(base, y - torch.floor(y), x - torch.floor(x))


def knn_match(
    prev_img: Tensor,
    next_img: Tensor,
    prev_table: FeatureTable,
    cand_xy: Tensor,
    cand_valid: Tensor,
    k: int = 7,
    window: int = 15,
    threshold: float = 2.0,
) -> FeatureTable:
    """Match ``prev_table`` features into candidate corners of the next
    frame. Returns the next frame's slot-aligned FeatureTable (valid =
    matched, landmark inherited)."""
    N = prev_table.capacity
    # Chebyshev spatial distance matrix (N, C) — Feature.cpp:9-15 max-norm.
    d = torch.amax(torch.abs(prev_table.xy[:, None, :] - cand_xy[None, :, :]), dim=-1)
    d = torch.where(cand_valid[None, :], d, torch.inf)
    k = min(k, cand_xy.shape[0])
    _, nn = top_k_stable(-d, k)  # (N, k) nearest candidate indices

    # compareFeatures loops x,y in [-ceil(w/2), +ceil(w/2)] — a
    # (2*ceil(w/2)+1)-sided patch (17x17 for window=15) — while normalizing
    # by window^2 (kNNFeatureMatcher.cpp:103-121). Keep both quirks.
    psize = 2 * -(-window // 2) + 1
    P_prev = _patches(prev_img, prev_table.xy, psize)  # (N, p, p)
    nn_xy = cand_xy[nn.reshape(-1)]  # (N*k, 2)
    P_next = _patches(next_img, nn_xy, psize).reshape(N, k, psize, psize)
    # Reference error: sqrt(SSD) / window^2 (kNNFeatureMatcher.cpp:120).
    ssd = torch.sum((P_next - P_prev[:, None]) ** 2, dim=(2, 3))
    err = torch.sqrt(ssd) / (window * window)
    slot = torch.arange(k, device=err.device).expand(N, k)
    best = torch.where(err == err.amin(dim=1, keepdim=True), slot, k).amin(dim=1)  # first of equals
    best_err = torch.gather(err, 1, best[:, None])[:, 0]
    best_idx = torch.gather(nn, 1, best[:, None])[:, 0]
    best_xy = cand_xy[best_idx]

    # An under-populated candidate set lets top-k admit invalid slots (inf
    # spatial distance but real garbage xy); never accept those.
    matched = prev_table.valid & cand_valid[best_idx] & (best_err < threshold)
    disp = torch.amax(torch.abs(best_xy - prev_table.xy), dim=-1)  # Chebyshev
    # The reference averages matched displacements over ALL previous
    # features, not just matched ones (kNNFeatureMatcher.cpp:42).
    mean_disp = torch.sum(torch.where(matched, disp, 0.0)) / torch.clamp(
        torch.sum(prev_table.valid), min=1
    )
    matched = matched & (disp <= 3.0 * mean_disp)

    return FeatureTable(
        xy=best_xy,
        valid=matched,
        landmark=torch.where(matched, prev_table.landmark, -1).to(torch.int32),
        score=torch.where(matched, prev_table.score, 0.0),
    )
