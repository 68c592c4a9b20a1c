"""FAST-9/16 corner detector, vectorised — PyTorch counterpart of
``pmv_tpu/frontend/fast.py``.

Replacement for the ``cv::FAST`` wrapper (OpenCVFASTFeatureExtractor.cpp:
4-22: threshold 10, non-max suppression on, keeps the first ``max``
keypoints in scan order — unsorted, reproduced here). A pixel is a corner
when >= 9 contiguous pixels on the 16-pixel Bresenham circle are all
brighter than center + t or all darker than center - t. The score is the
FAST "V" measure: the largest threshold for which the pixel remains a corner
(arc-min of absolute differences), followed by 3x3 non-max suppression.

The circle is read by ``torch.roll``, which wraps around the image as
``jnp.roll`` does; the 3-px border kill hides the wrap.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# Bresenham circle of radius 3, OpenCV pixel order, (row, col) offsets.
_CIRCLE = [
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
]


def _arc_min(x: Tensor) -> Tensor:
    """Min over 9 consecutive circle pixels for every start position, then
    the best start: (16, H, W) -> (H, W)."""
    m = x
    for k in range(1, 9):
        m = torch.minimum(m, torch.roll(x, -k, dims=0))
    return torch.amax(m, dim=0)


def fast_response(img: Tensor, threshold: float = 10.0) -> Tensor:
    """FAST-9 corner score map (0 where not a corner)."""
    shifted = torch.stack(
        [torch.roll(img, (-dr, -dc), dims=(0, 1)) for dr, dc in _CIRCLE]
    )  # (16, H, W): shifted[i] at center == img at circle pixel i
    d = shifted - img[None]
    score = torch.maximum(_arc_min(d), _arc_min(-d))
    score = torch.where(score > threshold, score, 0.0)
    # kill the border (the circle wraps around through the roll)
    H, W = img.shape
    inside = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    inside[3 : H - 3, 3 : W - 3] = True
    return torch.where(inside, score, 0.0)


def fast_extract(
    img: Tensor, max_feats: int, threshold: float = 10.0, nonmax: bool = True
) -> tuple[Tensor, Tensor, Tensor]:
    """Extract up to ``max_feats`` FAST corners in scan (row-major) order —
    the reference keeps the *first* max keypoints, not the strongest
    (OpenCVFASTFeatureExtractor.cpp:11-15). Returns (xy (C, 2), score (C,),
    valid (C,))."""
    score = fast_response(img, threshold)
    if nonmax:
        wmax = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
        score = torch.where(score >= wmax, score, 0.0)
    H, W = img.shape
    flat = score.reshape(-1)
    # first-k in scan order: order by (not corner, index); a stable sort
    # keeps equal keys (the non-corners) in index order, as jnp.argsort does
    idx = torch.arange(H * W, device=img.device)
    idx_rank = torch.where(flat > 0, idx, H * W)
    order = torch.argsort(idx_rank, stable=True)[:max_feats]
    sel_score = flat[order]
    valid = sel_score > 0
    xy = torch.stack([(order % W).to(torch.float32), (order // W).to(torch.float32)], -1)
    return xy, sel_score, valid
