"""Fixed-budget batched RANSAC utilities — PyTorch counterpart of
``pmv_tpu/solvers/ransac.py``.

The reference relies on OpenCV's sequential RANSAC loops
(``cv::findEssentialMat`` with prob .99 / 1 px, OpenCVFivePointTri.cpp:24;
``cv::solvePnPRansac`` with 100 iterations / 8 px, OpenCVEPnPSolver.cpp:35-36).
Here data-dependent iteration counts are replaced by a fixed batch of
hypotheses solved simultaneously: sample H minimal sets, solve all H models
batched, score all H x N residuals as one tensor op, and argmax the masked
inlier count.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def sample_minimal_sets(
    gen: torch.Generator, valid: Tensor, n_hypos: int, set_size: int
) -> Tensor:
    """Draw ``n_hypos`` random subsets of ``set_size`` indices from the valid
    slots; returns (n_hypos, set_size) int64.

    Gumbel-top-k trick: per hypothesis, add Gumbel noise to ``log(valid)``
    and take the top ``set_size`` — a uniform random ``set_size``-subset of
    valid indices. If fewer than ``set_size`` valid slots exist, invalid
    slots leak in; callers guard via the model's own scoring. ``gen`` must
    live on ``valid``'s device.
    """
    n = valid.shape[0]
    u = torch.rand((n_hypos, n), generator=gen, device=valid.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    e = -torch.log(u.clamp(min=tiny))  # Exp(1) draws, >= 0
    g = -torch.log(e.clamp(min=tiny))  # Gumbel(0, 1) draws
    logits = torch.where(valid[None, :], g, -torch.inf)
    return torch.topk(logits, set_size, dim=1).indices


def best_hypothesis(inlier_masks: Tensor) -> tuple[Tensor, Tensor]:
    """Pick the hypothesis with the most inliers (the first among equals).
    inlier_masks: (H, N) bool. Returns (best_index, best_mask (N,))."""
    counts = torch.sum(inlier_masks, dim=1)
    best = torch.argmax(counts)
    return best, inlier_masks[best]
