"""Grid-tiled corner extraction with fixed output shapes — PyTorch
counterpart of ``pmv_tpu/frontend/corners.py``.

Replacement for the reference's per-tile extractor calls: ``getGridROI``
splits the frame into 255x255 tiles (OdometryPipeline.cpp:674-693) and runs
``cv::goodFeaturesToTrack`` per tile (OpenCVGoodFeatureExtractor.cpp:4-21:
quality 0.01, min-distance 5). Here the whole frame's response is computed
once, non-max/min-distance suppression is a windowed max, and per-tile
top-k gives the same spatial spreading with a fixed (n_tiles * k) candidate
capacity.

Responses: ``min_eig`` (the ``min_eig_response`` kernel), ``min_eig_xla``
(the same wrapper: in the JAX package it is the XLA response, used where a
Pallas call cannot run under ``vmap``; here there is one route), ``harris``
and ``fast`` (threshold 10), both plain PyTorch as they are jnp in the JAX
package.

Ties: candidates are ranked with a stable descending sort, so that among
equal responses the lowest index wins, as ``lax.top_k`` does in the JAX
package (``torch.topk`` promises no order among equals).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pmv_tpu_torch.frontend import fast, image, min_eig

Tensor = torch.Tensor

NEG = -1e30


def _window_max(resp: Tensor, radius: int) -> Tensor:
    """Max over a (2r+1)^2 neighborhood at every pixel (``-inf`` outside the
    image)."""
    w = 2 * radius + 1
    return F.max_pool2d(resp[None, None], w, stride=1, padding=radius)[0, 0]


def top_k_stable(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top ``k`` along the last dim, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grid_extract(
    img: Tensor,
    n_per_tile: int,
    tile_h: int = 255,
    tile_w: int = 255,
    quality: float = 0.01,
    min_distance: int = 5,
    response: str = "min_eig",
) -> tuple[Tensor, Tensor, Tensor]:
    """Extract up to ``n_per_tile`` corners per ``tile_h x tile_w`` tile.

    Returns (xy (C, 2) float32 as (u=col, v=row), score (C,), valid (C,))
    with candidate capacity C = n_tiles * n_per_tile, ordered tile-major then
    score-descending within each tile.
    """
    H, W = img.shape
    if response in ("min_eig", "min_eig_xla"):
        resp = min_eig.min_eig_response(img)
    elif response == "harris":
        resp = image.harris_response(img)
    elif response == "fast":
        resp = fast.fast_response(img, threshold=10.0)
    else:
        raise ValueError(f"unknown response {response!r}")

    # Non-max + min-distance suppression: a corner survives iff it is the
    # windowed max of its (2*min_distance+1)^2 neighborhood.
    wmax = _window_max(resp, min_distance)
    is_peak = (resp >= wmax) & (resp > 0)

    # Tile the (padded) response; padded area gets NEG so it never wins.
    th, tw = tile_h, tile_w
    n_th = -(-H // th)
    n_tw = -(-W // tw)
    pH, pW = n_th * th, n_tw * tw
    padded = torch.full((pH, pW), NEG, dtype=resp.dtype, device=resp.device)
    padded[:H, :W] = torch.where(is_peak, resp, NEG)
    flat = padded.reshape(n_th, th, n_tw, tw).permute(0, 2, 1, 3).reshape(n_th * n_tw, th * tw)

    # Reference per-tile quality gate: score >= quality * tile_max response
    # (tile max over the raw response, not just peaks).
    raw_padded = torch.full((pH, pW), NEG, dtype=resp.dtype, device=resp.device)
    raw_padded[:H, :W] = resp
    tile_max = (
        raw_padded.reshape(n_th, th, n_tw, tw).permute(0, 2, 1, 3)
        .reshape(n_th * n_tw, th * tw).amax(dim=1)
    )

    score, idx = top_k_stable(flat, n_per_tile)  # (T, k)
    in_r = idx // tw
    in_c = idx % tw
    t_ids = torch.arange(n_th * n_tw, device=img.device)[:, None].expand_as(idx)
    r = (t_ids // n_tw) * th + in_r
    c = (t_ids % n_tw) * tw + in_c
    valid = (score > NEG / 2) & (score >= quality * tile_max[:, None]) & (score > 0)
    xy = torch.stack([c, r], dim=-1).to(torch.float32)
    return xy.reshape(-1, 2), score.reshape(-1).to(torch.float32), valid.reshape(-1)


def select_top(
    xy: Tensor, score: Tensor, valid: Tensor, capacity: int
) -> tuple[Tensor, Tensor, Tensor]:
    """Keep the ``capacity`` best valid candidates (score-descending),
    returning fixed-shape (capacity, 2), (capacity,), (capacity,)."""
    masked = torch.where(valid, score, NEG)
    top_score, idx = top_k_stable(masked, min(capacity, score.shape[0]))
    top_xy = xy[idx]
    top_valid = top_score > NEG / 2
    if capacity > score.shape[0]:
        pad = capacity - score.shape[0]
        top_xy = torch.cat([top_xy, torch.zeros((pad, 2), dtype=xy.dtype, device=xy.device)])
        top_score = torch.cat(
            [top_score, torch.full((pad,), NEG, dtype=score.dtype, device=score.device)]
        )
        top_valid = torch.cat(
            [top_valid, torch.zeros((pad,), dtype=torch.bool, device=valid.device)]
        )
    return top_xy, top_score, top_valid
