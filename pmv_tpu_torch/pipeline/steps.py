"""Per-frame device steps: track, reseed, landmark bookkeeping, BA window
assembly — PyTorch counterpart of ``pmv_tpu/pipeline/steps.py``.

The equivalent of the reference's addFrame/estimatePose inner machinery
(OdometryPipeline.cpp:329-374, :376-426) over fixed-shape feature tables.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core.state import FeatureTable, MapState, has_neighbor, scatter_rows
from pmv_tpu_torch.frontend import corners
from pmv_tpu_torch.frontend import lucas_kanade as lk

Tensor = torch.Tensor


def track_step_cached(
    blocks: tuple,
    next_pyr,
    prev_table: FeatureTable,
    win: int = 32,
    iters: int = 10,
    search: int = 0,
) -> tuple[FeatureTable, tuple]:
    """LK-track the previous frame's features into the next frame with the
    per-level templates sampled from the previous frame's cached region
    blocks. Returns (table, new_blocks) — thread ``new_blocks`` into the
    next call.

    Slot-aligned correspondence (the equivalent of the reference's
    ``feat_corr`` weak-ptr map, OpenCVLucasKanadeFM.cpp:19-30): slot i of the
    returned table corresponds to slot i of ``prev_table``; ``valid`` is the
    track status; the landmark association is inherited.
    """
    new_xy, status, new_blocks = lk.track_cached(
        blocks, next_pyr, prev_table.xy, prev_table.valid, win=win, iters=iters,
        search=search if search > 0 else None,
    )
    table = FeatureTable(
        xy=new_xy,
        valid=status,
        landmark=torch.where(status, prev_table.landmark, -1).to(torch.int32),
        score=torch.where(status, prev_table.score, 0.0),
    )
    return table, new_blocks


def reseed_merge(
    table: FeatureTable,
    cand_xy: Tensor,
    cand_score: Tensor,
    cand_valid: Tensor,
    min_distance: int = 5,
) -> FeatureTable:
    """Merge candidate corners into the table's free slots: drop candidates
    with an existing neighbor closer than Chebyshev ``min_distance``
    (Frame::hasNeighbor), and fill empty slots in slot order, best score
    first (the reseed path at OdometryPipeline.cpp:342-371). With
    ``cand_valid`` all-false the returned table equals the input."""
    neigh = has_neighbor(cand_xy, table.xy, table.valid, dist=min_distance)
    ok = cand_valid & ~neigh
    # Order candidates by score (strongest first; ties to the lowest index).
    order_score = torch.where(ok, cand_score, corners.NEG)
    top_score, order = corners.top_k_stable(order_score, cand_xy.shape[0])
    cand_xy = cand_xy[order]
    ok = top_score > corners.NEG / 2

    # i-th accepted candidate -> i-th free slot (slot order).
    N = table.capacity
    free_slots = torch.argsort(table.valid.to(torch.uint8), stable=True)  # invalid first
    num_free = N - torch.sum(table.valid)
    rank = torch.cumsum(ok.to(torch.int64), dim=0) - 1
    ok = ok & (rank < num_free)
    target = free_slots[torch.clamp(rank, 0, N - 1)]

    return FeatureTable(
        xy=scatter_rows(table.xy, target, cand_xy, ok),
        valid=scatter_rows(table.valid, target, True, ok),
        landmark=scatter_rows(table.landmark, target, -1, ok),
        score=scatter_rows(table.score, target, top_score, ok),
    )


def pnp_inputs(
    src_table: FeatureTable,
    next_table: FeatureTable,
    map_state: MapState,
    R_prev: Tensor,
    t_prev: Tensor,
):
    """Gather the 2D-3D correspondences for the PnP stage.

    The reference walks ``src.map`` + ``feat_corr`` (OpenCVEPnPSolver.cpp:
    13-33): features of the source frame bound to a live landmark and
    tracked into the next frame. Landmarks are moved from the pipeline's
    z-flipped world into the previous camera's *standard* frame:
    ``X_std = flip(R_prev^T (X - t_prev))``.

    Returns (X_std (N, 3), uv (N, 2) next-frame pixels, mask (N,),
    lm_slots (N,)).
    """
    lm = src_table.landmark
    bound = lm >= 0
    lm_safe = torch.clamp(lm, min=0).long()
    alive = map_state.alive[lm_safe] & bound
    mask = src_table.valid & next_table.valid & alive
    X_world = map_state.xyz[lm_safe]
    X_cam = geo.transform_inv(X_world, R_prev, t_prev)
    X_std = X_cam * X_cam.new_tensor([1.0, 1.0, -1.0])
    return X_std, next_table.xy, mask, lm


def register_triangulated(
    src_table: FeatureTable,
    next_table: FeatureTable,
    map_state: MapState,
    X_cam_std: Tensor,
    good: Tensor,
    scale: Tensor,
    R_prev: Tensor,
    t_prev: Tensor,
) -> tuple[FeatureTable, FeatureTable, MapState]:
    """Insert freshly triangulated landmarks into the map and bind them to
    the corresponding feature slots of both frames.

    Mirrors OpenCVFivePointTri.cpp:36-53: scale the camera-frame point by the
    GT-derived scale, flip z (pipeline convention), keep points in front
    (z < 0 after the flip), transform into the world with the current pose,
    and register in both frames' maps.
    """
    X_scaled = X_cam_std * scale
    X_flip = X_scaled * X_scaled.new_tensor([1.0, 1.0, -1.0])
    in_front = X_flip[:, 2] < 0
    insert_mask = good & in_front & src_table.valid & next_table.valid
    X_world = geo.transform(X_flip, R_prev, t_prev)
    new_map, slots = map_state.insert(X_world, insert_mask)
    lm_src = torch.where(insert_mask, slots, src_table.landmark)
    lm_next = torch.where(insert_mask, slots, next_table.landmark)
    return (
        src_table._replace(landmark=lm_src),
        next_table._replace(landmark=lm_next),
        new_map,
    )


def kill_outlier_landmarks(
    map_state: MapState, lm_slots: Tensor, used: Tensor, inliers: Tensor
) -> MapState:
    """Erase landmarks whose PnP correspondence was a RANSAC outlier —
    the global erase at OpenCVEPnPSolver.cpp:40-49."""
    return map_state.kill(lm_slots, used & ~inliers)


def assemble_ba_window(
    window_xy: Tensor,       # (P, N, 2)
    window_valid: Tensor,    # (P, N)
    window_lm: Tensor,       # (P, N)
    map_state: MapState,
):
    """Flatten a window of feature tables into BA observation arrays.

    The reference adds one residual block per (window frame, live-landmark
    feature) (CeresBundleAdjustment.cpp:36-52). Returns (obs_uv (P*N, 2),
    obs_pose (P*N,), obs_lm (P*N,), obs_mask (P*N,)).
    """
    P, N = window_valid.shape
    bound = window_lm >= 0
    lm_safe = torch.clamp(window_lm, min=0)
    alive = map_state.alive[lm_safe.long()] & bound
    mask = window_valid & alive
    obs_pose = torch.repeat_interleave(
        torch.arange(P, dtype=torch.int32, device=window_xy.device), N
    )
    return (
        window_xy.reshape(P * N, 2),
        obs_pose,
        lm_safe.reshape(P * N).to(torch.int32),
        mask.reshape(P * N),
    )
