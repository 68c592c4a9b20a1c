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
from pmv_tpu_torch.solvers.essential import normalize_points

Tensor = torch.Tensor


def lk_module(impl: str, win: int | None = None, search: int | None = None):
    """The LK tracker module for an implementation name of the JAX package
    (``tap``, ``pallas``, ``auto``; any other name falls through as there).
    The port has one route, ``frontend.lucas_kanade``: it launches the
    hand-written kernels for CUDA tensors and takes their plain versions
    for CPU tensors, so every name resolves to it (``StepConfig.lk_impl``
    is kept for config compatibility); ``win`` and ``search`` are accepted
    as the JAX package's are."""
    return lk


def track_step(
    prev_pyr,
    next_pyr,
    prev_table: FeatureTable,
    win: int = 32,
    iters: int = 10,
    search: int = 0,
) -> FeatureTable:
    """LK-track the previous frame's features into the next frame with a
    fresh template per level (the modular loop's tracker, plain PyTorch).

    Slot-aligned correspondence (the equivalent of the reference's
    ``feat_corr`` weak-ptr map, OpenCVLucasKanadeFM.cpp:19-30): slot i of the
    returned table corresponds to slot i of ``prev_table``; ``valid`` is the
    track status; the landmark association is inherited.
    """
    new_xy, status = lk.track(
        prev_pyr, next_pyr, prev_table.xy, prev_table.valid, win=win, iters=iters,
        search=search if search > 0 else None,
    )
    return FeatureTable(
        xy=new_xy,
        valid=status,
        landmark=torch.where(status, prev_table.landmark, -1).to(torch.int32),
        score=torch.where(status, prev_table.score, 0.0),
    )


def track_step_cached(
    blocks: tuple,
    next_pyr,
    prev_table: FeatureTable,
    win: int = 32,
    iters: int = 10,
    search: int = 0,
) -> tuple[FeatureTable, tuple]:
    """:func:`track_step` with the per-level templates sampled from the
    previous frame's cached region blocks (the hand-written level kernel on
    the card). Returns (table, new_blocks) — thread ``new_blocks`` into the
    next call."""
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


def grid_cand_count(shape, n_per_tile: int, tile_h: int, tile_w: int) -> int:
    """Candidate capacity of corners.grid_extract for ``shape``."""
    H, W = shape
    return (-(-H // tile_h)) * (-(-W // tile_w)) * n_per_tile


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


def reseed_step(
    table: FeatureTable,
    img: Tensor,
    n_per_tile: int,
    tile_h: int = 255,
    tile_w: int = 255,
    quality: float = 0.01,
    min_distance: int = 5,
    response: str = "min_eig",
) -> FeatureTable:
    """Top up the feature table from fresh grid-tiled corners: the expensive
    extraction (corners.grid_extract) composed with the cheap
    :func:`reseed_merge`. (Deviation kept from the JAX package: corners are
    extracted from the *new* frame's image; the reference samples the
    previous frame's image and pastes the coordinates into the new frame,
    OdometryPipeline.cpp:351-365.)"""
    cand_xy, cand_score, cand_valid = corners.grid_extract(
        img, n_per_tile, tile_h=tile_h, tile_w=tile_w,
        quality=quality, min_distance=min_distance, response=response,
    )
    return reseed_merge(table, cand_xy, cand_score, cand_valid, min_distance)


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


def continuous_triangulate(
    src_table: FeatureTable,
    next_table: FeatureTable,
    map_state: MapState,
    R1: Tensor,
    t1: Tensor,
    R2: Tensor,
    t2: Tensor,
    K: Tensor,
    enable,
    reproj_px: float = 2.0,
    min_depth: float = 1.0,
    max_depth: float = 120.0,
    min_sin2: float = 1e-5,
) -> tuple[FeatureTable, FeatureTable, MapState]:
    """Map maintenance on PnP frames: midpoint-triangulate slots tracked in
    both frames that have no live landmark, and insert the survivors.

    The reference only creates landmarks in the bootstrap branch
    (OpenCVFivePointTri.cpp:36-53), so its map decays between bootstraps;
    triangulating fresh (reseeded) features from the already-estimated
    relative pose keeps ``count3DPoints`` dense. One closed-form midpoint
    solve over all N slots (geometry.triangulate_midpoint), no RANSAC:
    cheirality in both views, the depth band, reprojection error in both
    views and parallax gate it, and PnP's outlier erase
    (kill_outlier_landmarks) reaps a survivor that still mis-tracks. Masked
    tables and static shapes; nothing is read back to the host.

    ``enable`` is a 0-d bool tensor (or a bool), typically
    ``accepted & is_pnp``; everything is an exact no-op when it is False.
    """
    F = torch.diag(R1.new_tensor([1.0, 1.0, -1.0]))
    # Relative pose in STANDARD camera coords (see register_triangulated's
    # flip convention): x_std = F R^T (p_w - t).
    R_rel = F @ R2.T @ R1 @ F
    t_rel = (F @ (R2.T @ (t1 - t2))[..., None])[..., 0]
    x1 = normalize_points(src_table.xy, K)
    x2 = normalize_points(next_table.xy, K)
    X1_std, sin2 = geo.triangulate_midpoint(R_rel, t_rel, x1, x2)
    z1 = X1_std[..., 2]
    z2 = (X1_std @ R_rel.T + t_rel)[..., 2]
    X_world = geo.transform(X1_std @ F, R1, t1)
    e1 = torch.linalg.norm(geo.project_points(X_world, R1, t1, K) - src_table.xy, dim=-1)
    e2 = torch.linalg.norm(geo.project_points(X_world, R2, t2, K) - next_table.xy, dim=-1)
    ok = (
        (z1 > min_depth) & (z1 < max_depth) & (z2 > min_depth)
        & (sin2 > min_sin2) & (e1 < reproj_px) & (e2 < reproj_px)
    )
    bound = next_table.landmark >= 0
    alive = map_state.alive[torch.clamp(next_table.landmark, min=0).long()] & bound
    cand = src_table.valid & next_table.valid & ~alive & ok & enable
    new_map, slots = map_state.insert(X_world, cand)
    return (
        src_table._replace(landmark=torch.where(cand, slots, src_table.landmark)),
        next_table._replace(landmark=torch.where(cand, slots, next_table.landmark)),
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


def count_3d(table: FeatureTable, map_state: MapState) -> Tensor:
    """Valid features bound to a live landmark (count3DPoints)."""
    return table.count_3d(map_state.alive)
