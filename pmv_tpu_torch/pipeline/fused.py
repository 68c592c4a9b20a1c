"""The per-frame step of the default odometry loop — PyTorch counterpart of
``pmv_tpu/pipeline/fused.py``.

Per frame: pyramid build, batched LK tracking from cached blocks,
conditional reseed, PnP-vs-bootstrap pose, landmark bookkeeping, motion
gate; bundle adjustment at its cadence. Everything stays on the device; the
host reads back two integers per frame (tracked features, live 3D points) to
take the two branches the JAX package expresses as ``lax.cond``:

- reseed iff ``tracked < reseed_tol``;
- ``count3DPoints >= tracked_tol`` selects RANSAC PnP, otherwise the
  essential-matrix bootstrap (with GT-derived scale ``gt_step``)
  triangulates a fresh map (estimatePose, OdometryPipeline.cpp:376-426).

That read-back is one device->host synchronisation per frame; removing it
(masked compute or CUDA graphs) is later work.

State is a ``NamedTuple`` of tensors. The trajectory and feature-table
histories are updated IN PLACE: the state returned by :func:`frame_step`
shares those buffers with the state it was given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pmv_tpu_torch.ba import schur_lm
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core.state import FeatureTable, MapState, scatter_rows
from pmv_tpu_torch.frontend import corners
from pmv_tpu_torch.frontend import lucas_kanade as lk
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.pipeline import steps
from pmv_tpu_torch.pipeline.heuristics import motion_gate
from pmv_tpu_torch.solvers import essential, pnp
from pmv_tpu_torch.solvers.five_point import find_essential_5pt_ransac, ransac_budget

Tensor = torch.Tensor


class StepConfig(NamedTuple):
    """Static configuration of the per-frame step (field names and defaults
    of the JAX package's ``StepConfig``)."""

    lk_levels: int = 4
    lk_window: int = 32
    lk_iters: int = 10
    lk_search: int = 0  # search radius around the guess; 0 = max(4, win//2)
    tile_h: int = 255
    tile_w: int = 255
    n_per_tile: int = 40
    quality: float = 0.01
    min_distance: int = 5
    tracked_tol: int = 150
    reseed_tol: int = 0  # reseed when tracked < this; 0 = tracked_tol
    # (the reference couples reseed and the PnP/tri branch at
    # tracked_features_tol, OdometryPipeline.cpp:342/:383)
    e_hypos: int = 256
    e_thresh: float = 1.0
    pnp_hypos: int = 128
    pnp_thresh: float = 8.0
    response: str = "min_eig"  # corner response (extractor preset)
    essential_solver: str = "five_point"  # only five_point is ported
    matcher: str = "lk"  # only lk is ported
    knn_k: int = 7
    knn_window: int = 15
    knn_threshold: float = 2.0
    knn_cand_per_tile: int = 101
    bundle_size: int = 5
    ba_iters: int = 5
    ba_obs_gate_px: float = 0.0  # initial-residual observation gate (px)
    ba_cadence: int = 0  # frames between BA calls; 0 = reference cadence
    # (bundle_size//3*2, OdometryPipeline.cpp:407)
    cont_tri: bool = False  # not ported
    cont_tri_reproj_px: float = 2.0
    cont_tri_min_depth: float = 1.0
    cont_tri_max_depth: float = 120.0
    ba_lm_cap: int = 0  # max unique landmarks per BA window; 0 = P*N
    # (bundle_size x feature capacity, clamped to the map capacity) — the
    # true maximum, so NO observation can ever be dropped. A smaller explicit
    # cap trades BA cost for drop risk; StepState.ba_overflow counts
    # saturated calls.
    traj_cap: int = 1024  # device trajectory capacity (frames)
    lk_impl: str = "auto"  # kept for config compatibility: CUDA tensors go
    # through the hand-written kernels, CPU tensors through the plain versions
    map_hist_rows: int = 0  # landmark snapshots for the video replay (not ported)


class StepState(NamedTuple):
    """Device-resident state threaded through frames. Nothing here is fetched
    to the host in the steady-state loop — the trajectory and per-frame table
    histories live on device so the whole run ends in one readback."""

    blocks: tuple  # per-level (region (N,Rg,Rg), r0 (N,), c0 (N,)) LK blocks
    # of the current frame — the next track's template source
    table: FeatureTable
    map: MapState
    R: Tensor  # (3, 3) current world pose
    t: Tensor  # (3,)
    R_s: Tensor  # (3, 3) last accepted delta
    t_s: Tensor  # (3,)
    scale: Tensor  # () GT-derived step scale
    k: int  # current frame index (a host integer: it indexes the histories)
    R_hist: Tensor  # (T, 3, 3) trajectory history
    t_hist: Tensor  # (T, 3)
    # Per-frame observation history. Slot j holds frame j's FINAL table: the
    # triangulation branch back-writes the source frame
    # (OpenCVFivePointTri.cpp:51), so step j+1 re-writes slot j with the
    # updated source table. The sliding BA window (ba_step) reads its
    # last-bundle_size frames from these rows.
    tbl_xy_hist: Tensor  # (T, N, 2)
    tbl_valid_hist: Tensor  # (T, N)
    tbl_lm_hist: Tensor  # (T, N)
    map_hist: Tensor = None  # (rows, M, 3); rows is 0 in this port
    ba_overflow: Tensor = None  # () BA calls that dropped an observation


def check_ported(cfg: StepConfig) -> None:
    """Raise for the configurations whose code is not ported yet."""
    if cfg.matcher != "lk":
        raise NotImplementedError(
            f"matcher={cfg.matcher!r}: only the LK matcher is ported; matcher=knn "
            "(frontend/fast.py, frontend/knn_matcher.py) is not ported yet"
        )
    if cfg.cont_tri:
        raise NotImplementedError(
            "cont_tri=1: continuous triangulation is not ported yet"
        )
    if cfg.essential_solver != "five_point":
        raise NotImplementedError(
            f"essential_solver={cfg.essential_solver!r}: only five_point is "
            "ported; the 8-point RANSAC is not ported yet"
        )


def _search(cfg: StepConfig):
    return cfg.lk_search if cfg.lk_search > 0 else None


def init_state(pyr, table: FeatureTable, map_state: MapState, cfg: StepConfig) -> StepState:
    """Fresh state at frame 0."""
    check_ported(cfg)
    N = table.capacity
    dev = table.xy.device
    T = cfg.traj_cap
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    blocks = lk.capture_blocks(tuple(pyr), table.xy, win=cfg.lk_window, search=_search(cfg))
    tbl_xy_hist = torch.zeros((T, N, 2), dtype=torch.float32, device=dev)
    tbl_valid_hist = torch.zeros((T, N), dtype=torch.bool, device=dev)
    tbl_lm_hist = torch.full((T, N), -1, dtype=torch.int32, device=dev)
    tbl_xy_hist[0] = table.xy
    tbl_valid_hist[0] = table.valid
    tbl_lm_hist[0] = table.landmark
    return StepState(
        blocks=blocks,
        table=table,
        map=map_state,
        R=eye,
        t=torch.zeros(3, dtype=torch.float32, device=dev),
        R_s=eye.clone(),
        t_s=torch.zeros(3, dtype=torch.float32, device=dev),
        scale=torch.ones((), dtype=torch.float32, device=dev),
        k=0,
        R_hist=eye.expand(T, 3, 3).clone(),
        t_hist=torch.zeros((T, 3), dtype=torch.float32, device=dev),
        tbl_xy_hist=tbl_xy_hist,
        tbl_valid_hist=tbl_valid_hist,
        tbl_lm_hist=tbl_lm_hist,
        map_hist=torch.zeros((0, map_state.capacity, 3), dtype=torch.float32, device=dev),
        ba_overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


@torch.no_grad()
def frame_step(
    state: StepState,
    next_img: Tensor,
    gt_step,
    gen: torch.Generator | None,
    K: Tensor,
    cfg: StepConfig,
    steady: bool = False,
    samples: Tensor | None = None,
):
    """Process one frame. Returns (new_state, src_table', stats).

    ``src_table'`` is the previous frame's table with any landmark bindings
    added by the triangulation branch (the reference also back-writes the
    source frame, OpenCVFivePointTri.cpp:51).

    ``gen`` feeds the RANSAC draw of whichever pose branch runs; ``samples``
    ((H, 6) on a PnP frame, (H, 5) on a bootstrap frame), when given,
    replaces that draw. ``stats``: ``tracked``, ``n3d`` (ints), ``used_pnp``,
    ``reseed`` (bools), ``inliers``, ``accepted`` (0-d tensors, left on the
    device).
    """
    if steady:
        raise NotImplementedError(
            "steady=True (the branch-free steady-state step) is not ported yet"
        )
    check_ported(cfg)
    dev = next_img.device
    N = state.table.capacity
    next_pyr = build_pyramid(next_img, cfg.lk_levels)

    tracked_table, new_blocks = steps.track_step_cached(
        state.blocks, next_pyr, state.table,
        win=cfg.lk_window, iters=cfg.lk_iters, search=cfg.lk_search,
    )
    # The one host read-back of the frame: both branch conditions at once.
    tracked, n3d = torch.stack(
        [tracked_table.num_valid(), state.table.count_3d(state.map.alive)]
    ).tolist()

    # --- reseed: extraction, merge AND block recapture ---
    reseed_tol = cfg.reseed_tol if cfg.reseed_tol > 0 else cfg.tracked_tol
    fire = tracked < reseed_tol
    next_table = tracked_table
    if fire:
        cand_xy, cand_score, cand_valid = corners.grid_extract(
            next_pyr[0], cfg.n_per_tile,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            quality=cfg.quality, min_distance=cfg.min_distance,
            response=cfg.response,
        )
        next_table = steps.reseed_merge(
            tracked_table, cand_xy, cand_score, cand_valid,
            min_distance=cfg.min_distance,
        )
        # Reseeded slots moved: the cached blocks no longer cover them.
        new_blocks = lk.capture_blocks(
            next_pyr, next_table.xy, win=cfg.lk_window, search=_search(cfg)
        )

    # --- pose: PnP vs essential-matrix bootstrap ---
    is_pnp = n3d >= cfg.tracked_tol
    src = state.table
    gt_step = torch.as_tensor(gt_step, dtype=torch.float32, device=dev)
    if is_pnp:
        X_std, uv, mask, _ = steps.pnp_inputs(src, next_table, state.map, state.R, state.t)
        R_d, t_d, inliers = pnp.solve_pnp_ransac(
            X_std, uv, mask, K, gen, state.R_s, state.t_s,
            n_hypos=cfg.pnp_hypos, thresh_px=cfg.pnp_thresh, samples=samples,
        )
        scale = state.scale
        n_inl = torch.sum(inliers)
        new_map = steps.kill_outlier_landmarks(state.map, src.landmark, mask, inliers)
        src_table = src
    else:
        corr = src.valid & next_table.valid
        E, inl = find_essential_5pt_ransac(
            src.xy, next_table.xy, corr, K, gen,
            n_hypos=ransac_budget(cfg.e_hypos), thresh_px=cfg.e_thresh,
            samples=samples,
        )
        R_d, t_unit, X_tri, front = essential.recover_pose(E, src.xy, next_table.xy, inl, K)
        t_d = t_unit * gt_step
        scale = gt_step
        tri_good = inl & front
        n_inl = torch.sum(tri_good)
        src_table, next_table, new_map = steps.register_triangulated(
            src, next_table, state.map, X_tri, tri_good, scale, state.R, state.t,
        )

    R_new, t_new, R_s_new, t_s_new, accepted = motion_gate(
        R_d, t_d, state.R, state.t, state.R_s, state.t_s, scale
    )

    k_new = state.k + 1
    # Histories are updated in place (see the module docstring). Row k gets
    # the source table back (the bootstrap may have bound landmarks into it),
    # row k+1 the new table.
    state.R_hist[k_new] = R_new
    state.t_hist[k_new] = t_new
    state.tbl_xy_hist[state.k] = src_table.xy
    state.tbl_valid_hist[state.k] = src_table.valid
    state.tbl_lm_hist[state.k] = src_table.landmark
    state.tbl_xy_hist[k_new] = next_table.xy
    state.tbl_valid_hist[k_new] = next_table.valid
    state.tbl_lm_hist[k_new] = next_table.landmark

    new_state = state._replace(
        blocks=new_blocks,
        table=next_table,
        map=new_map,
        R=R_new,
        t=t_new,
        R_s=R_s_new,
        t_s=t_s_new,
        scale=scale,
        k=k_new,
    )
    stats = {
        "tracked": tracked,
        "n3d": n3d,
        "inliers": n_inl,
        "accepted": accepted,
        "used_pnp": is_pnp,
        "reseed": fire,
    }
    return new_state, src_table, stats


def ba_cadence(cfg: StepConfig) -> int:
    return cfg.ba_cadence if cfg.ba_cadence > 0 else max(1, cfg.bundle_size // 3 * 2)


@torch.no_grad()
def chunk_step(
    state: StepState,
    imgs_u8: Tensor,  # (C, H, W) uint8, on the device
    gt_steps,  # (C,) floats
    gen: torch.Generator | None,
    K: Tensor,
    cfg: StepConfig,
    steady: bool = False,
):
    """Process the C frames of one uploaded chunk: :func:`frame_step` on each
    (frames are shipped uint8 and converted on the device) and
    :func:`ba_step` at its cadence. Returns (state, list of per-frame
    stats)."""
    cadence = ba_cadence(cfg)
    all_stats = []
    for i in range(imgs_u8.shape[0]):
        state, _, stats = frame_step(
            state, imgs_u8[i].to(torch.float32), gt_steps[i], gen, K, cfg, steady=steady
        )
        j = state.k - 1
        if cfg.bundle_size > 0 and j > 0 and j % cadence == 0:
            state = ba_step(state, K, cfg)
        all_stats.append(stats)
    return state, all_stats


@torch.no_grad()
def ba_step(state: StepState, K: Tensor, cfg: StepConfig) -> StepState:
    """Device-resident sliding-window BA: state -> state.

    Window semantics match CeresBundleAdjustment.cpp:5-8: after processing
    frame k, the window is the last ``bundle_size`` frames [k-P+1, k]
    (global frame 0 held fixed). Feature tables come straight from the
    per-frame history rows; poses come from the trajectory history and are
    written back.
    """
    P = cfg.bundle_size
    dev = state.R.device
    cap = state.map.capacity
    fn = state.k + 1
    f_ids = [fn - P + i for i in range(P)]  # window frame indices (may be < 0 early)
    present = torch.tensor([f >= 0 for f in f_ids], device=dev)
    pose_free = torch.tensor([f >= 1 for f in f_ids], device=dev)
    f_safe = torch.tensor([max(f, 0) for f in f_ids], device=dev)

    xy = state.tbl_xy_hist[f_safe]
    valid = state.tbl_valid_hist[f_safe] & present[:, None]
    lm = state.tbl_lm_hist[f_safe]
    obs_uv, _, obs_lm, obs_mask = steps.assemble_ba_window(xy, valid, lm, state.map)
    tr = geo.pose_to_ba_params(state.R_hist[f_safe], state.t_hist[f_safe])

    # Compact the window to its unique landmarks: the solver's block tensors
    # are dense over the landmark axis, so shrinking it from map_capacity to
    # the window's live landmarks cuts BA cost ~an order of magnitude. A
    # window can't contain more distinct LIVE ids than the map has slots, so
    # min(P*N, capacity) is drop-free; observations of landmarks beyond an
    # explicit smaller cap are masked out instead of mis-indexed.
    N_cap = xy.shape[1]
    L_win = cfg.ba_lm_cap if cfg.ba_lm_cap > 0 else min(P * N_cap, cap)
    ids = torch.where(obs_mask, obs_lm, cap)
    uniq = torch.unique(ids, sorted=True)[:L_win]
    uniq = torch.nn.functional.pad(uniq, (0, L_win - uniq.shape[0]), value=cap)
    local = torch.searchsorted(uniq, ids).clamp(max=L_win - 1)
    kept = uniq[local] == ids
    # Count calls that actually DROPPED an observation (a live id absent from
    # the saturated unique table).
    saturated = torch.any(obs_mask & ~kept).to(torch.int32)
    obs_mask = obs_mask & kept
    uniq_safe = torch.clamp(uniq, max=cap - 1)
    lm_local = state.map.xyz[uniq_safe.long()]

    tr_out, lm_local_out, _ = schur_lm.ba_solve_grid(
        tr,
        lm_local,
        obs_uv.reshape(P, N_cap, 2),
        local.reshape(P, N_cap),
        obs_mask.reshape(P, N_cap),
        pose_free,
        K,
        iters=cfg.ba_iters,
        obs_gate_px=cfg.ba_obs_gate_px,
    )
    R_new, t_new = geo.ba_params_to_pose(tr_out)
    # Scatter optimized landmarks back to the global map, and only the free
    # poses back to the trajectory (the clipped early-window ids repeat row 0).
    lm_out = scatter_rows(state.map.xyz, uniq_safe, lm_local_out, uniq < cap)
    R_hist = scatter_rows(state.R_hist, f_safe, R_new, pose_free)
    t_hist = scatter_rows(state.t_hist, f_safe, t_new, pose_free)

    return state._replace(
        map=state.map._replace(xyz=lm_out),
        R_hist=R_hist,
        t_hist=t_hist,
        R=R_hist[state.k].clone(),
        t=t_hist[state.k].clone(),
        ba_overflow=state.ba_overflow + saturated,
    )
