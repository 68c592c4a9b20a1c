"""The per-frame step of the default odometry loop — PyTorch counterpart of
``pmv_tpu/pipeline/fused.py``.

Per frame: pyramid build, batched LK tracking from cached blocks (or, with
``matcher=knn``, fresh corners and patch-SSD association against the
previous level-0 image), conditional reseed, PnP-vs-bootstrap pose,
landmark bookkeeping, motion gate; bundle adjustment at its cadence.
Everything stays on the device; the host reads back two integers per frame
(tracked features, live 3D points) to take the two branches the JAX package
expresses as ``lax.cond``:

- reseed iff ``tracked < reseed_tol``;
- ``count3DPoints >= tracked_tol`` selects RANSAC PnP, otherwise the
  essential-matrix bootstrap (with GT-derived scale ``gt_step``)
  triangulates a fresh map (estimatePose, OdometryPipeline.cpp:376-426).

That read-back is one device->host synchronisation per frame; removing it
(masked compute or CUDA graphs) is later work. The steady-state step
(``steady=True``) takes PnP without reading ``n3d``: it still reads
``tracked`` for the reseed.

State is a ``NamedTuple`` of tensors. The trajectory, feature-table and
landmark-snapshot histories are updated IN PLACE: the state returned by
:func:`frame_step` or :func:`chunk_step` shares those buffers with the state
it was given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pmv_tpu_torch.ba import schur_lm
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core.state import FeatureTable, MapState, scatter_rows
from pmv_tpu_torch.frontend import corners, knn_matcher
from pmv_tpu_torch.frontend import lucas_kanade as lk
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.pipeline import steps
from pmv_tpu_torch.pipeline.heuristics import motion_gate
from pmv_tpu_torch.solvers import essential, pnp
from pmv_tpu_torch.solvers.five_point import find_essential_5pt_ransac, ransac_budget
from pmv_tpu_torch.utils.profiling import span

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
    essential_solver: str = "five_point"  # five_point | eight_point
    matcher: str = "lk"  # lk | knn. knn = the reference's alternate
    # patch-SSD matcher (kNNFeatureMatcher.cpp): fresh corners every frame
    # + k-nearest SSD association (BASELINE.json config #3). In knn mode
    # StepState.blocks carries the previous level-0 image instead of LK
    # region blocks.
    knn_k: int = 7  # spatial nearest neighbors (kNNFeatureMatcher.h:28)
    knn_window: int = 15  # SSD patch side (kNNFeatureMatcher.h:10)
    knn_threshold: float = 2.0  # SSD accept threshold (kNNFeatureMatcher.h:11)
    knn_cand_per_tile: int = 101  # fresh corners per tile (~1000/frame,
    # kNNFeatureMatcher.cpp:3-10)
    bundle_size: int = 5
    ba_iters: int = 5
    ba_obs_gate_px: float = 0.0  # initial-residual observation gate (px)
    ba_cadence: int = 0  # frames between BA calls; 0 = reference cadence
    # (bundle_size//3*2, OdometryPipeline.cpp:407)
    cont_tri: bool = False  # continuous triangulation on PnP frames:
    # midpoint-triangulate unbound tracked slots from the accepted relative
    # pose and insert them (steps.continuous_triangulate). The reference has
    # no counterpart (its landmarks are born only at
    # OpenCVFivePointTri.cpp:36-53), so it is off by default.
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
    map_hist_rows: int = 0  # landmark-position snapshot rows (0 = off).
    # The reference's drawMap reads each landmark's CURRENT position at draw
    # time (OdometryPipeline.cpp:110-127); positions change at BA, so a
    # per-BA-cadence snapshot of map.xyz ((rows, M, 3) on the device) lets
    # the post-run replay draw frame k's dots where they were then. Row
    # k // cadence is (re)written after every frame's step and BA, so
    # insertions between BA calls are captured.


class StepState(NamedTuple):
    """Device-resident state threaded through frames. Nothing here is fetched
    to the host in the steady-state loop — the trajectory and per-frame table
    histories live on device so the whole run ends in one readback."""

    blocks: tuple  # per-level (region (N,Rg,Rg), r0 (N,), c0 (N,)) LK blocks
    # of the current frame — the next track's template source; with
    # matcher=knn ((level-0 image,),)
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
    map_hist: Tensor = None  # (map_hist_rows, M, 3) landmark snapshots
    ba_overflow: Tensor = None  # () BA calls that dropped an observation


def _search(cfg: StepConfig):
    return cfg.lk_search if cfg.lk_search > 0 else None


def init_state(pyr, table: FeatureTable, map_state: MapState, cfg: StepConfig) -> StepState:
    """Fresh state at frame 0."""
    N = table.capacity
    dev = table.xy.device
    T = cfg.traj_cap
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    if cfg.matcher == "knn":
        # kNN matching needs only the previous level-0 image.
        blocks = ((pyr[0],),)
    else:
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
        map_hist=torch.zeros(
            (cfg.map_hist_rows, map_state.capacity, 3), dtype=torch.float32, device=dev
        ),
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
    ((H, 6) on a PnP frame, (H, 5) on a bootstrap frame, (H, 8) with
    ``essential_solver=eight_point``), when given, replaces that draw.
    ``stats``: ``tracked``, ``n3d`` (ints), ``used_pnp``, ``reseed``
    (bools), ``inliers``, ``accepted`` (0-d tensors, left on the device).

    ``steady=True`` is the steady-state step: PnP is taken without reading
    ``n3d`` back (only ``tracked`` is read, for the reseed), the
    triangulation registration is skipped, and without ``cont_tri`` only
    row k+1 of the table history is written (row k already holds the
    source table). It is valid only while the map stays dense (``n3d >=
    tracked_tol`` on every frame): ``n3d`` and ``used_pnp`` then come back
    as device tensors, ``used_pnp`` being the condition the full step would
    have branched on, for the caller to check after the chunk. On a dense
    map it equals the full step bit for bit, RANSAC draws included.
    """
    dev = next_img.device
    N = state.table.capacity
    knn = cfg.matcher == "knn"
    with span("frontend"):
        # kNN reads level 0 only (the JAX package builds the other levels and
        # XLA drops them unused)
        next_pyr = build_pyramid(next_img, 0 if knn else cfg.lk_levels)

        if knn:
            # Alternate matcher (kNNFeatureMatcher.cpp): fresh corners every
            # frame + k-nearest patch-SSD association; the previous level-0
            # image rides in blocks[0][0].
            kc_xy, _, kc_valid = corners.grid_extract(
                next_pyr[0], cfg.knn_cand_per_tile,
                tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                quality=cfg.quality, min_distance=cfg.min_distance,
                response=cfg.response,
            )
            tracked_table = knn_matcher.knn_match(
                state.blocks[0][0], next_pyr[0], state.table, kc_xy, kc_valid,
                k=cfg.knn_k, window=cfg.knn_window, threshold=cfg.knn_threshold,
            )
            new_blocks = ((next_pyr[0],),)
        else:
            tracked_table, new_blocks = steps.track_step_cached(
                state.blocks, next_pyr, state.table,
                win=cfg.lk_window, iters=cfg.lk_iters, search=cfg.lk_search,
            )
    # The one host read-back of the frame: both branch conditions at once
    # (the steady step reads only the reseed's).
    with span("readback"):
        if steady:
            tracked = int(tracked_table.num_valid())
            n3d = state.table.count_3d(state.map.alive)
        else:
            tracked, n3d = torch.stack(
                [tracked_table.num_valid(), state.table.count_3d(state.map.alive)]
            ).tolist()

    # --- reseed: extraction, merge AND block recapture (kNN: no capture) ---
    reseed_tol = cfg.reseed_tol if cfg.reseed_tol > 0 else cfg.tracked_tol
    fire = tracked < reseed_tol
    next_table = tracked_table
    if fire:
        with span("frontend.reseed"):
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
            if not knn:
                # Reseeded slots moved: the cached blocks no longer cover them.
                new_blocks = lk.capture_blocks(
                    next_pyr, next_table.xy, win=cfg.lk_window, search=_search(cfg)
                )

    # --- pose: PnP vs essential-matrix bootstrap (steady: PnP) ---
    is_pnp = n3d >= cfg.tracked_tol
    src = state.table
    gt_step = torch.as_tensor(gt_step, dtype=torch.float32, device=dev)
    if steady or is_pnp:
        with span("solvers.pnp"):
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
        with span("solvers.bootstrap"):
            corr = src.valid & next_table.valid
            if cfg.essential_solver == "five_point":
                E, inl = find_essential_5pt_ransac(
                    src.xy, next_table.xy, corr, K, gen,
                    n_hypos=ransac_budget(cfg.e_hypos), thresh_px=cfg.e_thresh,
                    samples=samples,
                )
            else:
                E, inl = essential.find_essential_ransac(
                    src.xy, next_table.xy, corr, K, gen,
                    n_hypos=cfg.e_hypos, thresh_px=cfg.e_thresh, samples=samples,
                )
            R_d, t_unit, X_tri, front = essential.recover_pose(E, src.xy, next_table.xy, inl, K)
            t_d = t_unit * gt_step
            scale = gt_step
            tri_good = inl & front
            n_inl = torch.sum(tri_good)
            src_table, next_table, new_map = steps.register_triangulated(
                src, next_table, state.map, X_tri, tri_good, scale, state.R, state.t,
            )

    with span("step.gate"):
        R_new, t_new, R_s_new, t_s_new, accepted = motion_gate(
            R_d, t_d, state.R, state.t, state.R_s, state.t_s, scale
        )

        if cfg.cont_tri:
            # Map maintenance AFTER the pose is known: triangulate unbound
            # tracked slots against the accepted pose (a no-op when the gate
            # rejected or the bootstrap just rebuilt the map). It back-binds
            # into the source table, which row k of the history then takes.
            src_table, next_table, new_map = steps.continuous_triangulate(
                src_table, next_table, new_map,
                state.R, state.t, R_new, t_new, K,
                enable=accepted & is_pnp,
                reproj_px=cfg.cont_tri_reproj_px,
                min_depth=cfg.cont_tri_min_depth,
                max_depth=cfg.cont_tri_max_depth,
            )

        k_new = state.k + 1
        # Histories are updated in place (see the module docstring). Row k gets
        # the source table back (the bootstrap may have bound landmarks into it),
        # row k+1 the new table. A steady step without cont_tri binds
        # nothing into the source table, which row k already holds.
        state.R_hist[k_new] = R_new
        state.t_hist[k_new] = t_new
        if not steady or cfg.cont_tri:
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
    :func:`ba_step` at its cadence, then, with ``map_hist_rows``, the
    landmark positions into row ``k // cadence`` of ``map_hist`` (in place;
    ``k`` is the host's frame index, so nothing is read back). Returns
    (state, list of per-frame stats). ``steady`` runs the steady-state
    :func:`frame_step` on every frame; the caller checks every ``used_pnp``
    of the chunk (device bools) afterwards."""
    cadence = ba_cadence(cfg)
    all_stats = []
    for i in range(imgs_u8.shape[0]):
        with span("frame"):
            state, _, stats = frame_step(
                state, imgs_u8[i].to(torch.float32), gt_steps[i], gen, K, cfg, steady=steady
            )
            j = state.k - 1
            if cfg.bundle_size > 0 and j > 0 and j % cadence == 0:
                with span("ba"):
                    state = ba_step(state, K, cfg)
            if cfg.map_hist_rows > 0:
                state.map_hist[min(state.k // cadence, cfg.map_hist_rows - 1)] = state.map.xyz
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
    with span("ba.window"):
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

    with span("ba.solve"):
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
    with span("ba.scatter"):
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
