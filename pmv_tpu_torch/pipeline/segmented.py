"""Segmented (sequence-parallel) visual odometry — PyTorch counterpart of
``pmv_tpu/pipeline/segmented.py``, on one device.

The video is split into B contiguous segments of L transitions each; every
segment seeds its own feature table and map at its first frame and is
tracked as an independent VO state (``parallel.multi_seq``: here a loop over
the B states, each with its own RANSAC generator). The segment trajectories
are then stitched by replaying each segment's per-frame deltas onto the
previous segment's final pose (:func:`stitch_segments`).

Trade-off: each segment re-bootstraps its map (a few triangulation frames),
and the deltas at a boundary come from two independent maps, so drift is
somewhat higher than the sequential run's.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend.corners import grid_extract, select_top
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.io.prefetch import FramePrefetcher
from pmv_tpu_torch.parallel import multi_seq
from pmv_tpu_torch.pipeline import fused
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline
from pmv_tpu_torch.utils.profiling import span


def stitch_segments(R_hist: np.ndarray, t_hist: np.ndarray, L: int):
    """Replay the per-frame deltas of B segment trajectories onto one
    trajectory, in float64. ``R_hist`` (B, >= L+1, 3, 3) and ``t_hist``
    (B, >= L+1, 3) hold each segment's poses from its own origin; delta j of
    a segment is ``R_d = R[j+1] R[j]^T``, ``t_d = R[j]^T (t[j+1] - t[j])``,
    composed by the reference rule ``t <- R t_d + t``, ``R <- R_d R``.
    Returns (R list, t list) of 1 + B*L poses from the identity."""
    R_hist = np.asarray(R_hist, np.float64)
    t_hist = np.asarray(t_hist, np.float64)
    R_anchor = np.eye(3)
    t_anchor = np.zeros(3)
    R_out, t_out = [R_anchor.copy()], [t_anchor.copy()]
    for Rl, tl in zip(R_hist, t_hist):
        for j in range(L):
            R_d = Rl[j + 1] @ Rl[j].T
            t_d = Rl[j].T @ (tl[j + 1] - tl[j])
            t_anchor = R_anchor @ t_d + t_anchor
            R_anchor = R_d @ R_anchor
            R_out.append(R_anchor.copy())
            t_out.append(t_anchor.copy())
    return R_out, t_out


def segment_generators(seed: int, segments: int, device) -> list[torch.Generator]:
    """One RANSAC generator per segment, seeded from (``seed``, segment)."""
    gens = []
    for b in range(segments):
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([seed, b]).generate_state(1)[0]))
        gens.append(g)
    return gens


def seed_state(img: np.ndarray, cfg, step_cfg: fused.StepConfig, device) -> fused.StepState:
    """A sequence's fresh state at ``img`` on ``device``: grid corners, the
    top ``cfg.feature_capacity`` of them, an empty map, captured blocks."""
    dimg = torch.as_tensor(img, dtype=torch.float32).to(device)
    xy, sc, va = grid_extract(
        dimg, step_cfg.n_per_tile, tile_h=cfg.grid_rows, tile_w=cfg.grid_cols,
        quality=step_cfg.quality, min_distance=step_cfg.min_distance,
        response=step_cfg.response,
    )
    txy, tsc, tva = select_top(xy, sc, va, cfg.feature_capacity)
    table = FeatureTable(
        xy=txy, valid=tva, score=tsc,
        landmark=torch.full((cfg.feature_capacity,), -1, dtype=torch.int32, device=device),
    )
    return fused.init_state(
        pyr=build_pyramid(dimg, cfg.lk_levels), table=table,
        map_state=MapState.empty(cfg.map_capacity, device=device), cfg=step_cfg,
    )


class SegmentedPipeline(OdometryPipeline):
    """:class:`OdometryPipeline` processing B segments side by side.

    ``segments`` is B; B=1 degenerates to one segment run like the
    sequential pipeline (with its own seeding). The transitions processed
    are trimmed to B segments of L, L a multiple of ``chunk_frames`` where
    the frames allow. ``device=None`` means the GPU (an error without one).
    After :meth:`run`, ``segment_stats`` holds each segment's per-frame
    statistics (``frame_stats`` the same, segment after segment).
    """

    def __init__(self, cfg, segments: int = 8, device=None):
        super().__init__(cfg, device=device)
        self.segments = segments
        self.segment_length = 0  # L, set by run()
        self.segment_stats: list[list[dict]] = []

    def _segment_step_config(self, img_shape) -> fused.StepConfig:
        """The JAX package's segmented step configuration, field for field:
        it leaves ``reseed_tol``, ``lk_search``, ``ba_cadence``,
        ``ba_lm_cap``, ``matcher``, ``cont_tri`` and ``map_hist_rows`` at
        the step's defaults."""
        cfg = self.cfg
        preset = cfg.extractor_preset()
        return fused.StepConfig(
            lk_levels=cfg.lk_levels,
            lk_window=cfg.lk_window,
            lk_iters=cfg.lk_iters,
            tile_h=cfg.grid_rows,
            tile_w=cfg.grid_cols,
            n_per_tile=max(1, math.ceil(cfg.min_tracked_features / self._n_tiles(img_shape))),
            quality=preset["quality"],
            min_distance=preset["min_distance"],
            response=preset["response"],
            tracked_tol=cfg.tracked_features_tol,
            e_hypos=cfg.ransac_e_hypos,
            e_thresh=cfg.ransac_e_thresh,
            pnp_hypos=cfg.ransac_pnp_hypos,
            pnp_thresh=cfg.ransac_pnp_thresh,
            essential_solver=cfg.essential_solver,
            bundle_size=max(cfg.bundle_size, 1),
            ba_iters=cfg.max_iterations,
            ba_obs_gate_px=cfg.ba_obs_gate_px,
            traj_cap=cfg.traj_cap,
        )

    @torch.no_grad()
    def seed_segments(self) -> SimpleNamespace:
        """Everything :meth:`run` does before its first step: the init frame
        (segment 0's start), the cut of the transitions into B segments of L,
        each segment's state seeded at its first frame, the segments'
        generators and per-frame ground-truth steps. Returns them as a
        namespace (``L``, ``starts``, ``step_cfg``, ``states``, ``gens``,
        ``gt_steps`` (B, L)); also used to hand the segments to the ranks of
        a mesh (``parallel.multi_seq.local_rows``)."""
        cfg = self.cfg
        B = self.segments
        stop = min(cfg.frames, len(self.file_names), len(self.gt_t))
        # The standard init-frame choice gives segment 0's start.
        init_imgs = [img for _, img in FramePrefetcher(self.file_names[: cfg.init_frames])]
        self.initialise(init_imgs)
        self._seed_trajectory()

        first = self.init_offset
        n_trans = stop - first - 1  # transitions to estimate
        C0 = max(1, cfg.chunk_frames)
        # Every chunk is chunk_frames long where the frames allow; trailing
        # transitions beyond the largest multiple are dropped.
        L = (n_trans // B // C0) * C0
        if L < C0:
            L = max(1, n_trans // B)
        if L < 1:
            raise ValueError(f"too few frames ({n_trans}) for {B} segments")
        if L + 2 > cfg.traj_cap:
            raise ValueError(
                f"segment length {L} exceeds traj_cap={cfg.traj_cap} - 2; raise traj_cap explicitly"
            )
        seg_starts = [first + b * L for b in range(B)]
        img0 = init_imgs[self.init_offset]
        step_cfg = self._segment_step_config(img0.shape)

        states = []
        for s in seg_starts:
            (_, img), = FramePrefetcher([self.file_names[s]])
            states.append(seed_state(img, self.cfg, step_cfg, self.device))

        gt_steps = np.zeros((B, L), np.float32)
        for b, s in enumerate(seg_starts):
            for i in range(L):
                gt_steps[b, i] = np.linalg.norm(self.gt_t[s + i + 1] - self.gt_t[s + i])
        return SimpleNamespace(L=L, starts=seg_starts, step_cfg=step_cfg, states=states,
                               gens=segment_generators(cfg.seed, B, self.device), gt_steps=gt_steps)

    @torch.no_grad()
    def run(self) -> dict:
        cfg = self.cfg
        B = self.segments
        with span("segmented.seed"):
            seg = self.seed_segments()
            L, seg_starts, step_cfg, gens, gt_steps = seg.L, seg.starts, seg.step_cfg, seg.gens, seg.gt_steps
            state = multi_seq.batch_states(seg.states)
            del seg
        step = multi_seq.make_batched_chunk_step(None, step_cfg, device=self.device)
        frames = [iter(FramePrefetcher(self.file_names[s + 1: s + 1 + L])) for s in seg_starts]

        self._watch.tick()
        C = max(1, cfg.chunk_frames)
        stats = [[] for _ in range(B)]
        done = 0
        while done < L:
            take = min(C, L - done)
            with span("run.chunk"):
                imgs = self._upload([np.stack([next(it)[1] for _ in range(take)]) for it in frames])
                state, chunk_stats = step(state, imgs, gt_steps[:, done: done + take].tolist(), gens, self.K)
            for b in range(B):
                stats[b].extend(chunk_stats[b])
            done += take
        with span("run.readback"):
            R_hist = state.R_hist.cpu().numpy()
            t_hist = state.t_hist.cpu().numpy()
            self.runtime = self._watch.tock()

            with span("segmented.stitch"):
                self.R, self.t = stitch_segments(R_hist, t_hist, L)
            self.R_s = [np.eye(3)]
            self.t_s = [np.zeros(3)]
            # Each segment fires BA at local j in [1, L) at the step's cadence.
            cadence = fused.ba_cadence(step_cfg)
            self._ba_calls = B * sum(1 for j in range(1, L) if j % cadence == 0)
            self.segment_stats = [
                [{**s, "n3d": int(s["n3d"]), "inliers": int(s["inliers"]), "accepted": bool(s["accepted"])}
                 for s in seg] for seg in stats
            ]
        self.frame_stats = [s for seg in self.segment_stats for s in seg]
        self.segment_length = L
        # As in the JAX package, only segment 0's last table and map are kept.
        first_seg = multi_seq.state_at(state, 0)
        self.tables.append(first_seg.table)
        self.map = first_seg.map
        return self._finish()
