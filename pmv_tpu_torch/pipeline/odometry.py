"""The VO pipeline orchestrator — PyTorch counterpart of
``pmv_tpu/pipeline/odometry.py`` (itself the counterpart of the reference's
``OdometryPipeline``, OdometryPipeline.cpp).

Flow per frame (mirroring startPipeline/addFrame/estimatePose,
OdometryPipeline.cpp:247-426): async-prefetched image decode (the producer
thread's successor) -> pyramid build -> batched LK track of the previous
feature table (slot-aligned correspondences) -> reseed from grid corners when
tracked features drop below the reseed tolerance -> pose estimation for the
latest pair (RANSAC PnP against the live 3D map, or essential-matrix
bootstrap triangulation with GT-derived scale when the map is thin) ->
motion gate -> periodic sliding-window bundle adjustment -> ground-truth
error metrics written in the reference's exact error-file format
(:267-296).

Two loops: :meth:`OdometryPipeline.run` (chunks of frames through
pmv_tpu_torch.pipeline.fused, the heavy compute on ``device``; the host loop
decodes, uploads chunks of uint8 frames and keeps the books) and
:meth:`OdometryPipeline.run_modular`, the reference-shaped loop of per-stage
calls (``add_frame``, ``estimate_pose``, ``bundle_adjust``) with the
uncached tracker and the flat bundle adjustment, which reads back a few
scalars per frame to take its branches.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from pmv_tpu_torch import resolve_device
from pmv_tpu_torch.ba.schur_lm import BAProblem, ba_solve
from pmv_tpu_torch.config import OdometryPipelineException, VOConfig
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend import corners, knn_matcher
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.io import kitti
from pmv_tpu_torch.io.prefetch import FramePrefetcher
from pmv_tpu_torch.pipeline import fused, steps
from pmv_tpu_torch.pipeline.heuristics import motion_gate
from pmv_tpu_torch.solvers import essential, pnp
from pmv_tpu_torch.solvers.five_point import find_essential_5pt_ransac, ransac_budget
from pmv_tpu_torch.utils import checkpoint
from pmv_tpu_torch.utils.profiling import Stopwatch, span


def ba_cadence(cfg: VOConfig) -> int:
    """Frames between BA calls: ``ba_cadence``, or bundle_size // 3 * 2 at 0."""
    return cfg.ba_cadence if cfg.ba_cadence > 0 else max(1, cfg.bundle_size // 3 * 2)


def step_config(cfg: VOConfig, img_shape) -> fused.StepConfig:
    """The per-frame step's static configuration of ``cfg`` for frames of
    ``img_shape`` (H, W)."""
    n_tiles = math.ceil(img_shape[0] / cfg.grid_rows) * math.ceil(img_shape[1] / cfg.grid_cols)
    preset = cfg.extractor_preset()
    return fused.StepConfig(
        lk_levels=cfg.lk_levels,
        lk_window=cfg.lk_window,
        lk_iters=cfg.lk_iters,
        lk_search=cfg.lk_search,
        tile_h=cfg.grid_rows,
        tile_w=cfg.grid_cols,
        n_per_tile=max(1, math.ceil(cfg.min_tracked_features / n_tiles)),
        quality=preset["quality"],
        min_distance=preset["min_distance"],
        response=preset["response"],
        essential_solver=cfg.essential_solver,
        tracked_tol=cfg.tracked_features_tol,
        e_hypos=cfg.ransac_e_hypos,
        e_thresh=cfg.ransac_e_thresh,
        pnp_hypos=cfg.ransac_pnp_hypos,
        pnp_thresh=cfg.ransac_pnp_thresh,
        lk_impl=cfg.lk_impl,
        matcher=cfg.matcher,
        knn_cand_per_tile=1000 // n_tiles + 1,
        reseed_tol=cfg.reseed_tol,
        bundle_size=max(cfg.bundle_size, 1),
        ba_iters=cfg.max_iterations,
        ba_cadence=cfg.ba_cadence,
        ba_obs_gate_px=cfg.ba_obs_gate_px,
        ba_lm_cap=cfg.ba_lm_cap,
        cont_tri=bool(cfg.cont_tri),
        cont_tri_reproj_px=cfg.cont_tri_reproj_px,
        cont_tri_min_depth=cfg.cont_tri_min_depth,
        cont_tri_max_depth=cfg.cont_tri_max_depth,
        traj_cap=cfg.traj_cap,
        map_hist_rows=cfg.traj_cap // ba_cadence(cfg) + 2 if cfg.map_hist else 0,
    )


class OdometryPipeline:
    def __init__(self, cfg: VOConfig | str | Path, device=None):
        """``device=None`` means the GPU and raises when there is none; pass
        ``device="cpu"`` to run on the CPU (as the tests do)."""
        self.device = resolve_device(device)
        if not isinstance(cfg, VOConfig):
            cfg = VOConfig.from_ini(cfg)
        self.cfg = cfg
        self.file_names = kitti.list_images(cfg.image_dir)
        self.K = torch.as_tensor(
            kitti.parse_calibration(cfg.camera_calibration, cfg.camera),
            dtype=torch.float32,
        ).to(self.device)
        gt_R, gt_t = kitti.parse_poses(cfg.poses, stop=cfg.frames)
        self.gt_R = gt_R.astype(np.float64)
        self.gt_t = gt_t.astype(np.float64)

        self.map = MapState.empty(cfg.map_capacity, device=self.device)
        self.tables: list[FeatureTable] = []
        # Trajectory + heuristic-delta history (host-side, tiny).
        self.R: list[np.ndarray] = []
        self.t: list[np.ndarray] = []
        self.R_s: list[np.ndarray] = []
        self.t_s: list[np.ndarray] = []
        self.scale = 1.0
        self.init_offset = 0
        self.runtime = 0.0
        self.errors_t: list[float] = []
        self.errors_R: list[float] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        self._ba_calls = 0  # actual BA invocations this run
        self.ba_overflow = 0  # BA windows of run() that saturated ba_lm_cap
        self._ba_cadence = ba_cadence(cfg)
        self._prev_pyr = None  # the modular loop's previous pyramid
        # tick/tock stack of the run time; stage times are the spans of
        # utils.profiling's tracer
        self._watch = Stopwatch(self.device)
        # Landmark-position snapshots of run() (StepState.map_hist), read
        # back only when a video is asked for (viz/render.py replay).
        self.map_hist: np.ndarray | None = None
        self.map_hist_cadence = self._ba_cadence
        self.frame_stats: list[dict] = []  # per tracked frame, filled by both loops

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _log(self, *args):
        if self.cfg.verbose:
            print(*args, flush=True)

    def _n_tiles(self, shape) -> int:
        H, W = shape
        return math.ceil(H / self.cfg.grid_rows) * math.ceil(W / self.cfg.grid_cols)

    # ------------------------------------------------------------------
    # initialisation (OdometryPipeline.cpp:428-482)
    # ------------------------------------------------------------------

    def initialise(self, images: list[np.ndarray]) -> None:
        """Pick the best of the first ``init_frames`` frames by the
        reference's cost: std of per-tile feature counts + std of scores
        (:461-464), then seed frame 0's feature table from it."""
        cfg = self.cfg
        best_cost = np.inf
        best = None
        for i, img in enumerate(images):
            n_tiles = self._n_tiles(img.shape)
            n_per_tile = max(1, cfg.min_tracked_features // n_tiles)
            preset = cfg.extractor_preset()
            xy, score, valid = corners.grid_extract(
                torch.as_tensor(img, dtype=torch.float32).to(self.device),
                n_per_tile,
                tile_h=cfg.grid_rows,
                tile_w=cfg.grid_cols,
                **preset,
            )
            v = valid.cpu().numpy()
            s = score.cpu().numpy()
            counts = v.reshape(n_tiles, n_per_tile).sum(axis=1).astype(np.float64)
            accepted = s[v]
            std_n = counts.std(ddof=1) if len(counts) > 1 else 0.0
            std_s = accepted.std(ddof=1) if len(accepted) > 1 else 0.0
            cost = std_n + std_s
            self._log(f"init frame {i}: {v.sum()} feats, cost {cost:.3f}")
            if cost < best_cost:
                best_cost = cost
                best = (i, xy, score, valid)
        i, xy, score, valid = best
        self.init_offset = i
        top_xy, top_score, top_valid = corners.select_top(
            xy, score, valid, cfg.feature_capacity
        )
        table = FeatureTable(
            xy=top_xy,
            valid=top_valid,
            landmark=torch.full(
                (cfg.feature_capacity,), -1, dtype=torch.int32, device=self.device
            ),
            score=top_score,
        )
        self.tables = [table]
        self._log(
            f"Initialised using {int(top_valid.sum())} features from frame #{i}"
        )

    # ------------------------------------------------------------------
    # per-frame ingest (addFrame, OdometryPipeline.cpp:329-374)
    # ------------------------------------------------------------------

    def _pyramid(self, img: np.ndarray) -> list[torch.Tensor]:
        """The frame's pyramid on the device; level 0 only for the kNN
        matcher, which reads nothing else."""
        levels = 0 if self.cfg.matcher == "knn" else self.cfg.lk_levels
        return build_pyramid(torch.as_tensor(img, dtype=torch.float32).to(self.device), levels)

    def add_frame(self, img: np.ndarray) -> int:
        """Match the previous frame's features into ``img`` and reseed when
        too few were matched; appends the frame's table. Returns its index."""
        cfg = self.cfg
        pyr = self._pyramid(img)
        k = len(self.tables)
        if cfg.verbose:
            self._watch.tick()
        if cfg.matcher == "knn":
            # Alternate matcher (kNNFeatureMatcher.cpp semantics): fresh
            # corners in the new frame + patch-SSD association. Like the
            # JAX package's modular branch, the candidates take the default
            # (min-eig) response with quality_level / min_distance, not the
            # extractor preset.
            cand_xy, _, cand_valid = corners.grid_extract(
                pyr[0], 1000 // max(1, self._n_tiles(img.shape)) + 1,
                tile_h=cfg.grid_rows, tile_w=cfg.grid_cols,
                quality=cfg.quality_level, min_distance=cfg.min_distance,
            )
            table = knn_matcher.knn_match(
                self._prev_pyr[0], pyr[0], self.tables[k - 1], cand_xy, cand_valid
            )
        else:
            table = steps.track_step(
                self._prev_pyr, pyr, self.tables[k - 1],
                win=cfg.lk_window, iters=cfg.lk_iters, search=cfg.lk_search,
            )
        tracked = int(table.num_valid())
        if cfg.verbose:
            # Per-stage timing like the reference's verbose printouts
            # (OdometryPipeline.cpp:334-340).
            self._log(f"{self._watch.tock():.6g} seconds for feature matching in frame #{k}")
        reseed = tracked < (cfg.reseed_tol if cfg.reseed_tol > 0 else cfg.tracked_features_tol)
        if reseed:
            n_tiles = self._n_tiles(img.shape)
            n_per_tile = max(1, math.ceil(cfg.min_tracked_features / n_tiles))
            if cfg.verbose:
                self._watch.tick()
            self._log(f"Trying to find {cfg.min_tracked_features} new features in frame #{k}")
            table = steps.reseed_step(
                table, pyr[0], n_per_tile,
                tile_h=cfg.grid_rows, tile_w=cfg.grid_cols, **cfg.extractor_preset(),
            )
            if cfg.verbose:
                # OdometryPipeline.cpp:369-370.
                self._log(f"Feature extraction took {self._watch.tock():.6g} seconds")
        self.tables.append(table)
        self._prev_pyr = pyr
        self.frame_stats.append({"tracked": tracked, "reseed": reseed})
        return k

    # ------------------------------------------------------------------
    # pose estimation (estimatePose, OdometryPipeline.cpp:376-426)
    # ------------------------------------------------------------------

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(self.device)

    def estimate_pose(self, j: int) -> None:
        """Estimate the pose of frame j+1 from the pair (j, j+1)."""
        cfg = self.cfg
        if cfg.verbose:
            self._watch.tick()
        src = self.tables[j]
        nxt = self.tables[j + 1]
        R_j, t_j = self._f32(self.R[j]), self._f32(self.t[j])
        R_s_j, t_s_j = self._f32(self.R_s[j]), self._f32(self.t_s[j])

        n3d = int(steps.count_3d(src, self.map))
        used_pnp = n3d >= cfg.tracked_features_tol
        if used_pnp:
            X_std, uv, mask, lm_slots = steps.pnp_inputs(src, nxt, self.map, R_j, t_j)
            # Guess: last accepted relative delta (better-conditioned than
            # the reference's global-pose guess at OpenCVEPnPSolver.cpp:10).
            R_delta, t_delta, inliers = pnp.solve_pnp_ransac(
                X_std, uv, mask, self.K, self._gen, R_s_j, t_s_j,
                n_hypos=cfg.ransac_pnp_hypos, thresh_px=cfg.ransac_pnp_thresh,
            )
            self.map = steps.kill_outlier_landmarks(self.map, lm_slots, mask, inliers)
            n_inl = torch.sum(inliers)
            if cfg.verbose:
                self._log(f"frame {j}: PnP with {n3d} 3D points, {int(n_inl)} inliers")
        else:
            if cfg.verbose:
                self._watch.tick()
            corr = src.valid & nxt.valid
            if cfg.essential_solver == "five_point":
                E, inl = find_essential_5pt_ransac(
                    src.xy, nxt.xy, corr, self.K, self._gen,
                    n_hypos=ransac_budget(cfg.ransac_e_hypos),
                    thresh_px=cfg.ransac_e_thresh,
                )
            else:
                E, inl = essential.find_essential_ransac(
                    src.xy, nxt.xy, corr, self.K, self._gen,
                    n_hypos=cfg.ransac_e_hypos, thresh_px=cfg.ransac_e_thresh,
                )
            R_delta, t_unit, X_tri, front = essential.recover_pose(E, src.xy, nxt.xy, inl, self.K)
            # Absolute scale from ground truth (OpenCVFivePointTri.cpp:28-34).
            g = j + self.init_offset
            self.scale = float(np.linalg.norm(self.gt_t[g + 1] - self.gt_t[g]))
            t_delta = t_unit * self.scale
            good = inl & front
            src2, nxt2, self.map = steps.register_triangulated(
                src, nxt, self.map, X_tri, good, self._f32(self.scale), R_j, t_j,
            )
            self.tables[j] = src2
            self.tables[j + 1] = nxt2
            n_inl = torch.sum(good)
            if cfg.verbose:
                self._log(f"frame {j}: triangulated, {int(n_inl)} new landmarks")
                # OdometryPipeline.cpp:394-395.
                self._log(f"{self._watch.tock():.6g} seconds for triangulating points.")

        R_new, t_new, R_s_new, t_s_new, accepted = motion_gate(
            R_delta, t_delta, R_j, t_j, R_s_j, t_s_j, self._f32(self.scale)
        )
        accepted = bool(accepted)
        if not accepted:
            self._log("Using heuristic motion")
        self.R.append(R_new.cpu().numpy().astype(np.float64))
        self.t.append(t_new.cpu().numpy().astype(np.float64))
        self.R_s.append(R_s_new.cpu().numpy().astype(np.float64))
        self.t_s.append(t_s_new.cpu().numpy().astype(np.float64))
        self.frame_stats[j].update(n3d=n3d, used_pnp=used_pnp, inliers=n_inl, accepted=accepted)
        if cfg.verbose:
            # OdometryPipeline.cpp:404-405.
            self._log(f"{self._watch.tock():.6g} seconds for pose estimation in frame #{j}")

        if cfg.bundle_size and j and j % self._ba_cadence == 0:
            self.bundle_adjust(j + 1)
            self._ba_calls += 1

    # ------------------------------------------------------------------
    # bundle adjustment window (CeresBundleAdjustment.cpp:5-89)
    # ------------------------------------------------------------------

    def bundle_adjust(self, fn_frame: int) -> None:
        """Flat-observation BA over the last ``bundle_size`` frames up to
        ``fn_frame`` and the whole map (early windows padded with fixed,
        unobserved slots); writes the poses and landmarks back."""
        cfg = self.cfg
        dev = self.device
        fn = fn_frame + 1
        n = min(cfg.bundle_size, fn)
        N = cfg.feature_capacity
        frame_ids = list(range(fn - n, fn))
        pad = cfg.bundle_size - n

        xy = torch.stack(
            [torch.zeros((N, 2), dtype=torch.float32, device=dev)] * pad
            + [self.tables[i].xy for i in frame_ids]
        )
        valid = torch.stack(
            [torch.zeros((N,), dtype=torch.bool, device=dev)] * pad
            + [self.tables[i].valid for i in frame_ids]
        )
        lm = torch.stack(
            [torch.full((N,), -1, dtype=torch.int32, device=dev)] * pad
            + [self.tables[i].landmark for i in frame_ids]
        )
        obs_uv, obs_pose, obs_lm, obs_mask = steps.assemble_ba_window(xy, valid, lm, self.map)
        tr = torch.stack(
            [torch.zeros((6,), dtype=torch.float32, device=dev)] * pad
            + [geo.pose_to_ba_params(self._f32(self.R[i]), self._f32(self.t[i])) for i in frame_ids]
        )
        # Global frame 0 is held fixed (the reference skips it entirely,
        # CeresBundleAdjustment.cpp:22-23; its observations stay as a window
        # anchor). Padded slots are fixed too.
        pose_free = torch.tensor([False] * pad + [i != 0 for i in frame_ids], device=dev)

        prob = BAProblem(
            tr=tr, lm=self.map.xyz, obs_uv=obs_uv, obs_pose=obs_pose, obs_lm=obs_lm,
            obs_mask=obs_mask, pose_free=pose_free, K=self.K,
        )
        tr_out, lm_out, stats = ba_solve(prob, iters=cfg.max_iterations, obs_gate_px=cfg.ba_obs_gate_px)
        if cfg.verbose:
            # Ceres-style per-iteration solver progress (the reference streams
            # Summary::FullReport under verbose, CeresBundleAdjustment.cpp:
            # 56-57, :63-64).
            c_prev = float(stats["cost0"])
            for it, c in enumerate(stats["history"].tolist()):
                self._log(f"  BA iter {it}: cost {c:.6e} (change {c_prev - c:.3e})")
                c_prev = c
            self._log(
                f"BA window [{frame_ids[0]},{frame_ids[-1]}]: cost "
                f"{float(stats['cost0']):.1f} -> {float(stats['cost']):.1f}"
            )
        self.map = self.map._replace(xyz=lm_out)
        R_new, t_new = geo.ba_params_to_pose(tr_out)
        R_new = R_new.cpu().numpy().astype(np.float64)
        t_new = t_new.cpu().numpy().astype(np.float64)
        for idx, i in enumerate(frame_ids):
            if i == 0:
                continue
            self.R[i] = R_new[pad + idx]
            self.t[i] = t_new[pad + idx]

    # ------------------------------------------------------------------
    # main loop (startPipeline, OdometryPipeline.cpp:247-296)
    # ------------------------------------------------------------------

    def _seed_trajectory(self) -> None:
        eye = np.eye(3)
        zero = np.zeros(3)
        self.R = [eye.copy()]
        self.t = [zero.copy()]
        self.R_s = [eye.copy()]
        self.t_s = [zero.copy()]

    def _finish(self) -> dict:
        self._compute_errors()
        if self.cfg.error_path:
            self.write_error_file(self.cfg.error_path)
        return {
            "runtime": self.runtime,
            "frames": len(self.t),
            "t_total": float(np.sum(self.errors_t)) if self.errors_t else 0.0,
            "R_total": float(np.sum(self.errors_R)) if self.errors_R else 0.0,
            "ba_calls": self._ba_calls,
        }

    def _step_config(self, img_shape) -> fused.StepConfig:
        """The per-frame step's static configuration. A run that would
        overflow the device trajectory history fails loudly here."""
        cfg = self.cfg
        if cfg.frames + 2 > cfg.traj_cap:
            raise OdometryPipelineException(
                f"frames={cfg.frames} exceeds traj_cap={cfg.traj_cap} - 2; "
                "raise traj_cap explicitly"
            )
        return step_config(cfg, img_shape)

    def _upload(self, frames: list[np.ndarray]) -> torch.Tensor:
        """One chunk of frames to the device as uint8 (4x less transfer than
        float32), from pinned memory where the device is a GPU."""
        with span("run.upload"):
            host = torch.from_numpy(np.stack(frames).astype(np.uint8))
            if self.device.type == "cuda":
                return host.pin_memory().to(self.device, non_blocking=True)
            return host

    @torch.no_grad()
    def run(self) -> dict:
        """Main loop: chunks of frames through ``fused.chunk_step`` with async
        host-side frame prefetch — the analogue of the reference's two-thread
        pipeline — and one final readback. With ``checkpoint_path`` it
        snapshots the state every ``checkpoint_every`` frames at a chunk
        boundary and at the end; with ``resume`` it starts from the snapshot;
        with ``live_every`` it writes ``map_live.png`` as it goes. A matcher
        other than ``lk`` and ``knn`` runs through :meth:`run_modular`."""
        cfg = self.cfg
        if cfg.matcher not in ("lk", "knn"):
            # Say so loudly (not just under verbose): the modular loop
            # dispatches once per stage.
            print(
                f"pmv_tpu_torch: matcher={cfg.matcher!r} is not fused — falling back "
                "to the modular per-stage loop (slower than the fused matchers)",
                flush=True,
            )
            return self.run_modular()
        with span("run.init"):
            init_paths = self.file_names[: cfg.init_frames]
            init_imgs = [img for _, img in FramePrefetcher(init_paths)]
            self.initialise(init_imgs)
            self._seed_trajectory()

            img0 = init_imgs[self.init_offset]
            step_cfg = self._step_config(img0.shape)
            start = self.init_offset + 1
            stop = min(cfg.frames, len(self.file_names))
            ckpt = Path(cfg.checkpoint_path) if cfg.checkpoint_path else None
            if cfg.resume and ckpt is not None and ckpt.exists():
                # The snapshot holds the state and where the RANSAC generator
                # stood: the run goes on exactly as the uninterrupted one.
                state, _ = checkpoint.load_fused_state(ckpt, self.device, generator=self._gen)
                self._log(f"Resumed fused state at frame {state.k} from {ckpt}")
            else:
                img0_dev = torch.as_tensor(img0, dtype=torch.float32).to(self.device)
                state = fused.init_state(
                    pyr=build_pyramid(img0_dev, cfg.lk_levels),
                    table=self.tables[0],
                    map_state=self.map,
                    cfg=step_cfg,
                )
        k_last = state.k

        self._watch.tick()
        C = max(1, cfg.chunk_frames)
        buf_img: list[np.ndarray] = []
        buf_gt: list[float] = []
        stats_all: list[dict] = []

        def flush(state):
            with span("run.chunk"):
                imgs = self._upload(buf_img)
                state, stats = fused.chunk_step(
                    state, imgs, list(buf_gt), self._gen, self.K, step_cfg
                )
            stats_all.extend(stats)
            buf_img.clear()
            buf_gt.clear()
            return state

        last_saved = last_live = k_last

        def maybe_checkpoint(state, force=False):
            """Snapshot the state and the generator at a chunk boundary,
            through a temporary file renamed into place."""
            nonlocal last_saved
            if ckpt is None:
                return
            due = cfg.checkpoint_every > 0 and k_last - last_saved >= cfg.checkpoint_every
            if not (due or force):
                return
            tmp = Path(str(ckpt) + ".tmp.npz")
            with span("checkpoint.save"):
                checkpoint.save_fused_state(state, tmp, generator=self._gen)
                tmp.replace(ckpt)
            last_saved = k_last

        def maybe_live(state):
            """During-run observability: the trajectory map every
            ``live_every`` frames — the headless counterpart of the
            reference's per-frame cv::imshow map (OdometryPipeline.cpp:
            423-425). Reads back only the trajectory so far and the map."""
            nonlocal last_live
            if cfg.live_every <= 0 or k_last - last_live < cfg.live_every:
                return
            last_live = k_last
            from pmv_tpu_torch.io.png import write_png
            from pmv_tpu_torch.viz import render

            sk = state.k
            t_h = state.t_hist[: sk + 1].cpu().numpy()
            R_h = state.R_hist[: sk + 1].cpu().numpy()
            xyz = state.map.xyz.cpu().numpy()
            alive = state.map.alive.cpu().numpy()
            m = render.draw_map(
                list(t_h), self.gt_t, self.init_offset, cfg.map_scale,
                landmarks=xyz[alive], R_est=list(R_h), gt_R=self.gt_R,
            )
            out = Path(cfg.error_path or "map_live.png")
            write_png(out.parent / "map_live.png", m)

        for _, img in FramePrefetcher(self.file_names[start + k_last : stop]):
            k = k_last + 1
            g = k - 1 + self.init_offset
            if g + 1 >= len(self.gt_t):
                break
            buf_img.append(img)
            buf_gt.append(float(np.linalg.norm(self.gt_t[g + 1] - self.gt_t[g])))
            k_last = k
            if len(buf_img) == C:
                state = flush(state)
                maybe_checkpoint(state)
                maybe_live(state)
        if buf_img:
            state = flush(state)
        maybe_checkpoint(state, force=True)
        # Exact BA-call count of the loop: chunk_step fires BA after frame k
        # at j = k_new - 1, i.e. j ranges over [1, k_last).
        cadence = fused.ba_cadence(step_cfg)
        self._ba_calls = sum(1 for j in range(1, k_last) if j % cadence == 0)
        # One readback for the whole run.
        with span("run.readback"):
            self.map = state.map
            R_hist = state.R_hist.cpu().numpy()
            t_hist = state.t_hist.cpu().numpy()
            self.runtime = self._watch.tock()
            self.R = [np.asarray(R_hist[i], np.float64) for i in range(k_last + 1)]
            self.t = [np.asarray(t_hist[i], np.float64) for i in range(k_last + 1)]
            self.R_s = [state.R_s.cpu().numpy().astype(np.float64)]
            self.t_s = [state.t_s.cpu().numpy().astype(np.float64)]
            self.scale = float(state.scale)
            # Per-frame statistics and feature tables, materialized post-run,
            # outside the timed window.
            if stats_all:
                inl = torch.stack([s["inliers"] for s in stats_all]).tolist()
                acc = torch.stack([s["accepted"] for s in stats_all]).tolist()
                self.frame_stats = [
                    {**s, "inliers": int(i), "accepted": bool(a)}
                    for s, i, a in zip(stats_all, inl, acc)
                ]
        for s in self.frame_stats:
            self._log(
                f"frame: tracked {s['tracked']}, n3d {s['n3d']}, "
                f"{'pnp' if s['used_pnp'] else 'tri'}, inliers {s['inliers']}, "
                f"accepted {s['accepted']}"
            )
        n_overflow = self.ba_overflow = int(state.ba_overflow)
        if n_overflow:
            # Saturated windows silently drop observations — a biased BA.
            print(
                f"pmv_tpu_torch: {n_overflow} BA windows saturated ba_lm_cap — "
                "raise ba_lm_cap (observations were dropped; heading drift risk)",
                flush=True,
            )
        # The landmark-position history is large (about 100 MB at the
        # default traj_cap and map_capacity) and only the video replay reads
        # it: read it back only when one will be rendered.
        if step_cfg.map_hist_rows > 0 and (cfg.video_path or cfg.fancy_video):
            self.map_hist = state.map_hist.cpu().numpy()
            self.map_hist_cadence = cadence
        zero_score = torch.zeros((cfg.feature_capacity,), dtype=torch.float32, device=self.device)
        self.tables = [
            FeatureTable(
                xy=state.tbl_xy_hist[i],
                valid=state.tbl_valid_hist[i],
                landmark=state.tbl_lm_hist[i],
                score=zero_score,
            )
            for i in range(k_last + 1)
        ]
        return self._finish()

    @torch.no_grad()
    def run_modular(self) -> dict:
        """Reference-shaped loop of per-stage calls — ``add_frame`` then
        ``estimate_pose`` per frame, ``bundle_adjust`` at its cadence — with
        the uncached tracker and the flat BA: behaviourally equivalent to
        :meth:`run`, with a few host read-backs per frame."""
        cfg = self.cfg
        self._ba_calls = 0
        self.frame_stats = []
        init_paths = self.file_names[: cfg.init_frames]
        init_imgs = [img for _, img in FramePrefetcher(init_paths)]
        self.initialise(init_imgs)
        self._prev_pyr = self._pyramid(init_imgs[self.init_offset])
        self._seed_trajectory()

        self._watch.tick()
        start = self.init_offset + 1
        stop = min(cfg.frames, len(self.file_names))
        for _, img in FramePrefetcher(self.file_names[start:stop]):
            k = self.add_frame(img)
            self.estimate_pose(k - 1)
        self.runtime = self._watch.tock()
        for s in self.frame_stats:
            s["inliers"] = int(s["inliers"])
        return self._finish()

    # ------------------------------------------------------------------
    # metrics + error file (OdometryPipeline.cpp:267-296)
    # ------------------------------------------------------------------

    def _compute_errors(self) -> None:
        """Reference-faithful error computation, including its in-place
        mutation of the stored GT arrays (cv::Mat shallow copies at
        OdometryPipeline.cpp:273-277 flip signs *in the stored poses*, and
        the R norm then compares against gt_R[i] — not gt_R[i+init_offset] —
        at :279, possibly already mutated). Bug-compatible on purpose: the
        published baseline numbers were produced by this exact computation."""
        gt_t = self.gt_t.copy()
        gt_R = self.gt_R.copy()
        self.errors_t = []
        self.errors_R = []
        for i in range(1, len(self.t)):
            g = i + self.init_offset
            if g >= len(gt_t):
                break
            gt_t[g][2] *= -1
            gt_R[g][2][0] *= -1
            gt_R[g][0][2] *= -1
            t_norm = float(np.linalg.norm(self.t[i] - gt_t[g]))
            R_norm = float(np.linalg.norm(self.R[i] - gt_R[i]))
            self.errors_t.append(t_norm)
            self.errors_R.append(R_norm)

    @staticmethod
    def _std(vals: list[float]) -> float:
        """n-1 standard deviation (OdometryPipeline.cpp:660-672)."""
        if len(vals) < 2:
            return 0.0
        return float(np.std(np.asarray(vals), ddof=1))

    def write_error_file(self, path: str | Path) -> None:
        """Reference error-file format (OdometryPipeline.cpp:285-296),
        with C++ ostream default 6-significant-digit formatting."""

        def fmt(x: float) -> str:
            return f"{x:.6g}"

        lines = [
            f"Runtime: {fmt(self.runtime)}",
            f"R total: {fmt(sum(self.errors_R))}",
            f"R min: {fmt(min(self.errors_R))}",
            f"R max: {fmt(max(self.errors_R))}",
            f"R std: {fmt(self._std(self.errors_R))}",
            f"t total: {fmt(sum(self.errors_t))}",
            f"t min: {fmt(min(self.errors_t))}",
            f"t max: {fmt(max(self.errors_t))}",
            f"t std: {fmt(self._std(self.errors_t))}",
        ]
        Path(path).write_text("\n".join(lines) + "\n")
