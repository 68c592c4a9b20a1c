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

Heavy compute runs on ``device`` (pmv_tpu_torch.pipeline.fused); the host
loop decodes, uploads chunks of uint8 frames and keeps the books.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from pmv_tpu_torch import resolve_device
from pmv_tpu_torch.config import OdometryPipelineException, VOConfig
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend import corners
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.io import kitti
from pmv_tpu_torch.io.prefetch import FramePrefetcher
from pmv_tpu_torch.pipeline import fused


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
        self.frame_stats: list[dict] = []  # per tracked frame, filled by run()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _log(self, *args):
        if self.cfg.verbose:
            print(*args, flush=True)

    def _n_tiles(self, shape) -> int:
        H, W = shape
        return math.ceil(H / self.cfg.grid_rows) * math.ceil(W / self.cfg.grid_cols)

    def _check_ported(self) -> None:
        """Options of the JAX package that this port does not carry yet are
        refused, never ignored."""
        cfg = self.cfg
        unported = {
            "video_path": bool(cfg.video_path),
            "fancy_video": bool(cfg.fancy_video),
            "checkpoint_path": bool(cfg.checkpoint_path),
            "resume": bool(cfg.resume),
            "live_every": cfg.live_every > 0,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: video rendering, checkpoint/resume and the "
                "live map are not ported yet (viz/, utils/checkpoint.py)"
            )

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
        n_tiles = self._n_tiles(img_shape)
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
            map_hist_rows=0,
        )

    def _upload(self, frames: list[np.ndarray]) -> torch.Tensor:
        """One chunk of frames to the device as uint8 (4x less transfer than
        float32), from pinned memory where the device is a GPU."""
        host = torch.from_numpy(np.stack(frames).astype(np.uint8))
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    @torch.no_grad()
    def run(self) -> dict:
        """Main loop: chunks of frames through ``fused.chunk_step`` with async
        host-side frame prefetch — the analogue of the reference's two-thread
        pipeline — and one final readback."""
        cfg = self.cfg
        self._check_ported()
        init_paths = self.file_names[: cfg.init_frames]
        init_imgs = [img for _, img in FramePrefetcher(init_paths)]
        self.initialise(init_imgs)
        self._seed_trajectory()

        img0 = init_imgs[self.init_offset]
        step_cfg = self._step_config(img0.shape)
        fused.check_ported(step_cfg)
        start = self.init_offset + 1
        stop = min(cfg.frames, len(self.file_names))
        img0_dev = torch.as_tensor(img0, dtype=torch.float32).to(self.device)
        state = fused.init_state(
            pyr=build_pyramid(img0_dev, cfg.lk_levels),
            table=self.tables[0],
            map_state=self.map,
            cfg=step_cfg,
        )
        k_last = 0

        t_start = time.perf_counter()
        C = max(1, cfg.chunk_frames)
        buf_img: list[np.ndarray] = []
        buf_gt: list[float] = []
        stats_all: list[dict] = []

        def flush(state):
            imgs = self._upload(buf_img)
            state, stats = fused.chunk_step(
                state, imgs, list(buf_gt), self._gen, self.K, step_cfg
            )
            stats_all.extend(stats)
            buf_img.clear()
            buf_gt.clear()
            return state

        for _, img in FramePrefetcher(self.file_names[start:stop]):
            k = k_last + 1
            g = k - 1 + self.init_offset
            if g + 1 >= len(self.gt_t):
                break
            buf_img.append(img)
            buf_gt.append(float(np.linalg.norm(self.gt_t[g + 1] - self.gt_t[g])))
            k_last = k
            if len(buf_img) == C:
                state = flush(state)
        if buf_img:
            state = flush(state)
        # Exact BA-call count of the loop: chunk_step fires BA after frame k
        # at j = k_new - 1, i.e. j ranges over [1, k_last).
        cadence = fused.ba_cadence(step_cfg)
        self._ba_calls = sum(1 for j in range(1, k_last) if j % cadence == 0)
        # One readback for the whole run.
        self.map = state.map
        R_hist = state.R_hist.cpu().numpy()
        t_hist = state.t_hist.cpu().numpy()
        self.runtime = time.perf_counter() - t_start
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
        n_overflow = int(state.ba_overflow)
        if n_overflow:
            # Saturated windows silently drop observations — a biased BA.
            print(
                f"pmv_tpu_torch: {n_overflow} BA windows saturated ba_lm_cap — "
                "raise ba_lm_cap (observations were dropped; heading drift risk)",
                flush=True,
            )
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
