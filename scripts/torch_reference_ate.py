"""The JAX package's trajectory error at the configuration of one of
chip_smoke.py's paths (``knn_hd``, ``knn_good``, ``cont_tri``,
``segmented``, ``main`` or ``parity``), run on the CPU: the yardstick that
path's ATE bar on the card is set from.

    JAX_PLATFORMS=cpu python3 scripts/torch_reference_ate.py
        [--path knn_hd|knn_good|cont_tri|segmented|main|parity]
        [--family corridor|photo|stopgo] [--frames N] [--seeds 0 1 2]

``parity`` is the strict-parity configuration of the accuracy sweep
(``pmv_tpu_torch.parity_sweep.PARITY``: LK window 32, PnP 8 px, essential
1 px, reseed coupled at ``tracked_features_tol``) at 512 feature and 8192
map slots; ``main`` is also the sweep's tuned configuration. ``--family``
renders the sweep's scene family (``photo``: sensor noise, exposure drift
and vignetting; ``stopgo``: a near stop every 80 frames) in place of the
clean corridor; on ``stopgo`` each run also reports the motion gate's
rejections, the bootstrap frames inside a stop and the estimated step of
every frame of a stop beside the ground truth's. ``--diag DIR`` also dumps
each run as scripts/diag_seed.py does (for ``python3 -m pmv_tpu_torch.diag
analyze``).

``--frames`` defaults to the path's frames in chip_smoke.py (20 for
``knn_good``, 100 on ``stopgo``, 45 for the others). ``segmented`` runs ``pmv_tpu``'s
``SegmentedPipeline`` with 4 segments at the main configuration; the other
paths run ``OdometryPipeline.run()`` and also count the frames that took the
PnP branch and the bootstrap. ``--refine`` also refines each finished run with
``global_refine.global_bundle_adjust`` (one-device mesh, window 8, overlap 4,
8 iterations) in the two forms of chip_smoke.py's ``refine`` phase: the run
as it is, and the run with tests/test_parallel_flow.py's drift injected.

Writes the synthetic 370x1226 corridor of chip_smoke.py (``KITTI_K``,
density 150, speed 1.0, yaw 0.004, data seed 0), runs the JAX package's
pipeline on it with each RANSAC seed, and prints one JSON
line per seed (rebased ATE: RMSE of positions rebased at the init frame;
the ground-truth path length over the tracked frames; its share of the
path; frames, BA calls) and one JSON object with all of them. Imports
``pmv_tpu`` only, never the port; needs JAX and no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from pmv_tpu.config import VOConfig  # noqa: E402
from pmv_tpu.io import synthetic  # noqa: E402
from pmv_tpu.pipeline import fused  # noqa: E402
from pmv_tpu.pipeline.odometry import OdometryPipeline  # noqa: E402
from pmv_tpu.pipeline.segmented import SegmentedPipeline  # noqa: E402

SHAPE = (370, 1226)
# BASELINE.json config #3 with the preset of artifacts/stage/bench_knn_hd_r5.json
# (PERFORMANCE.md, config #3), as VOConfig keywords: chip_smoke.py's HD_CFG
KNN_HD = dict(
    init_frames=5, matcher="knn", extractor="fast", feature_capacity=2048,
    map_capacity=8192, min_tracked_features=2000, reseed_tol=400,
    tracked_features_tol=150, bundle_size=5, max_iterations=5,
    ba_lm_cap=2048, ba_cadence=2,
)
# chip_smoke.py's MAIN_CFG (bench.py's default loop), and it with continuous
# triangulation on: its CONT_TRI_CFG
MAIN = dict(
    init_frames=5, min_tracked_features=400, tracked_features_tol=150,
    bundle_size=5, max_iterations=5, feature_capacity=512, map_capacity=8192,
)
# The accuracy sweep's strict-parity overrides (scripts/parity_sweep.py's
# PARITY) at the sweep's slot counts: chip_smoke.py's PARITY_CFG
PARITY = dict(
    lk_window=32, ransac_pnp_thresh=8.0, ransac_e_thresh=1.0, reseed_tol=0, bundle_size=5,
    max_iterations=5, min_tracked_features=400, tracked_features_tol=150, init_frames=5,
    feature_capacity=512, map_capacity=8192,
)
PATHS = {"knn_hd": KNN_HD, "knn_good": dict(MAIN, matcher="knn"),
         "cont_tri": dict(MAIN, cont_tri=1), "segmented": MAIN, "main": MAIN, "parity": PARITY}
# The sweep's scene families (scripts/parity_sweep.py's FAMILY_KW)
FAMILY_KW = {
    "corridor": {},
    "photo": dict(noise_std=4.0, exposure_drift=0.25, vignette=0.3),
    "stopgo": dict(stop_every=80, stop_len=10),
}
# chip_smoke.py's PATH_FRAMES (knn_good) and its default --frames
FRAMES = {"knn_good": 20}
# chip_smoke.py's frames of the stop-go run: past the first stop (80-89)
STOPGO_FRAMES = 100
SEGMENTS = 4  # chip_smoke.py's segmented phase


class FrameKinds:
    """While active, every ``fused.chunk_step`` of ``OdometryPipeline.run``
    also hands its per-frame stats (tracked, n3d, used_pnp, inliers,
    accepted) to ``stats`` (read back after the run)."""

    KEYS = ("tracked", "n3d", "used_pnp", "inliers", "accepted")

    def __enter__(self):
        self.stats = []
        self.orig = fused.chunk_step

        def recording(*args, **kw):
            state, stats = self.orig(*args, **kw)
            self.stats.append([stats[k] for k in self.KEYS])
            return state, stats

        fused.chunk_step = recording
        return self

    def __exit__(self, *exc):
        fused.chunk_step = self.orig

    def table(self) -> np.ndarray:
        """(tracked frames, 5) int32: scripts/diag_seed.py's ``stats``."""
        if not self.stats:
            return np.zeros((0, 5), np.int32)
        return np.concatenate([np.stack([np.asarray(v, np.int64) for v in chunk], 1)
                               for chunk in self.stats]).astype(np.int32)

    def flags(self) -> tuple[np.ndarray, np.ndarray]:
        """Per tracked frame: used_pnp, accepted."""
        t = self.table()
        return t[:, 2].astype(bool), t[:, 4].astype(bool)

    def counts(self) -> dict:
        used, accepted = self.flags()
        return {"pnp_frames": int(used.sum()), "bootstrap_frames": int((~used).sum()),
                "gate_rejections": int((~accepted).sum())}


def write_diag(pipe, stats: np.ndarray, path: Path) -> None:
    """The run as scripts/diag_seed.py dumps one (``stats``, ``err``,
    ``t_est``, ``gt``, ``off``), for ``python3 -m pmv_tpu_torch.diag analyze``."""
    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    err = np.linalg.norm((t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off]), axis=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, stats=stats, err=err, t_est=t_est, gt=gt, off=off)


def stop_report(pipe, used_pnp: np.ndarray, accepted: np.ndarray, stop_every: int,
                stop_len: int) -> dict:
    """What a stop-go run did in its stops (chip_smoke.py's ``stop_report``):
    the transitions from frame f to f + 1 with f in a stop (f in [s, s +
    stop_len) for s = stop_every, 2 stop_every + stop_len, ...; the ground
    truth creeps 0.02 m a frame there), each with the estimated step (pose
    i - 1 to pose i, i = f - init_offset + 1), the ground truth's, whether it
    was a bootstrap frame and whether the gate rejected it."""
    off, n = pipe.init_offset, len(pipe.t)
    t = np.stack(pipe.t)
    gt = pipe.gt_t
    rows = []
    s = stop_every
    while s < off + n:
        for f in range(s, s + stop_len):
            i = f - off + 1
            if 1 <= i < n:
                rows.append({"frame": f, "step_m": float(np.linalg.norm(t[i] - t[i - 1])),
                             "gt_step_m": float(np.linalg.norm(gt[f + 1] - gt[f])),
                             "bootstrap": bool(not used_pnp[i - 1]),
                             "gate_rejected": bool(not accepted[i - 1])})
        s += stop_every + stop_len
    errs = [abs(r["step_m"] - r["gt_step_m"]) for r in rows]
    return {"stop_frames": len(rows),
            "stop_bootstrap_frames": [r["frame"] for r in rows if r["bootstrap"]],
            "stop_gate_rejections": [r["frame"] for r in rows if r["gate_rejected"]],
            "stop_step_m": [r["step_m"] for r in rows],
            "stop_step_err_max_m": max(errs) if errs else None}


def rebased_ate(pipe) -> tuple[float, float]:
    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
    path = np.sum(np.linalg.norm(np.diff(gt[off : off + n], axis=0), axis=1))
    return float(np.sqrt(np.mean(np.sum(rel**2, axis=1)))), float(path)


def mean_err(ts, ref) -> float:
    return float(np.mean([np.linalg.norm(np.asarray(ts[i]) - ref[i]) for i in range(1, len(ts))]))


def inject_drift(pipe, sigma_t=0.3, sigma_r=0.01, seed=7) -> None:
    """tests/test_parallel_flow.py's drift injection."""
    rng = np.random.default_rng(seed)
    for i in range(2, len(pipe.t)):
        pipe.t[i] = pipe.t[i] + rng.normal(0, sigma_t, 3)
        w = rng.normal(0, sigma_r, 3)
        th = np.linalg.norm(w)
        k = w / (th + 1e-12)
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        pipe.R[i] = (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx) @ pipe.R[i]


def refine_forms(pipe) -> dict:
    """Rebased ATE before and after the refinement, of the run as it is
    (``clean``) and with the drift injected (``drifted``), and the drift's
    own size (mean distance from the run's positions), with chip_smoke.py's
    bars: clean after < 1.1 before + 0.02 m; drifted: ATE lower and the
    injected noise at least halved. ``*_gt_mean_m``: tests/test_parallel_
    flow.py's metric, the mean distance to ground truth without rebasing."""
    from pmv_tpu.parallel import global_refine, mesh

    one = mesh.make_mesh(dp=1, lm=1, devices=jax.devices()[:1])
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    gt_ref = [gt[i + pipe.init_offset] for i in range(len(pipe.t))]
    R0, t0 = list(pipe.R), list(pipe.t)
    out = {}
    for form in ("clean", "drifted"):
        pipe.R, pipe.t = list(R0), list(t0)
        if form == "drifted":
            inject_drift(pipe)
        before = (rebased_ate(pipe)[0], mean_err(pipe.t, gt_ref), mean_err(pipe.t, t0))
        global_refine.global_bundle_adjust(pipe, one, window=8, overlap=4, iters=8)
        after = (rebased_ate(pipe)[0], mean_err(pipe.t, gt_ref), mean_err(pipe.t, t0))
        out[f"{form}_ate_m"] = [before[0], after[0]]
        out[f"{form}_gt_mean_m"] = [before[1], after[1]]
        if form == "drifted":
            out["drifted_noise_m"] = [before[2], after[2]]
    pipe.R, pipe.t = R0, t0
    a, n = out["drifted_ate_m"], out["drifted_noise_m"]
    out["clean_kept"] = out["clean_ate_m"][1] < 1.1 * out["clean_ate_m"][0] + 0.02
    out["drifted_pulled_back"] = a[1] < a[0] and n[1] < n[0] / 2
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=sorted(PATHS), default="knn_hd")
    ap.add_argument("--family", choices=sorted(FAMILY_KW), default="corridor")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--refine", action="store_true", help="also refine each run (not segmented)")
    ap.add_argument("--diag", default=None, metavar="DIR",
                    help="also dump each run as scripts/diag_seed.py does, to DIR/diag_seed<S>[_<family>].npz")
    args = ap.parse_args()

    settings = PATHS[args.path]
    if args.frames is None:
        args.frames = STOPGO_FRAMES if args.family == "stopgo" else FRAMES.get(args.path, 45)
    family = FAMILY_KW[args.family]
    out = {"package": "pmv_tpu", "backend": jax.default_backend(), "path": args.path,
           "family": args.family, "settings": settings,
           "image": SHAPE, "frames": args.frames, "runs": []}
    with tempfile.TemporaryDirectory(prefix="pmv_ref_") as tmp:
        seq = synthetic.make_sequence(
            n_frames=args.frames, shape=SHAPE, K=synthetic.KITTI_K, density=150.0,
            speed=1.0, yaw_rate=0.004, seed=0, **family,
        )
        paths = synthetic.write_kitti_layout(seq, tmp)
        for seed in args.seeds:
            cfg = VOConfig(
                image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
                poses=paths["poses"], camera=0, frames=args.frames, verbose=0, seed=seed,
                **settings,
            )
            t0 = time.perf_counter()
            kinds = {}
            if args.path == "segmented":
                pipe = SegmentedPipeline(cfg, segments=SEGMENTS)
                res = pipe.run()
            else:
                pipe = OdometryPipeline(cfg)
                with FrameKinds() as rec:
                    res = pipe.run()
                kinds = rec.counts()
                if args.diag:
                    suffix = "" if args.family == "corridor" else f"_{args.family}"
                    write_diag(pipe, rec.table(), Path(args.diag) / f"diag_seed{seed}{suffix}.npz")
                if "stop_every" in family:
                    kinds.update(stop_report(pipe, *rec.flags(), family["stop_every"],
                                             family["stop_len"]))
            ate, path = rebased_ate(pipe)
            out["runs"].append({
                "seed": seed, "ate_rebased_m": ate, "path_m": path, "ate_share_of_path": ate / path,
                "frames": res["frames"], "ba_calls": res["ba_calls"], "t_total": res["t_total"],
                "R_total": res["R_total"], **kinds,
                "poses_finite": bool(np.isfinite(np.stack(pipe.t)).all()),
                "host_seconds": time.perf_counter() - t0,
            })
            if args.refine and args.path != "segmented":
                out["runs"][-1]["refine"] = refine_forms(pipe)
            print(json.dumps(out["runs"][-1]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
