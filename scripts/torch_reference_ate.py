"""The JAX package's trajectory error at the configuration of one of
chip_smoke.py's paths (``knn_hd``, ``cont_tri`` or ``main``), run on the
CPU: the yardstick that path's ATE bar on the card is set from.

    JAX_PLATFORMS=cpu python3 scripts/torch_reference_ate.py [--path knn_hd|cont_tri|main]
        [--frames 45] [--seeds 0 1 2]

Writes the synthetic 370x1226 corridor of chip_smoke.py (``KITTI_K``,
density 150, speed 1.0, yaw 0.004, data seed 0), runs ``pmv_tpu``'s
``OdometryPipeline.run()`` on it with each RANSAC seed, and prints one JSON
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
from pmv_tpu.pipeline.odometry import OdometryPipeline  # noqa: E402

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
PATHS = {"knn_hd": KNN_HD, "cont_tri": dict(MAIN, cont_tri=1), "main": MAIN}


def rebased_ate(pipe) -> tuple[float, float]:
    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
    path = np.sum(np.linalg.norm(np.diff(gt[off : off + n], axis=0), axis=1))
    return float(np.sqrt(np.mean(np.sum(rel**2, axis=1)))), float(path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=sorted(PATHS), default="knn_hd")
    ap.add_argument("--frames", type=int, default=45)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    settings = PATHS[args.path]
    out = {"package": "pmv_tpu", "backend": jax.default_backend(), "path": args.path,
           "settings": settings,
           "image": SHAPE, "frames": args.frames, "runs": []}
    with tempfile.TemporaryDirectory(prefix="pmv_ref_") as tmp:
        seq = synthetic.make_sequence(
            n_frames=args.frames, shape=SHAPE, K=synthetic.KITTI_K, density=150.0,
            speed=1.0, yaw_rate=0.004, seed=0,
        )
        paths = synthetic.write_kitti_layout(seq, tmp)
        for seed in args.seeds:
            cfg = VOConfig(
                image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
                poses=paths["poses"], camera=0, frames=args.frames, verbose=0, seed=seed,
                **settings,
            )
            t0 = time.perf_counter()
            pipe = OdometryPipeline(cfg)
            res = pipe.run()
            ate, path = rebased_ate(pipe)
            out["runs"].append({
                "seed": seed, "ate_rebased_m": ate, "path_m": path, "ate_share_of_path": ate / path,
                "frames": res["frames"], "ba_calls": res["ba_calls"],
                "poses_finite": bool(np.isfinite(np.stack(pipe.t)).all()),
                "host_seconds": time.perf_counter() - t0,
            })
            print(json.dumps(out["runs"][-1]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
