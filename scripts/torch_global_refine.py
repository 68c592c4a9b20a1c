"""The port's offline refinement end to end: ``run()`` of the default loop on
the synthetic 370x1226 corridor, then ``global_refine.global_bundle_adjust``
(one device, alternate mode) on the finished run, with the rebased ATE
before and after and the refinement's wall seconds.

    python3 scripts/torch_global_refine.py [--frames 598] [--seed 1]
        [--window 16] [--overlap 4] [--iters 8] [--device cuda] [--out FILE]

The counterpart of scripts/global_refine_598.py (the JAX package on a
virtual CPU mesh), at its defaults: 598 frames, RANSAC seed 1, windows of 16
with an overlap of 4, 8 LM iterations, bench.py's default loop
(``chip_smoke.MAIN_CFG``). ``--device`` defaults to the GPU and fails
without one. Prints one JSON line (with the card's name and power limit
from ``nvidia-smi`` on a GPU) and, with ``--out``, appends it to that JSON
list. The corridor is written to a temporary directory and removed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pmv_tpu_torch import cli, resolve_device  # noqa: E402
from pmv_tpu_torch.config import VOConfig  # noqa: E402
from pmv_tpu_torch.io import synthetic  # noqa: E402
from pmv_tpu_torch.parallel import global_refine  # noqa: E402
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline  # noqa: E402

SHAPE = (370, 1226)
# chip_smoke.py's MAIN_CFG (bench.py's default loop)
MAIN = dict(
    camera=0, init_frames=5, min_tracked_features=400, tracked_features_tol=150,
    bundle_size=5, max_iterations=5, feature_capacity=512, map_capacity=8192, verbose=0,
)


def card() -> str | None:
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=598)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--overlap", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device; default: cuda (an error without a GPU)")
    ap.add_argument("--out", default=None, help="append the JSON record to this JSON list")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory(prefix="pmv_refine_") as tmp:
        seq = synthetic.make_sequence(
            n_frames=args.frames, shape=SHAPE, K=synthetic.KITTI_K, density=150.0,
            speed=1.0, yaw_rate=0.004, seed=0,
        )
        paths = synthetic.write_kitti_layout(seq, tmp)
        cfg = VOConfig(
            image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
            poses=paths["poses"], frames=args.frames, seed=args.seed,
            traj_cap=max(2048, args.frames + 2), **MAIN,
        )
        pipe = OdometryPipeline(cfg, device=dev)
        t0 = time.perf_counter()
        result = pipe.run()
        wall_run = time.perf_counter() - t0
        ate_before = cli.rebased_ate(pipe)
        print(f"run: {result['frames']} poses in {wall_run:.1f} s, ATE {ate_before:.4f} m", flush=True)

        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        global_refine.global_bundle_adjust(pipe, None, window=args.window, overlap=args.overlap,
                                           iters=args.iters, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall_refine = time.perf_counter() - t0
        ate_after = cli.rebased_ate(pipe)

    rec = {
        "package": "pmv_tpu_torch", "device": str(dev), "card": card(),
        "frames": result["frames"], "seed": args.seed, "config": "chip_smoke.MAIN_CFG",
        "window": args.window, "overlap": args.overlap, "iters": args.iters,
        "windows": len(global_refine.window_ranges(result["frames"], args.window, args.overlap)),
        "ate_before_m": ate_before, "ate_after_m": ate_after,
        "poses_finite": bool(np.isfinite(np.stack(pipe.t)).all()),
        "wall_run_s": wall_run, "wall_refine_s": wall_refine,
    }
    print(json.dumps(rec), flush=True)
    if args.out:
        out = Path(args.out)
        existing = json.loads(out.read_text()) if out.exists() else []
        existing.append(rec)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(existing, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
