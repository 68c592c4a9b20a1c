"""The port's offline refinement end to end: ``run()`` of the default loop on
the synthetic 370x1226 corridor, then ``global_refine.global_bundle_adjust``
(alternate mode) on the finished run, with the rebased ATE before and after
and the refinement's wall seconds.

    python3 scripts/torch_global_refine.py [--frames 598] [--seed 1]
        [--window 16] [--overlap 4] [--iters 8] [--device cuda]
        [--mesh DPxLM [--backend nccl|gloo]] [--out FILE]

``--mesh DPxLM`` refines on a (dp, lm) mesh of dp*lm ranks started by
``parallel.mesh.launch`` on this host (windows over dp, landmark shards over
lm; the finished run reaches the ranks as an npz file), and reports rank 0's
result, with whether every rank's was the same. The backend defaults to
NCCL on the GPU and gloo on the CPU; NCCL refuses two ranks on one card, so
several ranks on one card need ``--backend gloo``. Without ``--mesh`` the
refinement runs on one device in this process.

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

from pmv_tpu_torch import cli, convert, resolve_device  # noqa: E402
from pmv_tpu_torch.config import VOConfig  # noqa: E402
from pmv_tpu_torch.io import synthetic  # noqa: E402
from pmv_tpu_torch.parallel import global_refine  # noqa: E402
from pmv_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
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


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def refine_rank(rank: int, dims: tuple, run_npz: str, device_type: str, refine: dict) -> dict:
    """One rank of ``--mesh``: the finished run onto this rank's device, its
    refinement on the mesh; returns the poses and the refinement's seconds."""
    m = mesh_lib.make_mesh(*dims, device_type=device_type)
    with np.load(run_npz) as z:
        run = convert.run_from_reference(dict(z), m.device)
    sync(m.device)
    t0 = time.perf_counter()
    R, t = global_refine.global_bundle_adjust(run, m, **refine)
    sync(m.device)
    return {"R": np.stack(R), "t": np.stack(t), "seconds": time.perf_counter() - t0,
            "backend": m.backend, "device": str(m.device)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=598)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--overlap", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device; default: cuda (an error without a GPU)")
    ap.add_argument("--mesh", default=None, help="DPxLM: refine on a mesh of DP*LM ranks of this host")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the mesh's backend; default: nccl on the GPU, gloo on the CPU")
    ap.add_argument("--out", default=None, help="append the JSON record to this JSON list")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    dims = tuple(int(x) for x in args.mesh.lower().split("x")) if args.mesh else None
    if dims is not None and len(dims) != 2:
        ap.error("--mesh takes DPxLM, e.g. 2x2")
    if args.backend and dims is None:
        ap.error("--backend needs --mesh")
    backend = (args.backend or mesh_lib.default_backend(dev.type)) if dims else None
    refine = dict(window=args.window, overlap=args.overlap, iters=args.iters)

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

        ranks_equal = None
        if dims is None:
            sync(dev)
            t0 = time.perf_counter()
            global_refine.global_bundle_adjust(pipe, None, device=dev, **refine)
            sync(dev)
            wall_refine = time.perf_counter() - t0
            wall_launch = None
        else:
            run_npz = str(Path(tmp) / "run.npz")
            np.savez(run_npz, **convert.run_to_numpy(pipe))
            t0 = time.perf_counter()
            res = mesh_lib.launch(refine_rank, dims[0] * dims[1], backend=backend, device_type=dev.type,
                                  args=(dims, run_npz, dev.type, refine))
            wall_launch = time.perf_counter() - t0
            ranks_equal = all(np.array_equal(r["R"], res[0]["R"]) and np.array_equal(r["t"], res[0]["t"])
                              for r in res)
            pipe.R, pipe.t = list(res[0]["R"]), list(res[0]["t"])
            wall_refine = res[0]["seconds"]
        ate_after = cli.rebased_ate(pipe)

    rec = {
        "package": "pmv_tpu_torch", "device": str(dev), "card": card(),
        "frames": result["frames"], "seed": args.seed, "config": "chip_smoke.MAIN_CFG",
        "window": args.window, "overlap": args.overlap, "iters": args.iters,
        "mesh": list(dims) if dims else None, "backend": backend, "ranks_bit_equal": ranks_equal,
        "windows": len(global_refine.window_ranges(result["frames"], args.window, args.overlap)),
        "ate_before_m": ate_before, "ate_after_m": ate_after,
        "poses_finite": bool(np.isfinite(np.stack(pipe.t)).all()),
        "wall_run_s": wall_run, "wall_refine_s": wall_refine, "wall_launch_s": wall_launch,
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
