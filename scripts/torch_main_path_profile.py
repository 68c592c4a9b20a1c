"""Where the time of the PyTorch/CUDA port's default loop goes, on a GPU.

    python3 scripts/torch_main_path_profile.py [--frames 45] [--repeat 1] [--deterministic]
                                               [--runs-only] [--out profile.json]

Writes the bench corridor (370x1226, the settings of chip_smoke.py's main
path), then runs ``pmv_tpu_torch``'s ``OdometryPipeline`` on it three times
in one process: a cold run (pays CUDA/cuSOLVER/kernel-build start-up), a warm
run (the ms/frame to quote; ``--repeat N`` makes N of them, for the spread of
ms/frame and of the trajectory error from run to run), a run with the stages
timed, and a run under ``torch.profiler`` whose per-operator totals give the
device-busy share, the costliest operators, and the device time of the
hand-written kernels and of the edge-padding kernel by name (``tracker``:
what the LK tracker's kernels cost on the device per tracked frame).
``--deterministic`` sets ``torch.use_deterministic_algorithms(True)`` for
the whole process (operators that sum with atomics take their ordered
variants), to tell whether runs of one seed differ because of such operators;
``--runs-only`` stops after the cold and warm runs.
Prints one JSON object and, with ``--out``, also writes it to that file. Needs a CUDA device.
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

from pmv_tpu_torch.cli import rebased_ate  # noqa: E402
from pmv_tpu_torch.config import VOConfig  # noqa: E402
from pmv_tpu_torch.io import synthetic  # noqa: E402
from pmv_tpu_torch.pipeline import fused  # noqa: E402
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline  # noqa: E402

SHAPE = (370, 1226)
# Device entries of the trace that belong to the tracker: the hand-written
# kernels of csrc/ and PyTorch's replication-pad kernel (edge padding of a
# level before a capture).
TRACKER_KERNELS = ("capture_kernel", "lk_template_kernel", "lk_iterate_kernel",
                   "replication_pad")


def make_cfg(paths: dict, frames: int) -> VOConfig:
    return VOConfig(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], camera=0, frames=frames, init_frames=5,
        min_tracked_features=400, tracked_features_tol=150, bundle_size=5,
        max_iterations=5, feature_capacity=512, map_capacity=8192, verbose=0, seed=0,
    )


def run_once(cfg: VOConfig) -> dict:
    pipe = OdometryPipeline(cfg, device="cuda")
    res = pipe.run()
    torch.cuda.synchronize()
    n = max(len(pipe.frame_stats), 1)
    return {
        "tracked_frames": n, "runtime_s": res["runtime"],
        "ms_per_frame": res["runtime"] / n * 1e3, "ba_calls": res["ba_calls"],
        "pnp_frames": sum(s["used_pnp"] for s in pipe.frame_stats),
        "bootstrap_frames": sum(not s["used_pnp"] for s in pipe.frame_stats),
        "reseed_frames": sum(s["reseed"] for s in pipe.frame_stats),
        "ate_rebased_m": rebased_ate(pipe),
        # equal sums mean the same trajectory bit for bit
        "t_checksum": float(np.stack(pipe.t).astype(np.float64).sum()),
    }


def stage_times(cfg: VOConfig) -> dict:
    """Synchronised wall time of frame_step by branch, and of ba_step."""
    acc: dict[str, list[float]] = {"frame_pnp": [], "frame_bootstrap": [], "ba_step": []}
    orig_frame, orig_ba = fused.frame_step, fused.ba_step

    def timed_frame(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_frame(*a, **k)
        torch.cuda.synchronize()
        key = "frame_pnp" if out[2]["used_pnp"] else "frame_bootstrap"
        acc[key].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_ba(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_ba(*a, **k)
        torch.cuda.synchronize()
        acc["ba_step"].append((time.perf_counter() - t0) * 1e3)
        return out

    fused.frame_step, fused.ba_step = timed_frame, timed_ba
    try:
        run_once(cfg)
    finally:
        fused.frame_step, fused.ba_step = orig_frame, orig_ba
    return {
        k: {"calls": len(v), "mean_ms": sum(v) / len(v) if v else None,
            "total_ms": sum(v)}
        for k, v in acc.items()
    }


def profiled(cfg: VOConfig, top: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = run_once(cfg)
        wall = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    device_us = sum(dev_us(e) for e in ka)
    by_dev = sorted(ka, key=dev_us, reverse=True)[:top]
    by_cpu = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    tracker = {}
    for name in TRACKER_KERNELS + ("min_eig_kernel",):
        hits = [e for e in ka if name in e.key and not e.key.startswith("aten::")]
        tracker[name] = {"calls": sum(e.count for e in hits),
                         "device_ms": sum(dev_us(e) for e in hits) / 1e3}
    tracker["per_frame_ms"] = sum(
        tracker[k]["device_ms"] for k in TRACKER_KERNELS) / r["tracked_frames"]
    return {
        "run": r, "wall_s": wall, "device_busy_s": device_us / 1e6, "tracker": tracker,
        "device_idle_share": 1.0 - device_us / 1e6 / r["runtime_s"] if device_us else None,
        "n_op_calls": sum(e.count for e in ka),
        "top_device": [{"name": e.key[:80], "calls": e.count, "device_ms": dev_us(e) / 1e3} for e in by_dev],
        "top_cpu": [{"name": e.key[:80], "calls": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in by_cpu],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=45)
    ap.add_argument("--repeat", type=int, default=1, help="number of warm runs")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True) for all runs")
    ap.add_argument("--runs-only", action="store_true", help="cold and warm runs only")
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="pmv_profile_") as tmp:
        seq = synthetic.make_sequence(
            n_frames=args.frames, shape=SHAPE, K=synthetic.KITTI_K, density=150.0,
            speed=1.0, yaw_rate=0.004, seed=0,
        )
        cfg = make_cfg(synthetic.write_kitti_layout(seq, tmp), args.frames)
        out = {"card": smi, "torch": torch.__version__, "frames": args.frames,
               "deterministic": args.deterministic}
        out["cold"] = run_once(cfg)
        out["warm_runs"] = [run_once(cfg) for _ in range(max(1, args.repeat))]
        out["warm"] = out["warm_runs"][0]
        if not args.runs_only:
            out["stages_warm"] = stage_times(cfg)
            out["profiled"] = profiled(cfg, args.top)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
