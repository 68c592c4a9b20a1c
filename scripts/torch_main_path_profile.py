"""Where the time of the PyTorch/CUDA port's default loop goes, on a GPU.

    python3 scripts/torch_main_path_profile.py [--frames 45] [--repeat 1] [--deterministic]
                                               [--runs-only] [--plain-tracker]
                                               [--path main|knn_hd|knn_good|modular]
                                               [--set KEY=VALUE ...] [--python-decoder]
                                               [--decode] [--out profile.json]

Writes chip_smoke.py's corridor (370x1226) and takes the settings of one of
its paths from it (the main path unless ``--path`` says otherwise), then runs ``pmv_tpu_torch``'s ``OdometryPipeline`` on it three times
in one process: a cold run (pays CUDA/cuSOLVER/kernel-build start-up), a warm
run (the ms/frame to quote; ``--repeat N`` makes N of them, for the spread of
ms/frame and of the trajectory error from run to run), a run with the stages
timed, and a run under ``torch.profiler`` whose per-operator totals give the
device-busy share, the costliest operators, and the device time of the
hand-written kernels and of the edge-padding kernel by name (``tracker``:
what the LK tracker's kernels cost on the device per tracked frame, and how
many operators ``track_cached`` dispatches per tracked frame).
``--deterministic`` sets ``torch.use_deterministic_algorithms(True)`` for
the whole process (operators that sum with atomics take their ordered
variants), to tell whether runs of one seed differ because of such operators;
``--runs-only`` stops after the cold and warm runs. ``--plain-tracker`` adds
two runs in which every tracked level goes through ``lk_track_level_plain``
on the card in place of the kernel (``plain_tracker_runs``): what the
trajectory and its error are when only the order of the kernel's sums
differs.
``--path`` picks the configuration of one of chip_smoke.py's paths
(default ``main``): ``knn_hd`` (FAST+kNN, 2048 slots, the preset of
artifacts/stage/bench_knn_hd_r5.json), ``knn_good`` (kNN with the default
extractor) or ``modular`` (``run_modular()`` at the main configuration);
``stages_warm`` then also times the stages inside the step (candidate
extraction, kNN association, tracker, RANSAC solvers, pose recovery, BA),
each call synchronised, so that a stage's total includes the stages it
calls.
``--set KEY=VALUE`` (repeatable) overrides a ``VOConfig`` key of the path
(``--set map_hist=0``: no landmark snapshots); ``--python-decoder`` decodes
the frames with the pure-Python codec in place of the native decoder;
``--decode`` also times both decoders on the corridor's frames, on the host
(``decode_ms_per_frame``). Every run reports its peak device memory.
Prints one JSON object and, with ``--out``, also writes it to that file. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import HD_CFG, KNN_GOOD_CFG, MAIN_CFG, vo_config, write_corridor  # noqa: E402
from pmv_tpu_torch.cli import rebased_ate  # noqa: E402
from pmv_tpu_torch.config import VOConfig  # noqa: E402
from pmv_tpu_torch.frontend import corners, knn_matcher, lk_kernels, lucas_kanade  # noqa: E402
from pmv_tpu_torch.io import kitti, native, png, prefetch  # noqa: E402
from pmv_tpu_torch.pipeline import fused, steps  # noqa: E402
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline  # noqa: E402
from pmv_tpu_torch.solvers import essential, pnp  # noqa: E402

# Device entries of the trace that belong to the tracker: the hand-written
# kernels of csrc/ and PyTorch's replication-pad kernel (edge padding of a
# level before a capture). ``lk_template_kernel`` and ``lk_iterate_kernel``
# were the level kernel's two halves in earlier commits: a parent tree that
# is profiled by this script (scripts/torch_parent_vs_change.sh) has them in
# its place, and a tree without them counts no call of them.
TRACKER_KERNELS = ("capture_kernel", "lk_level_kernel", "lk_template_kernel",
                   "lk_iterate_kernel", "replication_pad")
TRACK_RANGE = "tracker::track_cached"  # profiler range around lucas_kanade.track_cached


# chip_smoke.py's paths: their VOConfig settings, and whether the path is
# the modular loop
PATHS = {
    "main": (MAIN_CFG, False),
    "knn_hd": (HD_CFG, False),
    "knn_good": (KNN_GOOD_CFG, False),
    "modular": (MAIN_CFG, True),
}
MODULAR = False  # set from --path


def run_once(cfg: VOConfig) -> dict:
    pipe = OdometryPipeline(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    res = pipe.run_modular() if MODULAR else pipe.run()
    torch.cuda.synchronize()
    n = max(len(pipe.frame_stats), 1)
    return {
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "tracked_frames": n, "runtime_s": res["runtime"],
        "ms_per_frame": res["runtime"] / n * 1e3, "ba_calls": res["ba_calls"],
        "pnp_frames": sum(s["used_pnp"] for s in pipe.frame_stats),
        "bootstrap_frames": sum(not s["used_pnp"] for s in pipe.frame_stats),
        "reseed_frames": sum(s["reseed"] for s in pipe.frame_stats),
        "ate_rebased_m": rebased_ate(pipe),
        # equal sums mean the same trajectory bit for bit
        "t_checksum": float(np.stack(pipe.t).astype(np.float64).sum()),
    }


def plain_tracker_runs(cfg: VOConfig, n: int) -> list[dict]:
    """Runs whose tracked levels are computed by the plain version."""
    orig = lucas_kanade._track_level_cached

    def plain_level(blk, br0, bc0, next_img, pts_level, guess, win, iters, search):
        g, me, ok, region, r0, c0 = lk_kernels.lk_track_level_plain(
            blk, br0, bc0, next_img, pts_level, guess, win, search, iters)
        return g, me, ok, (region, r0, c0)

    lucas_kanade._track_level_cached = plain_level
    try:
        return [run_once(cfg) for _ in range(n)]
    finally:
        lucas_kanade._track_level_cached = orig


# Stages timed inside the step: (name, owner, attribute), called through
# the owner's attribute by the loops
INNER_STAGES = [
    ("grid_extract", corners, "grid_extract"),
    ("knn_match", knn_matcher, "knn_match"),
    ("track_step_cached", steps, "track_step_cached"),
    ("track_step", steps, "track_step"),
    ("reseed_step", steps, "reseed_step"),
    ("solve_pnp_ransac", pnp, "solve_pnp_ransac"),
    ("find_essential_5pt_ransac", fused, "find_essential_5pt_ransac"),
    ("find_essential_ransac", essential, "find_essential_ransac"),
    ("recover_pose", essential, "recover_pose"),
    ("add_frame", OdometryPipeline, "add_frame"),
    ("estimate_pose", OdometryPipeline, "estimate_pose"),
    ("bundle_adjust", OdometryPipeline, "bundle_adjust"),
]


def stage_times(cfg: VOConfig) -> dict:
    """Synchronised wall time of frame_step by branch, of ba_step, and of
    the stages inside them (``INNER_STAGES``)."""
    acc: dict[str, list[float]] = {"frame_pnp": [], "frame_bootstrap": [], "ba_step": []}
    acc.update({name: [] for name, _, _ in INNER_STAGES})
    orig_frame, orig_ba = fused.frame_step, fused.ba_step
    if MODULAR:  # the modular loop runs find_essential_5pt_ransac from odometry's namespace
        from pmv_tpu_torch.pipeline import odometry
        stages = INNER_STAGES + [("find_essential_5pt_ransac", odometry, "find_essential_5pt_ransac")]
    else:
        stages = INNER_STAGES
    originals = [(owner, attr, getattr(owner, attr)) for _, owner, attr in stages]

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def timed_frame(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_frame(*a, **k)
        torch.cuda.synchronize()
        key = "frame_pnp" if out[2]["used_pnp"] else "frame_bootstrap"
        acc[key].append((time.perf_counter() - t0) * 1e3)
        return out

    fused.frame_step, fused.ba_step = timed_frame, timed("ba_step", orig_ba)
    for (name, owner, attr), (_, _, fn) in zip(stages, originals):
        setattr(owner, attr, timed(name, fn))
    try:
        run_once(cfg)
    finally:
        fused.frame_step, fused.ba_step = orig_frame, orig_ba
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)
    return {
        k: {"calls": len(v), "mean_ms": sum(v) / len(v) if v else None,
            "total_ms": sum(v)}
        for k, v in acc.items()
    }


def profiled(cfg: VOConfig, top: int) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    orig_track = lucas_kanade.track_cached

    def ranged_track(*a, **k):
        with record_function(TRACK_RANGE):
            return orig_track(*a, **k)

    lucas_kanade.track_cached = ranged_track
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = run_once(cfg)
            wall = time.perf_counter() - t0
    finally:
        lucas_kanade.track_cached = orig_track
    ka = prof.key_averages()

    # Operators dispatched inside track_cached: the descendants of the range's
    # host-side events (the trace lists each range a second time for the
    # device, without children).
    n_top_ops = n_ops = 0
    for ev in prof.events():
        if ev.name != TRACK_RANGE or not ev.cpu_children:
            continue
        n_top_ops += sum(c.name.startswith("aten::") for c in ev.cpu_children)
        stack = list(ev.cpu_children)
        while stack:
            c = stack.pop()
            n_ops += c.name.startswith("aten::")
            stack.extend(c.cpu_children)

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
    # per tracked frame: operators track_cached calls itself, and with those they call
    tracker["track_cached_ops_per_frame"] = n_top_ops / r["tracked_frames"]
    tracker["track_cached_ops_nested_per_frame"] = n_ops / r["tracked_frames"]
    return {
        "run": r, "wall_s": wall, "device_busy_s": device_us / 1e6, "tracker": tracker,
        "device_idle_share": 1.0 - device_us / 1e6 / r["runtime_s"] if device_us else None,
        "n_op_calls": sum(e.count for e in ka),
        "top_device": [{"name": e.key[:80], "calls": e.count, "device_ms": dev_us(e) / 1e3} for e in by_dev],
        "top_cpu": [{"name": e.key[:80], "calls": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3} for e in by_cpu],
    }


def decode_times(image_dir: str) -> dict:
    """Host ms per frame of each decoder over the corridor's frames."""
    files = kitti.list_images(image_dir)
    out = {}
    for name, load in (("native", native.load_grayscale), ("python", png.load_grayscale)):
        if name == "native" and not native.available():
            continue
        t0 = time.perf_counter()
        for f in files:
            load(f)
        out[name] = (time.perf_counter() - t0) / len(files) * 1e3
    return out


def setting(text: str) -> tuple[str, object]:
    """``KEY=VALUE`` of ``--set``, the value cast to the VOConfig field's type."""
    key, value = text.split("=", 1)
    typ = {f.name: f.type for f in dataclasses.fields(VOConfig)}[key]
    return key, {"int": int, "float": float}.get(typ, str)(value)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=45)
    ap.add_argument("--repeat", type=int, default=1, help="number of warm runs")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True) for all runs")
    ap.add_argument("--runs-only", action="store_true", help="cold and warm runs only")
    ap.add_argument("--plain-tracker", action="store_true",
                    help="also two runs with the plain version in place of the level kernel")
    ap.add_argument("--path", choices=sorted(PATHS), default="main",
                    help="configuration of one of chip_smoke.py's paths")
    ap.add_argument("--set", type=setting, action="append", default=[], metavar="KEY=VALUE",
                    help="override a VOConfig key of the path")
    ap.add_argument("--python-decoder", action="store_true",
                    help="decode frames with the pure-Python codec")
    ap.add_argument("--decode", action="store_true", help="also time both decoders on the host")
    ap.add_argument("--out", default=None, help="also write the JSON object to this file")
    args = ap.parse_args()
    global MODULAR
    settings, MODULAR = PATHS[args.path]
    settings = {**settings, **dict(args.set)}
    if args.python_decoder:
        prefetch._default_loader = png.load_grayscale
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="pmv_profile_") as tmp:
        cfg = vo_config(write_corridor(tmp, args.frames), tmp, args.frames, **settings)
        out = {"card": smi, "torch": torch.__version__, "frames": args.frames,
               "path": args.path, "deterministic": args.deterministic,
               "set": dict(args.set), "decoder": "python" if args.python_decoder else prefetch.decoder()}
        if args.decode:
            out["decode_ms_per_frame"] = decode_times(cfg.image_dir)
        out["cold"] = run_once(cfg)
        out["warm_runs"] = [run_once(cfg) for _ in range(max(1, args.repeat))]
        out["warm"] = out["warm_runs"][0]
        if args.plain_tracker:
            out["plain_tracker_runs"] = plain_tracker_runs(cfg, 2)
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
