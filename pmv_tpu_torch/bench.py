"""Benchmark entry point of the port: one JSON line for a benchmark harness.

    python3 -m pmv_tpu_torch.bench        # from the repo root; needs one CUDA card

The counterpart of the repo's root ``bench.py`` (the JAX package's runner),
with its workload, knobs and record. It measures end-to-end VO throughput
(frames/s) of ``OdometryPipeline.run()`` on a KITTI-sized synthetic corridor
(1226x370, the KITTI odometry frame size) at the length of KITTI 07. Baseline:
the reference C++ pipeline's published KITTI-07 run at the default
bundle_size=5 / max_iterations=5 configuration, 600 frames in 24.15 s = 24.8
frames/s (BASELINE.md).

Environment knobs (``bench.py``'s):

- ``BENCH_FRAMES`` (598): frames of a full run; ``BENCH_FIRST_FRAMES`` (118):
  frames of the short run, which is emitted at once;
- ``BENCH_REPEATS`` (3): full runs at most, each started only when its
  projected cost fits the budget; the best is the record's ``value``;
- ``BENCH_OVERRIDES`` (``{}``): JSON of ``VOConfig`` keys over the default
  loop's; ``BENCH_SEGMENTS`` (1): more than 1 runs ``SegmentedPipeline``
  with that many segments;
- ``BENCH_TIMEOUT_S`` (1200): the watchdog's budget;
- ``BENCH_CACHE``: where the corridors are written, one directory per length
  (default: ``pmv_torch_bench_data`` in the temporary directory);
- ``BENCH_PLATFORM=cpu``: run on the CPU (to test the harness). Otherwise the
  run is on the CUDA card, and without one it fails: nothing falls back.

The parent (the watchdog) runs the benchmark in a child process, streams its
output and prints exactly one line: the child's last record, or a record of
value 0 with ``detail.error``. It exits 0 only when the child ended well
after a record; 124 when the child was killed at ``BENCH_TIMEOUT_S``; else
the child's code (128 + the signal that ended it), or 1. A failed child's
earlier record is forwarded with ``detail.error`` set.

What differs from ``bench.py``: there is no compilation cache (the set-up is
the ``nvcc`` build at first use and the CUDA libraries' start-up, paid by the
warm run: ``detail.setup_s``), no tunnel probe and no synchronous-upload
retry; ``detail.upload_probe_mb_s`` is the host-to-card copy rate from pinned
memory, and ``detail.fps_full_runs`` holds the frames/s of every full run.
Numbers are written unrounded.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from pmv_tpu_torch import build, cli, resolve_device
from pmv_tpu_torch.config import VOConfig
from pmv_tpu_torch.io import native, synthetic
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline
from pmv_tpu_torch.pipeline.segmented import SegmentedPipeline

ROOT = Path(__file__).resolve().parent.parent

BASELINE_FPS = 24.8  # reference 5/5 config on KITTI 07 (BASELINE.md)

# Full length = the reference's own workload length (KITTI 07); the first
# timed run is short, so that a record exists early.
TARGET_FRAMES = int(os.environ.get("BENCH_FRAMES", "598"))
FIRST_FRAMES = min(int(os.environ.get("BENCH_FIRST_FRAMES", "118")), TARGET_FRAMES)
SHAPE = (370, 1226)  # KITTI odometry grayscale frame size
CACHE = Path(os.environ.get("BENCH_CACHE", str(Path(tempfile.gettempdir()) / "pmv_torch_bench_data")))

# Watchdog budget. The child keeps ~8% margin for itself so that it can
# finish emitting before the parent's hard kill.
BUDGET_S = int(os.environ.get("BENCH_TIMEOUT_S", "1200"))

_SEGS = int(os.environ.get("BENCH_SEGMENTS", "1"))
try:
    _CHUNK = int(json.loads(os.environ.get("BENCH_OVERRIDES", "{}")).get("chunk_frames", 8))
except ValueError:  # the child's make_pipeline reports the malformed overrides
    _CHUNK = 8
# The warm run must reach every shape of the timed run: init (5 frames) + a
# full chunk + remainder-sized (1) chunks + a BA call. Segmented mode needs
# one full chunk per segment.
WARMUP_FRAMES = 5 + _CHUNK + 6 if _SEGS <= 1 else 5 + _SEGS * _CHUNK + 2


def build_dataset(n_frames: int, suffix: str = "", **scene) -> dict:
    """The corridor of ``n_frames`` frames as a KITTI layout under
    ``CACHE``, written once: one directory per length, marked ``ok`` when
    complete, so that runs of other lengths never write into one layout.
    ``scene``: more ``make_sequence`` keywords (a scene family's), whose
    layout goes into a directory named with ``suffix``."""
    d = CACHE / f"seq_{n_frames}_{SHAPE[0]}x{SHAPE[1]}{suffix}"
    marker = d / "ok"
    paths = {
        "image_dir": str(d / "image_0"),
        "camera_calibration": str(d / "calib.txt"),
        "poses": str(d / "poses.txt"),
    }
    if marker.exists():
        return paths
    seq = synthetic.make_sequence(
        n_frames=n_frames,
        shape=SHAPE,
        K=synthetic.KITTI_K,
        density=150.0,
        speed=1.0,
        yaw_rate=0.004,
        seed=0,
        **scene,
    )
    synthetic.write_kitti_layout(seq, d)
    marker.touch()
    return paths


def bench_device() -> torch.device:
    """The card, or the CPU when ``BENCH_PLATFORM=cpu`` asks for it; raises
    when there is no card."""
    return resolve_device(os.environ.get("BENCH_PLATFORM") or None)


def make_pipeline(paths: dict, frames: int):
    overrides = json.loads(os.environ.get("BENCH_OVERRIDES", "{}"))
    base = dict(
        image_dir=paths["image_dir"],
        camera_calibration=paths["camera_calibration"],
        poses=paths["poses"],
        camera=0,
        frames=frames,
        init_frames=5,
        min_tracked_features=400,
        tracked_features_tol=150,
        bundle_size=5,
        max_iterations=5,
        feature_capacity=512,
        map_capacity=8192,
        verbose=0,
        seed=0,
    )
    base.update(overrides)  # overrides win, including base keys like seed
    cfg = VOConfig(**base)
    if _SEGS > 1:
        return SegmentedPipeline(cfg, segments=_SEGS, device=bench_device())
    return OdometryPipeline(cfg, device=bench_device())


def device_name(dev: torch.device) -> str:
    """The card as ``nvidia-smi`` names it with its power limit, or ``cpu``."""
    if dev.type != "cuda":
        return dev.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def measure_upload_mb_s(dev: torch.device) -> float | None:
    """Host-to-card copy rate of image chunks (best of 3), as ``run()``
    uploads them: six distinct 8-frame uint8 chunks from pinned memory, all
    in flight, read after a stream synchronise. None on the CPU."""
    if dev.type != "cuda":
        return None
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.integers(0, 255, (8,) + SHAPE, dtype=np.uint8)).pin_memory()
          for _ in range(6)]
    xs[0].to(dev, non_blocking=True)  # warm the path
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        on_card = [x.to(dev, non_blocking=True) for x in xs]
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
        del on_card
    return len(xs) * xs[0].nbytes / best / 1e6


def record(fps: float, result: dict, pipe, setup: dict, stage: str, fps_full_runs: list) -> dict:
    """``bench.py``'s record, unrounded. ``setup``: what the child measured
    once (``device``, ``setup_s``, ``nvcc_s``, ``upload_probe_mb_s``)."""
    ba_iters_per_sec = result["ba_calls"] * pipe.cfg.max_iterations / max(result["runtime"], 1e-9)
    return {
        "metric": "vo_frames_per_sec",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / BASELINE_FPS,
        "detail": {
            "frames": result["frames"],
            "runtime_s": result["runtime"],
            "t_total": result["t_total"],
            "R_total": result["R_total"],
            # rebased ATE: the error file never re-bases the init offset
            "ate_rmse_m": cli.rebased_ate(pipe),
            "ba_iters_per_sec": ba_iters_per_sec,
            "device": setup["device"],
            "frame_shape": list(SHAPE),
            # "short" = the first run, "full" = a full-length run, "full+N"
            # = the best of N of them
            "bench_stage": stage,
            "png_decoder": "native_cpp" if native.available() else "python",
            # the warm run's wall time: CUDA context, the kernels' nvcc build
            # at first use (nvcc_s, null when already built), the libraries'
            # start-up and its frames
            "setup_s": setup["setup_s"],
            "nvcc_s": setup["nvcc_s"],
            "upload_probe_mb_s": setup["upload_probe_mb_s"],
            "wire_mb_s_achieved": fps * SHAPE[0] * SHAPE[1] / 1e6,
            "fps_full_runs": list(fps_full_runs),
        },
    }


def _timed_run(pipe) -> tuple[dict, float, float]:
    """``pipe.run()``: its result, frames/s and wall seconds."""
    t0 = time.time()
    result = pipe.run()
    return result, result["frames"] / max(result["runtime"], 1e-9), time.time() - t0


def main() -> None:
    t0 = time.time()
    deadline = t0 + BUDGET_S * 0.92

    def remaining() -> float:
        return deadline - time.time()

    dev = bench_device()  # before any work: no card, no run
    setup = {"device": device_name(dev)}

    # Phase 1: short dataset + warm run + first timed run. Emit at once.
    paths = build_dataset(FIRST_FRAMES)
    t_setup = time.perf_counter()
    make_pipeline(paths, WARMUP_FRAMES).run()
    setup["setup_s"] = time.perf_counter() - t_setup
    setup["nvcc_s"] = build.build_seconds
    setup["upload_probe_mb_s"] = measure_upload_mb_s(dev)

    pipe = make_pipeline(paths, FIRST_FRAMES)
    result, fps, first_run_s = _timed_run(pipe)
    best = (fps, record(fps, result, pipe, setup, "short", []))
    print(json.dumps(best[1]), flush=True)

    if TARGET_FRAMES <= FIRST_FRAMES:
        return

    # Phase 2: full-length runs, each only started if its projected cost
    # (linear in frames vs the first run, +20% margin) fits the remaining
    # budget. Best of N; every completed run re-emits.
    proj_full = first_run_s * (TARGET_FRAMES / FIRST_FRAMES) * 1.2 + 30
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    fps_full: list[float] = []
    paths_full = None
    for _ in range(max(1, repeats)):
        if remaining() < proj_full:
            break
        if paths_full is None:
            paths_full = build_dataset(TARGET_FRAMES)
        pipe = make_pipeline(paths_full, TARGET_FRAMES)
        result, fps, run_s = _timed_run(pipe)
        proj_full = run_s * 1.1 + 15
        fps_full.append(fps)
        done = len(fps_full)
        stage = "full" if done == 1 else f"full+{done}"
        if fps >= best[0] or best[1]["detail"]["frames"] < result["frames"]:
            best = (fps, record(fps, result, pipe, setup, stage, fps_full))
        else:  # keep the better fps but bump the stage marker
            best[1]["detail"]["bench_stage"] = stage
            best[1]["detail"]["fps_full_runs"] = list(fps_full)
        print(json.dumps(best[1]), flush=True)


def main_with_watchdog() -> int:
    """Run the benchmark in a child process (its own process group) with a hard
    timeout; stream its output, keeping the last record; on timeout kill the
    child's process group (never by pattern). Prints exactly one line and
    returns the exit code (see the module's docstring)."""
    import signal
    import threading

    env = dict(os.environ, BENCH_CHILD="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "pmv_tpu_torch.bench"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True,
    )
    state = {"last": None, "stderr": ""}

    def _read_out():
        for line in proc.stdout:
            line = line.strip()
            if line.startswith("{"):
                state["last"] = line

    def _read_err():
        state["stderr"] = proc.stderr.read()

    t_out = threading.Thread(target=_read_out, daemon=True)
    t_err = threading.Thread(target=_read_err, daemon=True)
    t_out.start()
    t_err.start()
    # a parent told to stop takes its child with it
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    timed_out = False
    try:
        proc.wait(timeout=BUDGET_S)
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        if proc.poll() is None:  # kill the exact process group started here
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    t_out.join(timeout=30)
    t_err.join(timeout=30)

    rc = proc.returncode
    if timed_out:
        code, why = 124, f"killed after BENCH_TIMEOUT_S={BUDGET_S} s"
    elif rc != 0:
        code, why = (rc if rc > 0 else 128 - rc), f"the child exited with {rc}"
    elif state["last"] is None:
        code, why = 1, "the child exited with 0"
    else:
        print(state["last"])
        return 0
    err = (state["stderr"] or "")[-400:]
    if state["last"] is not None:
        rec = json.loads(state["last"])
        rec["detail"]["error"] = f"{why} after this record: {err}"
    else:
        rec = {"metric": "vo_frames_per_sec", "value": 0.0, "unit": "frames/s", "vs_baseline": 0.0,
               "detail": {"error": f"no record emitted ({why}): {err}"}}
    print(json.dumps(rec))
    return code


if __name__ == "__main__":
    if os.environ.get("BENCH_CHILD") == "1":
        main()
    else:
        sys.exit(main_with_watchdog())
