"""One run of one cell of the benchmark of ``pmv_tpu_torch``.

    python3 -m vo_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. A run makes (or finds) the cell's recorded drive, sets the program up,
drives it for ``--seconds``, checks what the timed drives produced and
prints one JSON object as its last line of standard output.

- Set-up (``setup_s``): process start to the window's start, less the time
  the drive's frames took to make: importing the port, the CUDA context,
  the kernels (built by ``nvcc`` into ``pmv_tpu_torch/_build`` on a
  checkout's first run) and a warm drive that reaches every shape of the
  window (init, a full chunk, a remainder chunk, BA calls and bootstrap
  frames; one full chunk per segment in a segmented cell).
- The window: a queue of drives of the recorded sequence in a closed loop
  with one client. Each drive is a fresh pipeline object and its ``run()``:
  construction, ``initialise``, the loop and the final read-back. Drives
  start while less than ``--seconds`` has elapsed; the one under way at
  the deadline completes. ``vo_frames_per_sec`` is all frames of all drives
  over all their wall time.
- ``--trace 1``: the per-layer metrics instead. Host spans, each ended by a
  synchronise, around the per-frame step and the BA step in every drive of
  the window; the first drive also under ``torch.profiler`` (CUPTI).
- ``correct``: after the window, a drive with the stage recorder. It must
  give the timed drives' outputs bit for bit (``repeat``), and each of its
  recorded stage calls drawn from the seed is held to the plain float64
  reference (:mod:`vo_bench.judge`), each number against the limit in
  ``workloads/<cell>.json``. The stage files ``stages/<stage>.py``, if
  any, are recorded and judged after the built-in stages.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from vo_bench import cells, data

FORBIDDEN = ("jax", "jaxlib", "flax", "pmv_tpu")
BIG = 1e300  # what a non-finite reading prints as


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m vo_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``pmv_tpu_torch`` is not ``pmv_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# --------------------------------------------------------------------------
# the program
# --------------------------------------------------------------------------


def vo_config(cell: cells.Cell, paths: dict, frames: int, seed: int):
    from pmv_tpu_torch.config import VOConfig

    kw = dict(cell.config["vo_config"])
    kw.update(paths, camera=0, frames=frames, seed=seed, verbose=0)
    return VOConfig(**kw)


def make_pipeline(cfg, segments: int, device):
    from pmv_tpu_torch.pipeline.odometry import OdometryPipeline
    from pmv_tpu_torch.pipeline.segmented import SegmentedPipeline

    if segments > 1:
        return SegmentedPipeline(cfg, segments=segments, device=device)
    return OdometryPipeline(cfg, device=device)


def warm_frames(cfg, segments: int) -> int:
    """Frames of the warm drive: init, one full chunk, a remainder chunk and
    BA calls; in a segmented cell one full chunk per segment."""
    C = max(1, cfg.chunk_frames)
    return cfg.init_frames + C + 6 if segments <= 1 else cfg.init_frames + segments * C + 2


def outputs(pipe) -> dict:
    """What a drive produced: trajectory, per-frame statistics, the kept
    feature tables and the map (device tensors left where they are)."""
    keys = ("tracked", "n3d", "used_pnp", "reseed", "inliers", "accepted")
    return {
        "R": np.stack(pipe.R), "t": np.stack(pipe.t),
        "stats": [tuple(s[k] for k in keys) for s in pipe.frame_stats],
        "tables": [(tb.xy, tb.valid, tb.landmark) for tb in pipe.tables],
        "map": (pipe.map.xyz, pipe.map.alive),
    }


def same(a: dict, b: dict) -> bool:
    import torch

    return (np.array_equal(a["R"], b["R"]) and np.array_equal(a["t"], b["t"])
            and a["stats"] == b["stats"] and len(a["tables"]) == len(b["tables"])
            and all(torch.equal(x, y) for ta, tb in zip(a["tables"], b["tables"]) for x, y in zip(ta, tb))
            and all(torch.equal(x, y) for x, y in zip(a["map"], b["map"])))


@dataclass
class Drive:
    frames: int
    wall_s: float
    runtime_s: float = 0.0
    ok: bool = False
    out: dict | None = None
    frame_stats: list = field(default_factory=list)


def drive(cfg, segments: int, device) -> Drive:
    """One drive: a fresh pipeline and its ``run()``, timed by the host
    clock (``run()`` ends in its read-back of the trajectory)."""
    t0 = time.perf_counter()
    try:
        pipe = make_pipeline(cfg, segments, device)
        pipe.run()
    except Exception:  # a drive that raises counts its frames as failed
        log(traceback.format_exc())
        return Drive(cfg.frames, time.perf_counter() - t0)
    wall = time.perf_counter() - t0
    out = outputs(pipe)
    finite = bool(np.isfinite(out["R"]).all() and np.isfinite(out["t"]).all())
    return Drive(cfg.frames, wall, pipe.runtime, finite, out, pipe.frame_stats)


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)), "power_limit": limit}


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------


def recorded_drive(cell: cells.Cell, cfg, frames_arr, device, stages: dict | None = None):
    """One drive with the stage recorder on, the stage files ``stages``
    (:func:`vo_bench.judge.stage_files`) beside the built-in stages. Returns
    (the recorded calls, where their frames are
    (:class:`vo_bench.judge.Drive`), the drive's outputs, its frame
    statistics)."""
    from vo_bench import judge, record

    rec = record.Recorder(stages)
    with record.patched(rec.wrappers(), stages):
        pipe = make_pipeline(cfg, cell.traffic["segments"], device)
        pipe.run()
    starts = None
    if cell.traffic["segments"] > 1:
        starts = [pipe.init_offset + b * pipe.segment_length for b in range(pipe.segments)]
    drv = judge.Drive(frames_arr, pipe.init_offset, cfg.init_frames, starts, max(1, cfg.chunk_frames))
    return rec.calls, drv, outputs(pipe), pipe.frame_stats


def check(cell: cells.Cell, cfg, frames_arr, seed: int, drives: list, device,
          here: Path = cells.HERE) -> tuple[dict, dict]:
    """The correctness drive and the comparison, with the stage files under
    ``here``. Returns (numbers, limits)."""
    from vo_bench import judge

    stages = judge.stage_files(here)
    calls, drv, out, _ = recorded_drive(cell, cfg, frames_arr, device, stages)
    numbers = {"repeat": float(sum(not (d.ok and same(d.out, out)) for d in drives))}
    del out
    limits = dict(cell.spec["limits"])
    numbers.update(judge.judge(calls, drv, cell.spec["samples"], seed, numbers_wanted=limits, stages=stages))
    return numbers, limits


def traced_window(cfg, segments: int, seconds: float, device, trace_frames: int = 0):
    """The window of a traced run: spans around every step; the first drive
    under the profiler. Returns (drives, spans, DeviceTrace or None)."""
    from vo_bench import record, trace

    spans = record.Spans(device)
    drives, dtrace = [], None
    with record.patched(spans.wrappers()):
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            if dtrace is None and device.type == "cuda":
                d, dtrace = trace.profiled(lambda: drive(cfg, segments, device), device, spans, trace_frames)
            else:
                d = drive(cfg, segments, device)
            drives.append(d)
    return drives, spans.spans, dtrace


def per_layer(cell: cells.Cell, drives, spans, dtrace, cfg, shape, here: Path) -> dict:
    data_ns = SimpleNamespace(drives=drives, spans=spans, trace=dtrace, cfg=cfg, shape=shape,
                              segments=cell.traffic["segments"])
    out = {}
    for m in cell.per_layer:
        v = cells.metric_reader(m["name"], here).read(data_ns)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(args, device, t_proc: float, bench_file: Path = cells.ROOT / "BENCHMARK.json",
        here: Path = cells.HERE, data_root: Path = data.DATA_ROOT) -> dict:
    """Everything after the check for cards; returns the result object."""
    import torch

    cell = cells.find(args.workload, bench_file, here)
    t_data = time.perf_counter()
    paths, frames_arr = data.materialize(cell.traffic, args.seed, data_root)
    data_s = time.perf_counter() - t_data
    log(f"vo_bench: {cell.name} seed {args.seed}: the drive's {len(frames_arr)} frames took "
        f"{data_s:.3f} s to make or read (not set-up)")

    segments = int(cell.traffic["segments"])
    cfg = vo_config(cell, paths, int(cell.traffic["frames"]), args.seed)
    if device.type == "cuda":
        torch.cuda.init()
    t_warm = time.perf_counter()
    warm = vo_config(cell, paths, warm_frames(cfg, segments), args.seed)
    if not drive(warm, segments, device).ok:
        raise RuntimeError("the warm drive failed")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_proc - data_s
    log(f"vo_bench: set-up {setup_s:.3f} s: {t_warm - t_proc - data_s:.3f} s to the warm drive "
        f"(imports, the CUDA context), {time.perf_counter() - t_warm:.3f} s the warm drive of "
        f"{warm.frames} frames (the kernels' load or build, the first call of each shape)")

    if args.trace:
        drives, spans, dtrace = traced_window(cfg, segments, args.seconds, device,
                                              int(cell.spec.get("trace_frames", 0)))
        log(f"vo_bench: traced window and drives {time.perf_counter() - t_proc:.1f} s after start")
    else:
        drives, spans, dtrace = [], [], None
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < args.seconds:
            drives.append(drive(cfg, segments, device))
    dev = device_info(device, cell.chips)  # the peak, before the check runs
    log(f"vo_bench: set-up {setup_s:.1f} s; {len(drives)} drive(s) of "
        f"{', '.join(f'{d.wall_s:.3f}' for d in drives)} s; window closed {time.perf_counter() - t_proc:.1f} s after start")

    numbers, limits = check(cell, cfg, frames_arr, args.seed, drives, device, here)
    log(f"vo_bench: check done {time.perf_counter() - t_proc:.1f} s after start")
    failed = sum(d.frames for d in drives if not d.ok)
    missing = [k for k in limits if k not in numbers]
    correct = not failed and not missing and all(numbers[k] <= limits[k] for k in limits)
    for k in missing:
        log(f"compared {k}: no call of its stage was recorded")

    res = {"correct": correct, "attempted": sum(d.frames for d in drives), "failed": failed}
    if args.trace:
        res["metrics"] = per_layer(cell, drives, spans, dtrace, cfg, frames_arr.shape[1:], here)
        if dtrace is not None:
            dev.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
            top = sorted(dtrace.kernels.items(), key=lambda kv: -kv[1][1])[:10]
            gaps = sorted(dtrace.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
            res["breakdown"] = {"device_ops": [[k, v[1]] for k, v in top],
                                "idle_gaps": [[k, v] for k, v in gaps]}
    else:
        wall = sum(d.wall_s for d in drives)
        res["metrics"] = {"vo_frames_per_sec": {"value": res["attempted"] / wall, "unit": "frames/s"},
                          "setup_s": {"value": setup_s, "unit": "s"}}
    res["device"] = dev
    res["compared"] = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else BIG, "limit": lim}
                       for k, lim in limits.items() if k in numbers}
    return res


def main(argv=None) -> int:
    t_proc = time.perf_counter()
    args = parse(argv)
    import torch

    cell = cells.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"vo_bench: {cell.name} needs {cell.chips} CUDA card(s); this machine has {n}")
        return 2
    res = run(args, torch.device("cuda", 0), t_proc)
    found = forbidden_modules()
    if found:
        log(f"vo_bench: the run loaded {', '.join(found)}; no result")
        return 3
    for k, v in res["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0
