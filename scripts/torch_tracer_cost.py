"""What the program's tracer (``pmv_tpu_torch.utils.profiling``) costs a
drive: frames per second of one benchmark cell's drives with the tracer off
and on, in turns in one process (off, on, on, off, ...), on the card.

    python3 scripts/torch_tracer_cost.py kitti07_ba5x5.corridor118 [--seed N] [--pairs 3]

Each drive is the benchmark's (``vo_bench.run.drive``: a fresh pipeline and
its ``run()``), after the benchmark's warm drive. Prints one line per drive
and a last JSON line with each side's frames/s and the median cost.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from pmv_tpu_torch.utils import profiling
    from vo_bench import cells, data, run

    device = torch.device(args.device)
    cell = cells.find(args.workload)
    paths, _ = data.materialize(cell.traffic, args.seed)
    segments = int(cell.traffic["segments"])
    cfg = run.vo_config(cell, paths, int(cell.traffic["frames"]), args.seed)
    warm = run.vo_config(cell, paths, run.warm_frames(cfg, segments), args.seed)
    if not run.drive(warm, segments, device).ok:
        raise RuntimeError("the warm drive failed")
    fps = {"off": [], "on": []}
    order = [("off", "on"), ("on", "off")]
    for i in range(args.pairs):
        for side in order[i % 2]:
            tracer = profiling.Tracer() if side == "on" else None
            t0 = time.perf_counter()
            with profiling.tracing(tracer):
                d = run.drive(cfg, segments, device)
            if not d.ok:
                raise RuntimeError("a drive failed")
            fps[side].append(d.frames / d.wall_s)
            spans = len(tracer.spans) if tracer is not None else 0
            print(f"pair {i} tracer {side}: {fps[side][-1]:.4f} frames/s "
                  f"({time.perf_counter() - t0:.3f} s, {spans} spans)", flush=True)
    med = {k: statistics.median(v) for k, v in fps.items()}
    print(json.dumps({"workload": args.workload, "seed": args.seed, "device": str(device),
                      "card": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                      "frames_per_sec": fps, "median": med,
                      "cost": 1.0 - med["on"] / med["off"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
