"""Readings of the comparison that decides ``correct``, for setting its
limits: the program's, and the control's (the reference computed in TF32
put in the program's place), on many seeds in one process.

    python3 -m vo_bench.control --workload <cell> --seeds 1,2,3 [--detail FILE]

For each seed it makes the drive, runs one recorded drive of the program
(no timed window) and prints one JSON line: ``{"seed", "bootstraps",
"program", "control", "seconds"}``, each a dict of the numbers of
:mod:`vo_bench.judge` (the control on the first ``--control-seeds`` seeds
only). ``--detail`` writes every judged call's readings to
FILE as JSON. The benchmark's runs do not run this."""

from __future__ import annotations

import argparse
import json
import sys
import time

from vo_bench import cells, data, judge, run


def readings(cell: cells.Cell, seed: int, device, data_root=data.DATA_ROOT, detail=None,
             control: bool = True, here=cells.HERE) -> dict:
    """The program's and the control's numbers on one seed, the stage files
    under ``here`` with the built-in stages'."""
    paths, frames = data.materialize(cell.traffic, seed, data_root)
    cfg = run.vo_config(cell, paths, int(cell.traffic["frames"]), seed)
    stages = judge.stage_files(here)
    t0 = time.perf_counter()
    calls, drv, _, stats = run.recorded_drive(cell, cfg, frames, device, stages)
    boot = sum(not s["used_pnp"] for s in stats)
    out = {"seed": seed, "bootstraps": boot}
    for side, ctl in (("program", False), ("control", True))[: 2 if control else 1]:
        d = [] if detail is not None else None
        out[side] = judge.judge(calls, drv, cell.spec["samples"], seed, control=ctl, detail=d, stages=stages)
        if detail is not None:
            detail.append({"seed": seed, "side": side, "calls": d})
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vo_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--detail")
    ap.add_argument("--control-seeds", type=int, default=3, help="read the control on the first N seeds")
    args = ap.parse_args(argv)
    import torch

    cell = cells.find(args.workload)
    device = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        print("vo_bench.control: no CUDA card", file=sys.stderr)
        return 2
    detail = [] if args.detail else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, device, detail=detail,
                                  control=i < args.control_seeds)), flush=True)
    if args.detail:
        with open(args.detail, "w") as f:
            json.dump(detail, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
