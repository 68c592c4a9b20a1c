"""What each elimination site does to the port's bootstrap frames and
accuracy against ``pmv_tpu``'s: the accuracy sweep's runs with one site
switched between XLA's one rounding a step (``core.linalg.fma``) and two.

    python3 scripts/torch_contraction_sweep.py [--frames 600] [--seeds 0 1 2 3]
        [--config parity] [--family corridor] [--variants as_is gj10_two_roundings ...] [--device cpu]

Variants: ``as_is`` (the port), ``ba_two_roundings`` (the BA's reduced
camera system, ``schur_lm.schur_solve``, solved with two roundings a step),
``gj10_two_roundings`` (the five-point reduction ``_gauss_jordan10`` with
two) and ``two_roundings`` (every site at two roundings). Each run is
``parity_sweep.run_seed`` on the sweep's scene (error files under a
temporary directory); one JSON line per variant and seed with its bootstrap
and PnP frames, rebased ATE, its largest estimated step beside the ground
truth's, and the card's name and power limit. Run from
the repo root, on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pmv_tpu_torch import bench, parity_sweep, resolve_device  # noqa: E402
from pmv_tpu_torch.ba import schur_lm  # noqa: E402
from pmv_tpu_torch.core import linalg  # noqa: E402
from pmv_tpu_torch.solvers import five_point  # noqa: E402


@contextlib.contextmanager
def two_roundings():
    """Within it ``linalg.fma`` rounds its product and its sum apart
    (``a * b + c``), as the port did before it mirrored XLA's contraction."""
    real = linalg.fma
    linalg.fma = lambda a, b, c: a * b + c
    try:
        yield
    finally:
        linalg.fma = real


# variant -> (module, function) run at two roundings
SITES = {"ba_two_roundings": (schur_lm, "gj_solve"), "gj10_two_roundings": (five_point, "_gauss_jordan10")}


@contextlib.contextmanager
def variant(name: str):
    site = SITES.get(name)
    if site:
        saved = getattr(*site)

        def rounded_twice(*args):
            with two_roundings():
                return saved(*args)
        setattr(*site, rounded_twice)
    try:
        with two_roundings() if name == "two_roundings" else contextlib.nullcontext():
            yield
    finally:
        if site:
            setattr(*site, saved)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--config", default="parity")
    ap.add_argument("--family", default="corridor")
    ap.add_argument("--variants", nargs="+",
                    default=["as_is", "ba_two_roundings", "gj10_two_roundings", "two_roundings"])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    card = bench.device_name(dev)
    with tempfile.TemporaryDirectory(prefix="pmv_contraction_") as tmp:
        k = parity_sweep.knobs({"PARITY_CONFIG": args.config, "PARITY_FAMILY": args.family,
                                "PARITY_OUT": tmp})
        paths = parity_sweep.build_dataset(args.frames, args.family)
        parity_sweep.run_seed(paths, k, args.seeds[0], parity_sweep.WARMUP_FRAMES, dev, card)
        for name in args.variants:
            for seed in args.seeds:
                with variant(name):
                    row, pipe = parity_sweep.run_seed(paths, k, seed, args.frames, dev, card)
                # the largest estimated step and where it lies against the ground truth's
                t = np.stack(pipe.t)
                steps = np.linalg.norm(np.diff(t, axis=0), axis=1)
                off = pipe.init_offset
                gt = [float(np.linalg.norm(pipe.gt_t[off + i + 1] - pipe.gt_t[off + i]))
                      for i in range(len(steps))]
                i = int(np.argmax(steps))
                print(json.dumps({"variant": name, "config": args.config, "family": args.family,
                                  **{key: row[key] for key in (
                                      "seed", "frames", "bootstrap_frames", "pnp_frames",
                                      "ate_rmse_m", "fps", "device")},
                                  "max_step": {"frame": off + i, "step_m": float(steps[i]),
                                               "gt_step_m": gt[i],
                                               "bootstrap": not pipe.frame_stats[i]["used_pnp"]}}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
