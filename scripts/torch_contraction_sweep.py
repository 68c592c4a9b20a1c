"""What each elimination site does to the port's bootstrap frames and
accuracy against ``pmv_tpu``'s: the accuracy sweep's runs with one site
switched between XLA's one rounding a step (``core.linalg.fma``) and two.

    python3 scripts/torch_contraction_sweep.py [--frames 600] [--seeds 0 1 2 3]
        [--config parity] [--family corridor] [--variants as_is gj10_fused ...] [--device cpu]

Variants: ``as_is`` (the port), ``ba_two_roundings`` (the BA's reduced
camera system, ``schur_lm.schur_solve``, solved with two roundings a step),
``gj10_fused`` (the five-point reduction ``_gauss_jordan10`` with one),
and ``two_roundings`` (every site at two roundings: the port before it
mirrored XLA's contraction). Each run is
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


def gauss_jordan10_fused(A: torch.Tensor) -> torch.Tensor:
    """``five_point._gauss_jordan10`` with each elimination step rounded
    once (``linalg.fma``), as the JAX package's compiled reduction rounds."""
    H = A.shape[0]
    ar, idx = torch.arange(H, device=A.device), torch.arange(10, device=A.device)
    A = A.clone()
    for col in range(10):
        p = torch.argmax(torch.where(idx >= col, A[:, :, col].abs(), -1.0), dim=1)
        rp, rc = A[ar, p].clone(), A[:, col].clone()
        A[:, col] = rp
        A[ar, p] = torch.where((p == col)[:, None], rp, rc)
        pivot = A[:, col, col]
        safe = torch.where(pivot.abs() < 1e-12, torch.full_like(pivot, 1e-12), pivot)
        A[:, col] = A[:, col] / safe[:, None]
        factors = A[:, :, col].clone()
        factors[:, col] = 0.0
        A = linalg.fma(-factors[:, :, None], A[:, col][:, None, :], A)
    return A


@contextlib.contextmanager
def variant(name: str):
    saved = schur_lm.gj_solve, five_point._gauss_jordan10
    if name == "ba_two_roundings":
        def solve(A, B):
            with two_roundings():
                return saved[0](A, B)
        schur_lm.gj_solve = solve
    if name == "gj10_fused":
        five_point._gauss_jordan10 = gauss_jordan10_fused
    try:
        with two_roundings() if name == "two_roundings" else contextlib.nullcontext():
            yield
    finally:
        schur_lm.gj_solve, five_point._gauss_jordan10 = saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--config", default="parity")
    ap.add_argument("--family", default="corridor")
    ap.add_argument("--variants", nargs="+",
                    default=["as_is", "ba_two_roundings", "gj10_fused", "two_roundings"])
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
