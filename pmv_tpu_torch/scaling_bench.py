"""Scaling measurement of the port: the landmark-sharded BA over the ``lm``
axis and a batch of sequences through the batched chunk step.

    python3 -m pmv_tpu_torch.scaling_bench [--device cpu] [--out PATH]   # from the repo root

The counterpart of ``scripts/scaling_bench.py``, with its three legs and row
keys:

1. ``dist_ba``: weak scaling of ``parallel.dist_ba`` over the ``lm`` axis,
   per-shard work fixed (``probe.weak_ba_args``: Ls 512 landmarks a shard,
   5 poses, 10 LM iterations), 1, 2 and 4 shards. ``collectives`` and
   ``collective_bytes`` count what one solve issues once in its program
   (``probe.comm_profile``: the all-reduces of one LM iteration, those
   outside the iterations, the final all-gathers; float32 elements), where
   the JAX script reads the same from the compiled HLO;
   ``collective_bytes_per_iteration`` is one LM iteration's share.
2. ``dist_ba_worksweep``: weak efficiency at lm = 2 as the per-shard work
   grows (Ls 512, 2048, 8192) against a one-shard baseline.
3. ``multi_seq``: B = 1, 2, 4, 8 sequences through
   ``parallel.multi_seq.make_batched_chunk_step(None, ...)`` in one process,
   at the JAX script's size (96x160, 128 slots, map 512, 3 levels, window
   15, 5 iterations, 3 chunks of 4 frames), and at full width
   (``multi_seq_full``: 370x1226, 512 slots, map 8192, the ``VOConfig``
   defaults, 32 frames a sequence in chunks of 8), the counterpart of
   ``SCALING.json``'s ``tpu_multiseq_dp_per_chip`` rows (``compute``: the
   frames already on the device; ``e2e``: each chunk uploaded inside the
   timed loop).

What differs from ``scripts/scaling_bench.py``: there is no virtual device
mesh (``xla_force_host_platform_device_count``) and, on the card, no
baseline pinned to one core under ``taskset``: those are the CPU's
workarounds, kept only under ``--device cpu``. The card is one device: its
``lm`` ranks are ``gloo`` processes that share it (NCCL refuses two ranks on
one card) wherever the shards outnumber the cards, so those rows check the
sharded work and its communication; they are not a scaling claim, and the
output's ``note`` says so. Every batch's timed run starts from copies of
the same initial states and generators (the port's step updates a state in
place), after one untimed run. The output, with the card's name and power
limit and numbers unrounded, goes to ``artifacts/torch/scaling.json``
(never to ``SCALING.json``, the JAX package's). Without a card it fails
before it measures anything, unless ``--device cpu`` asks for the CPU; it
exits non-zero when a leg fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from pmv_tpu_torch import bench, resolve_device
from pmv_tpu_torch.config import VOConfig
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend.corners import grid_extract, select_top
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.io import synthetic
from pmv_tpu_torch.parallel import dist_ba, multi_seq, probe
from pmv_tpu_torch.parallel.mesh import launch, make_mesh
from pmv_tpu_torch.pipeline import fused
from pmv_tpu_torch.pipeline.odometry import step_config
from pmv_tpu_torch.pipeline.segmented import seed_state, segment_generators

OUT = Path("artifacts/torch/scaling.json")
SHARDS = (1, 2, 4)
WORK_SWEEP = (512, 2048, 8192)
BATCHES = (1, 2, 4, 8)
# scripts/scaling_bench.py's multi_seq size
SMALL = dict(shape=(96, 160), N=128, M=512, chunks=3, C=4)
# scripts/tpu_multiseq_bench.py's length: 32 frames a sequence, chunks of 8
FULL_FRAMES, FULL_CHUNK = 32, 8


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _backend(kind: str, n: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    return "nccl" if kind == "cuda" and n <= torch.cuda.device_count() else "gloo"


# ---------------------------------------------------------------- dist_ba


def _dist_ba_rank(rank, n, Ls, iters, repeats, kind):
    """One rank of a ``dist_ba`` row: best seconds of one solve and the
    collectives of a solve."""
    mesh = make_mesh(dp=1, lm=n, device_type=kind)
    args = [a.to(mesh.device) for a in probe.weak_ba_args(n, Ls=Ls)]
    sec = probe.best_seconds(dist_ba.make_distributed_ba(mesh, iters=iters), args, mesh.device,
                             repeats)
    return sec, probe.comm_profile(mesh, args)


def bench_dist_ba(kind: str, iters: int = 10, Ls: int = 512, shards=SHARDS,
                  repeats: int = 5) -> list[dict]:
    rows, base = [], None
    backend = _backend(kind, max(shards))
    for n in shards:
        sec, comm = launch(_dist_ba_rank, n, backend=backend, device_type=kind,
                           args=(n, Ls, iters, repeats, kind))[0]
        parts = (comm["per_iteration"]["all_reduce"], comm["once"]["all_reduce"],
                 comm["final_gather"])
        base = sec if base is None else base
        rows.append({
            "lm_shards": n,
            "landmarks_total": n * Ls,
            "obs_per_shard": 5 * Ls,
            "sec_per_call": sec,
            "ba_iters_per_sec": iters / sec,
            "weak_efficiency": base / sec,
            "collectives": sum(p["calls"] for p in parts),
            "collective_bytes": 4 * sum(p["elements"] for p in parts),
            "collective_bytes_per_iteration": 4 * parts[0]["elements"],
            "backend": backend,
        })
    return rows


def bench_dist_ba_worksweep(kind: str, iters: int = 10, sweep=WORK_SWEEP,
                            repeats: int = 5) -> list[dict]:
    """Weak efficiency at lm = 2 as the per-shard work grows. The baseline
    is one shard pinned to one core on the CPU (``taskset``), and one shard
    on the card there."""
    rows = []
    backend = _backend(kind, 2)
    for Ls in sweep:
        if kind == "cpu":
            t1 = probe.pinned_one_shard_seconds(Ls, iters, device_type=kind)
            baseline = "one shard pinned to one core"
            if t1 is None:
                raise RuntimeError("the pinned one-shard baseline failed (taskset)")
        else:
            t1 = probe.time_sharded_solve(1, Ls, iters, repeats, device_type=kind, backend=backend)
            baseline = "one shard on the card"
        t2 = probe.time_sharded_solve(2, Ls, iters, repeats, device_type=kind, backend=backend)
        rows.append({
            "Ls_per_shard": Ls,
            "sec_1shard_pinned": t1,
            "sec_2shards_2x_work": t2,
            "weak_efficiency_at_2": t1 / t2,
            "baseline": baseline,
            "backend": backend,
        })
    return rows


# ---------------------------------------------------------------- multi_seq


def _copy(state: fused.StepState) -> fused.StepState:
    """A copy of a (batched) state: the step writes histories in place."""
    return multi_seq._rebuild(state, [x.clone() for x in multi_seq._leaves(state)], state.k)


def small_states(B: int, dev: torch.device, shape=SMALL["shape"], N=SMALL["N"], M=SMALL["M"],
                 frames: int = SMALL["chunks"] * SMALL["C"]):
    """``scripts/scaling_bench.py``'s batch: B synthetic sequences (data
    seed b), its step configuration, states seeded at frame 0. Returns
    (batched state, frames (B, frames, H, W) uint8, K, cfg)."""
    H, W = shape
    cfg = fused.StepConfig(
        lk_levels=3, lk_window=15, lk_iters=5, tile_h=H, tile_w=W,
        n_per_tile=N, tracked_tol=32, e_hypos=64, pnp_hypos=64,
        bundle_size=4, ba_iters=3, traj_cap=32, response="min_eig_xla",
    )
    K = torch.tensor([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], dtype=torch.float32)
    states, imgs = [], []
    for b in range(B):
        seq = synthetic.make_sequence(n_frames=frames + 1, shape=(H, W), density=30, seed=b)
        img0 = torch.as_tensor(seq["images"][0], dtype=torch.float32).to(dev)
        xy, sc, va = grid_extract(img0, N, tile_h=H, tile_w=W, response="min_eig_xla")
        txy, tsc, tva = select_top(xy, sc, va, N)
        table = FeatureTable(xy=txy, valid=tva, score=tsc,
                             landmark=torch.full((N,), -1, dtype=torch.int32, device=dev))
        states.append(fused.init_state(build_pyramid(img0, cfg.lk_levels), table,
                                       MapState.empty(M, device=dev), cfg))
        imgs.append(seq["images"][1:].astype(np.uint8))
    return multi_seq.batch_states(states), np.stack(imgs), K, cfg


def full_states(B: int, dev: torch.device, frames: int = FULL_FRAMES, shape=bench.SHAPE):
    """B KITTI-sized corridors (``bench.build_dataset``'s scene, data seed
    b) at the ``VOConfig`` defaults, each state seeded at frame 0 as
    ``pipeline.segmented`` seeds a segment. Returns what :func:`small_states`
    returns."""
    vo = VOConfig(traj_cap=frames + 2, map_hist=0)
    cfg = step_config(vo, shape)
    states, imgs = [], []
    for b in range(B):
        seq = synthetic.make_sequence(n_frames=frames + 1, shape=shape, K=synthetic.KITTI_K,
                                      density=150.0, speed=1.0, yaw_rate=0.004, seed=b)
        states.append(seed_state(seq["images"][0], vo, cfg, dev))
        imgs.append(seq["images"][1:].astype(np.uint8))
    K = torch.from_numpy(synthetic.KITTI_K.astype(np.float32))
    return multi_seq.batch_states(states), np.stack(imgs), K, cfg


def run_batch(step, state, imgs, K, C: int, dev: torch.device, staged: bool = True):
    """The whole batch, chunk after chunk of C frames, from a copy of
    ``state`` with fresh generators (one per sequence, seeded by its index
    as ``pipeline.segmented`` seeds a segment's). ``staged``: ``imgs`` is
    already a device tensor; else each chunk is uploaded in the loop.
    Returns (the final batched state, seconds)."""
    B, T = imgs.shape[:2]
    gens = segment_generators(0, B, dev)
    gts = torch.ones((B, T), dtype=torch.float32)
    s = _copy(state)
    _sync(dev)
    t0 = time.perf_counter()
    for c0 in range(0, T - C + 1, C):
        chunk = imgs[:, c0: c0 + C] if staged else torch.from_numpy(imgs[:, c0: c0 + C]).to(dev)
        s, _ = step(s, chunk, gts[:, c0: c0 + C].tolist(), gens, K)
    _sync(dev)
    return s, time.perf_counter() - t0


def bench_multi_seq(dev: torch.device, batches=BATCHES, repeats: int = 3, **size) -> list[dict]:
    """``scripts/scaling_bench.py``'s ``multi_seq`` rows: frames/s of the
    whole batch (best of ``repeats``) and the weak efficiency against B=1.
    ``size`` overrides :data:`SMALL`."""
    size = {**SMALL, **size}
    rows, base = [], None
    for B in batches:
        state, imgs, K, cfg = small_states(B, dev, size["shape"], size["N"], size["M"],
                                           size["chunks"] * size["C"])
        step = multi_seq.make_batched_chunk_step(None, cfg, device=dev)
        staged = torch.from_numpy(imgs).to(dev)
        run_batch(step, state, staged, K, size["C"], dev)  # warm
        best = min(run_batch(step, state, staged, K, size["C"], dev)[1] for _ in range(repeats))
        fps = B * imgs.shape[1] / best
        base = fps if base is None else base
        rows.append({"dp": B, "frames_per_sec": fps, "sec": best,
                     "weak_efficiency": fps / (B * base)})
    return rows


def bench_multi_seq_full(dev: torch.device, batches=BATCHES, frames: int = FULL_FRAMES,
                         C: int = FULL_CHUNK, shape=bench.SHAPE) -> list[dict]:
    """``SCALING.json``'s ``tpu_multiseq_dp_per_chip`` rows at full width:
    compute seconds (best of 2, frames on the device) and end-to-end
    seconds (one run, each chunk uploaded in the loop) of B sequences."""
    rows = []
    for B in batches:
        state, imgs, K, cfg = full_states(B, dev, frames, shape)
        step = multi_seq.make_batched_chunk_step(None, cfg, device=dev)
        staged = torch.from_numpy(imgs).to(dev)
        run_batch(step, state, staged, K, C, dev)  # warm
        compute = min(run_batch(step, state, staged, K, C, dev)[1] for _ in range(2))
        e2e = run_batch(step, state, imgs, K, C, dev, staged=False)[1]
        rows.append({"B": B, "frames": B * frames, "compute_s": compute,
                     "compute_fps": B * frames / compute, "e2e_s": e2e,
                     "e2e_fps": B * frames / e2e})
    return rows


# ---------------------------------------------------------------- entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(OUT), help=f"JSON output (default {OUT})")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kind = dev.type
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    out = {
        "device": bench.device_name(dev),
        "cores": len(os.sched_getaffinity(0)),
        "cards": cards,
        "note": (
            f"dist_ba on {max(SHARDS)} lm ranks over {_backend(kind, max(SHARDS))}"
            + (f" sharing {cards} card(s): a check of the sharded work and its "
               "communication, not a scaling claim" if kind == "cuda" and max(SHARDS) > cards
               else "")
            + "; multi_seq steps the batch's sequences one after another in one process"
        ),
    }
    print(f"# {out['device']}, {out['cores']} cores, {cards} card(s)", flush=True)
    legs = {
        "dist_ba": lambda: bench_dist_ba(kind),
        "dist_ba_worksweep": lambda: bench_dist_ba_worksweep(kind),
        "multi_seq": lambda: bench_multi_seq(dev),
        "multi_seq_full": lambda: bench_multi_seq_full(dev),
    }
    failed = []
    for name, leg in legs.items():
        print(f"\n## {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out[name] = leg()
        except Exception:
            failed.append(name)
            out[name] = {"error": traceback.format_exc()}
            print(out[name]["error"], file=sys.stderr, flush=True)
            continue
        for row in out[name]:
            print(json.dumps(row), flush=True)
        out[f"{name}_leg_s"] = time.perf_counter() - t0
    if kind == "cpu" and "multi_seq" in out and not failed:
        # the pinned single-core baseline of the JAX script's multi_seq leg
        t1 = _pinned_multi_seq_seconds()
        for r in out["multi_seq"]:
            r["weak_efficiency_vs_pinned_core"] = (r["frames_per_sec"] / (r["dp"] * 12.0 / t1)
                                                   if t1 else None)
    out["failed"] = failed
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"\nwrote {path}", flush=True)
    return 1 if failed else 0


def _pinned_multi_seq_seconds() -> float | None:
    """B=1 of the small ``multi_seq`` leg on the CPU in a subprocess pinned
    to one core (``taskset -c 0``), best of 3 seconds; None where pinning
    is unavailable."""
    import subprocess

    code = ("import torch; torch.set_num_threads(1); from pmv_tpu_torch import scaling_bench as s; "
            "print('TIME_ONE', s.bench_multi_seq(torch.device('cpu'), batches=(1,))[0]['sec'])")
    try:
        proc = subprocess.run(["taskset", "-c", "0", sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=900)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    found = [ln.split()[1] for ln in proc.stdout.splitlines() if ln.startswith("TIME_ONE ")]
    return float(found[-1]) if found else None


if __name__ == "__main__":
    sys.exit(main())
