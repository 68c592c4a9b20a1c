"""Weak-scaling probe of the landmark-sharded BA, and its communication
count — PyTorch counterpart of ``pmv_tpu/parallel/probe.py``.

Ranks that share a host's cores time-share them, so a naive one-rank against
n-rank timing measures oversubscription, not the algorithm. The honest
configuration, as in the JAX package: a one-shard baseline pinned to ONE
core (a subprocess under ``taskset``) against a ``min(n, cores)``-rank
``lm`` mesh with equal work per shard (:func:`run_probe`). The ranks are
started by ``parallel.mesh.launch``: NCCL on the cards, and ``gloo`` where
the caller asks for the CPU. ``device_type=None`` means the card, as
everywhere in the package, and raises without one.

Only the measured legs are ported. The JAX package's "analytic ICI
efficiency" leg (a v5e chip's compute at 30x a host core, 15 us of ICI
latency per LM iteration) models a TPU, and no TPU figure enters the port.

:func:`comm_profile` is the port's counterpart of the JAX package's count of
collectives in the compiled program (tests/test_dist_ba.py): it counts the
``torch.distributed`` calls one solve issues, and their elements, per LM
iteration and for the final gather.

    python -m pmv_tpu_torch.parallel.probe Ls iters [--device cpu]   # prints PROBE_ONE <seconds>
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pmv_tpu_torch import resolve_device
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.parallel import dist_ba
from pmv_tpu_torch.parallel.mesh import launch, make_mesh

ROOT = Path(__file__).resolve().parents[2]
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor")


def weak_ba_args(n_shards: int, Ls: int = 512, P: int = 5, seed: int = 0):
    """A BA window with exactly ``Ls`` landmarks (each observed by every
    pose) per landmark shard: total work grows with the mesh while per-shard
    work stays fixed — the weak-scaling unit. Returns the solver's eight
    arguments (D=1 window) as float32 / int32 / bool CPU tensors."""
    rng = np.random.default_rng(seed)
    L = n_shards * Ls
    K = torch.tensor([[200.0, 0, 96.0], [0, 200.0, 64.0], [0, 0, 1.0]])
    R = torch.eye(3)
    ts = [torch.tensor([0.0, 0.0, -float(i)]) for i in range(P)]
    X = np.stack([rng.uniform(-10, 10, L), rng.uniform(-5, 5, L), rng.uniform(-40, -15, L)],
                 -1).astype(np.float32)
    tr = torch.stack([geo.pose_to_ba_params(R, t) for t in ts]).numpy()
    uv = np.concatenate([geo.project_points(torch.from_numpy(X), R, t, K).numpy() for t in ts])
    tr_noisy = tr + rng.normal(0, 0.01, tr.shape).astype(np.float32)
    tr_noisy[:2] = tr[:2]
    pose_free = np.array([False, False] + [True] * (P - 2))
    uv, pose, lml, mask, _, _ = dist_ba.partition_obs_by_landmark(
        uv.astype(np.float32), np.repeat(np.arange(P, dtype=np.int32), L),
        np.tile(np.arange(L, dtype=np.int32), P), np.ones(P * L, bool), L, n_shards,
    )
    lm = X + rng.normal(0, 0.1, X.shape).astype(np.float32)
    return (torch.from_numpy(tr_noisy)[None], torch.from_numpy(lm)[None],
            torch.from_numpy(uv)[None], torch.from_numpy(pose)[None],
            torch.from_numpy(lml)[None], torch.from_numpy(mask)[None],
            torch.from_numpy(pose_free)[None], K)


@contextlib.contextmanager
def count_collectives():
    """While active, every call of ``torch.distributed.all_reduce``,
    ``all_gather`` and ``all_gather_into_tensor`` is recorded as (name,
    elements) in the list it yields; the functions are restored after."""
    calls: list[tuple[str, int]] = []
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name, fn):
        def wrapper(*args, **kw):
            t = args[1] if name != "all_reduce" else args[0]
            calls.append((name, t.numel()))
            return fn(*args, **kw)
        return wrapper

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _tally(calls, names) -> dict:
    picked = [n for name, n in calls if name in names]
    return {"calls": len(picked), "elements": sum(picked)}


def comm_profile(mesh, args, iters: int = 2, mode: str = "schur") -> dict:
    """The collectives of one solve of ``make_distributed_ba(mesh)`` on
    ``args``: all-reduces per LM iteration (the difference between a solve
    of ``iters + 1`` and one of ``iters`` iterations), all-reduces outside
    the iterations (the initial cost), and the final all-gathers — each as
    {"calls", "elements"}. Every rank of ``mesh`` must call it."""
    runs = []
    for n in (iters, iters + 1):
        solver = dist_ba.make_distributed_ba(mesh, iters=n, mode=mode)
        with count_collectives() as calls:
            solver(*args)
        runs.append(calls)
    once, more = _tally(runs[0], ("all_reduce",)), _tally(runs[1], ("all_reduce",))
    per_iter = {k: more[k] - once[k] for k in once}
    return {
        "per_iteration": {"all_reduce": per_iter},
        "once": {"all_reduce": {k: once[k] - iters * per_iter[k] for k in once}},
        "final_gather": _tally(runs[0], ("all_gather", "all_gather_into_tensor")),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_seconds(solver, args, device: torch.device, repeats: int) -> float:
    """Best-of-``repeats`` seconds of ``solver(*args)`` on this rank, after
    one untimed call, each call started after a barrier of the group."""
    solver(*args)
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        dist.barrier()
        t0 = time.perf_counter()
        solver(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _time_rank(rank, n_shards, Ls, iters, repeats, device_type):
    """One rank of :func:`time_sharded_solve`."""
    mesh = make_mesh(dp=1, lm=n_shards, device_type=device_type)
    solver = dist_ba.make_distributed_ba(mesh, iters=iters)
    args = [a.to(mesh.device) for a in weak_ba_args(n_shards, Ls=Ls)]
    return best_seconds(solver, args, mesh.device, repeats)


def time_sharded_solve(n_shards: int, Ls: int, iters: int, repeats: int = 5,
                       device_type=None, backend: str | None = None) -> float:
    """Best-of-N seconds (rank 0's) for one ``iters``-iteration solve on an
    ``n_shards``-rank lm mesh started by ``launch`` on ``device_type``
    (``None``: the cards, over NCCL; ``"cpu"``: gloo). ``backend="gloo"``
    lets ranks share a card (NCCL refuses two ranks on one card)."""
    kind = resolve_device(device_type).type
    return launch(_time_rank, n_shards, backend=backend, device_type=kind,
                  args=(n_shards, Ls, iters, repeats, kind))[0]


def _pinned(cores: list[int], Ls: int, iters: int, timeout: int, device_type):
    """Start one one-shard solve on ``device_type`` per core, each pinned to
    its core; returns each one's seconds, or None where pinning or the run
    failed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    try:
        procs = [subprocess.Popen(
            ["taskset", "-c", str(c), sys.executable, "-m", "pmv_tpu_torch.parallel.probe",
             str(Ls), str(iters), "--device", resolve_device(device_type).type],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env) for c in cores]
    except FileNotFoundError:
        return None
    times = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            return None
        found = [ln.split()[1] for ln in out.splitlines() if ln.startswith("PROBE_ONE ")]
        times.append(float(found[-1]) if found else None)
    return None if None in times else times


def pinned_one_shard_seconds(Ls: int, iters: int, timeout: int = 600,
                             device_type=None) -> float | None:
    """The one-shard baseline on ``device_type`` in a subprocess pinned to
    ONE core (``taskset -c 0``). Returns None where pinning is unavailable
    (no taskset, a failed subprocess)."""
    times = _pinned([0], Ls, iters, timeout, device_type)
    return None if times is None else times[0]


def contention_probe(Ls: int = 8192, iters: int = 3, n_procs: int = 2, timeout: int = 900,
                     device_type=None) -> dict:
    """Isolation experiment for the small-Ls weak-scaling gap: ``n_procs``
    INDEPENDENT one-shard solves pinned to distinct cores and run at once
    (no communication, no sharding), against the solo pinned baseline. A
    concurrent slowdown like the sharded mesh's points at the host's memory
    system, not at the sharded solver. Returns solo / concurrent seconds and
    the implied zero-communication efficiency."""
    solo = pinned_one_shard_seconds(Ls, iters, timeout=timeout, device_type=device_type)
    if solo is None:
        return {"error": "taskset pinning unavailable"}
    times = _pinned(list(range(n_procs)), Ls, iters, timeout, device_type)
    if times is None:
        return {"error": "a concurrent pinned solve failed or timed out"}
    return {"Ls": Ls, "iters": iters, "n_procs": n_procs, "sec_solo_pinned": solo,
            "sec_concurrent_each": times, "zero_comm_efficiency": solo / max(times)}


def run_probe(n_devices: int, Ls: int = 8192, iters: int = 3, device_type=None) -> dict:
    """The measured weak-scaling efficiency on ``device_type`` (``None``:
    the cards): the pinned one-core one-shard baseline against a c-rank lm
    mesh (c = min(n_devices, cores), and at most the cards there are) doing
    c x the work, at ``Ls`` landmarks a shard and at 4x that (the global
    refinement's regime: the probe's unit has 5 observations a landmark).
    Measured legs only (see the module's docstring)."""
    kind = resolve_device(device_type).type
    c = min(n_devices, len(os.sched_getaffinity(0)))
    if kind == "cuda":
        c = min(c, torch.cuda.device_count())
    result: dict = {"Ls_per_shard": Ls, "iters": iters, "mesh_devices": c, "device": kind}
    t_c = time_sharded_solve(c, Ls, iters, device_type=kind)
    result["sec_mesh"] = t_c
    t_1 = pinned_one_shard_seconds(Ls, iters, device_type=kind) if c >= 2 else None
    if t_1 is not None:
        result["sec_1dev_pinned"] = t_1
        result["measured_efficiency"] = t_1 / t_c
        Ls_refine = 4 * Ls
        t_c2 = time_sharded_solve(c, Ls_refine, iters, device_type=kind)
        t_12 = pinned_one_shard_seconds(Ls_refine, iters, device_type=kind)
        if t_12 is not None:
            result["Ls_refine"] = Ls_refine
            result["sec_mesh_refine"] = t_c2
            result["sec_1dev_pinned_refine"] = t_12
            result["measured_efficiency_refine"] = t_12 / t_c2
    return result


def _main() -> None:
    ap = argparse.ArgumentParser(description="seconds of one one-shard solve")
    ap.add_argument("Ls", type=int)
    ap.add_argument("iters", type=int)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    print(f"PROBE_ONE {time_sharded_solve(1, args.Ls, args.iters, device_type=args.device)}", flush=True)


if __name__ == "__main__":
    _main()
