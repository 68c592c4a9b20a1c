"""Device-mesh construction — PyTorch counterpart of
``pmv_tpu/parallel/mesh.py``, on ``torch.distributed``.

The JAX package's mesh is single-controller: one process sees every device,
and ``shard_map`` runs a function on each device's block of global arrays.
PyTorch's is multi-controller: one process per rank, joined by a process
group; every rank runs the same program on its own block and exchanges
partial results by collectives. The two axes are the JAX package's:

- ``dp`` — independent BA windows / sequences (data parallelism);
- ``lm`` — the landmark blocks of one BA problem; the reduced camera system
  is all-reduced over it.

:func:`make_mesh` lays a (dp, lm) grid over the ranks of the initialised
process group, rank r at (r // lm, r % lm), with
``torch.distributed.device_mesh.init_device_mesh`` (which also admits more
ranks than cards when their number is a multiple of the cards'), and wraps
it in :class:`Mesh`. A rank works on ``cuda:(local_rank % device_count)``,
so several ranks may share one card: over ``gloo``, since NCCL refuses two
ranks on one device. :func:`initialize_multihost` joins the process group;
:func:`launch` starts ranks as processes of this host — in PyTorch that is
how several devices come to exist, where in JAX they are implicit in one
process.

The collectives themselves live with the code that issues them:
``ba.schur_lm.all_reduce_sum`` and ``parallel.dist_ba.all_gather_cat``.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import queue
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pmv_tpu_torch import resolve_device

log = logging.getLogger(__name__)

AXES = ("dp", "lm")


class Mesh:
    """This rank's view of a (dp, lm) mesh: the ``DeviceMesh``
    (``device_mesh``), the size of each axis by name (``shape["lm"]``, as a
    JAX mesh gives it), this rank's coordinate (``coord["dp"]``), the
    process group of each axis (:meth:`group`), the rank's device and the
    backend."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = dict(zip(AXES, device_mesh.shape))
        self.coord = dict(zip(AXES, device_mesh.get_coordinate()))
        self.backend = dist.get_backend()

    def group(self, axis: str):
        """The process group of this rank's row along ``axis``: the ranks
        that differ from it only in that coordinate, in coordinate order."""
        return self.device_mesh.get_group(axis)


def local_rank() -> int:
    """The rank among this host's processes: ``LOCAL_RANK`` where a
    launcher (torchrun) sets it, else the global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_device(device_type=None) -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` for CUDA
    (``None`` means CUDA, an error without a card), the CPU for ``"cpu"``."""
    kind = resolve_device(device_type).type
    if kind == "cuda":
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return torch.device(kind)


def make_mesh(dp: int = 1, lm: int | None = None, device_type=None) -> Mesh:
    """Build a (dp, lm) mesh over the ranks of the initialised process
    group (``lm=None``: world // dp) on ``device_type`` (``None``: CUDA)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call "
                           "initialize_multihost first, or start the ranks with launch")
    n = dist.get_world_size()
    if lm is None:
        lm = n // dp
    if dp * lm != n:
        raise ValueError(f"mesh {dp}x{lm} != {n} devices")
    from torch.distributed.device_mesh import init_device_mesh

    device = rank_device(device_type)
    if device.type == "cuda":
        # chosen here, so that the DeviceMesh keeps it
        torch.cuda.set_device(device)
    return Mesh(init_device_mesh(device.type, (dp, lm), mesh_dim_names=AXES), device)


def default_backend(device_type=None) -> str:
    """``nccl`` where the rank's device is CUDA, ``gloo`` on the CPU."""
    if device_type is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device_type).type == "cuda" else "gloo"


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: float = 600.0,
) -> bool:
    """Join the ``torch.distributed`` process group. Returns True when it
    is (now or already) initialised.

    With ``coordinator`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` it initialises with ``init_method="tcp://coordinator"``.
    With no argument it reads a launcher's environment (torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), and returns
    False where there is none. ``backend`` defaults to :func:`default_backend`.

    Failures are not swallowed: explicit arguments that fail (a coordinator
    nobody serves, a peer that never joins within ``timeout`` seconds) raise,
    as does a launcher's environment that fails; nothing degrades to one
    process. Only "already initialised" and "no launcher" are benign.
    """
    if dist.is_initialized():
        log.info("torch.distributed already initialised (rank %d of %d)",
                 dist.get_rank(), dist.get_world_size())
        return True
    explicit = (coordinator, num_processes, process_id)
    if all(a is None for a in explicit):
        env = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
        if not all(k in os.environ for k in env):
            log.info("no launcher environment (%s): not initialised", ", ".join(env))
            return False
        init = dict(init_method="env://")
    elif any(a is None for a in explicit):
        raise ValueError("coordinator, num_processes and process_id go together; got "
                         f"{coordinator!r}, {num_processes!r}, {process_id!r}")
    else:
        init = dict(init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id)
    dist.init_process_group(backend or default_backend(),
                            timeout=datetime.timedelta(seconds=timeout), **init)
    return True


# --------------------------------------------------------------------------
# launch
# --------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port of this host that was free a moment ago (bound to port 0
    and released), so that launches in parallel processes do not collide."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, port, backend, args, timeout, results) -> None:
    """One rank: join the group, run ``fn(rank, *args)``, hand back its
    pickled result (or the traceback) and leave the group."""
    # the first multi-threaded torch.sqrt of a fresh CPU process has been
    # seen to be wrong in one thread's share; and ranks share the host
    torch.set_num_threads(1)
    try:
        initialize_multihost(f"127.0.0.1:{port}", nprocs, rank, backend, timeout=timeout)
        payload = pickle.dumps(fn(rank, *args))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    results.put((rank, True, payload))
    dist.destroy_process_group()


def launch(fn, nprocs: int, backend: str | None = None, device_type=None, args=(),
           timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes of this host
    (``torch.multiprocessing``, spawn start method), joined into one process
    group at a free port of 127.0.0.1 through :func:`initialize_multihost`.
    ``fn`` must be importable by name (a module-level function); it
    typically builds its mesh with :func:`make_mesh`.

    ``device_type``: ``None`` means CUDA (an error without a card);
    ``backend`` defaults to ``nccl`` for CUDA and ``gloo`` for the CPU.
    Each rank runs one thread and leaves the group when ``fn`` returns.

    Returns every rank's result, in rank order. A rank that raises, exits
    without a result or with a non-zero code, or is not done within
    ``timeout`` seconds raises here (with that rank's traceback), and every
    rank still running is killed."""
    device_type = resolve_device(device_type).type
    backend = backend or default_backend(device_type)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, port, backend, tuple(args), timeout, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                gone = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if gone:
                    try:  # a result put just before the exit may still be in the pipe
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {gone[0]} exited with code {procs[gone[0]].exitcode} and no result"
                        ) from None
                elif time.monotonic() > deadline:
                    missing = [r for r in range(nprocs) if r not in out]
                    raise TimeoutError(f"ranks {missing} of {nprocs} not done within {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} ({backend}) failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=60)
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad} after returning their results")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(nprocs)]
