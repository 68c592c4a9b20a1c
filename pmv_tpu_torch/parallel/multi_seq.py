"""Multi-sequence visual odometry: a batch of independent VO states —
PyTorch counterpart of ``pmv_tpu/parallel/multi_seq.py``.

Independent sequences, or independent segments of one long sequence
(``pipeline.segmented``), are tracked side by side. The JAX package maps
``fused.chunk_step`` over the batch with ``lax.map`` (a scan that keeps real
per-sequence conditionals) and, with a mesh, shards the batch over the
``dp`` axis with ``shard_map``, replicated over ``lm``. Here the batch is a
loop over its states: each goes through the port's ``chunk_step`` with its
own ``torch.Generator``, so every state launches the kernels it would
launch alone and ends exactly where it would alone. On a mesh a rank steps
its own rows of the batch (:func:`local_rows`; ranks of one dp row step the
same rows), and the step issues no collective: the sequences are
independent, as the JAX package's
``tests/test_parallel_flow.py::test_dp_step_has_no_collectives`` holds
there. A caller that needs the whole batch all-gathers it over dp after the
step. A batched launch of the kernels is not ported.

A batched state is a ``StepState`` whose every tensor has a leading batch
axis; ``k`` stays one host integer, the same for every state.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch import resolve_device
from pmv_tpu_torch.parallel.mesh import Mesh
from pmv_tpu_torch.pipeline import fused
from pmv_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def _leaves(state: fused.StepState) -> list[Tensor]:
    """Every tensor of a state, in a fixed order."""
    out = [part for level in state.blocks for part in level]
    out += list(state.table) + list(state.map)
    out += [getattr(state, f) for f in fused.StepState._fields
            if f not in ("blocks", "table", "map", "k")]
    return out


def _rebuild(like: fused.StepState, leaves: list[Tensor], k: int) -> fused.StepState:
    """The state of ``like``'s structure with ``leaves`` in its places."""
    it = iter(leaves)
    blocks = tuple(tuple(next(it) for _ in level) for level in like.blocks)
    table = type(like.table)(*(next(it) for _ in like.table))
    map_state = type(like.map)(*(next(it) for _ in like.map))
    rest = {f: next(it) for f in fused.StepState._fields
            if f not in ("blocks", "table", "map", "k")}
    return fused.StepState(blocks=blocks, table=table, map=map_state, k=k, **rest)


def batch_states(states: list[fused.StepState]) -> fused.StepState:
    """Stack per-sequence states into one batched state (all at one ``k``)."""
    ks = {s.k for s in states}
    if len(ks) != 1:
        raise ValueError(f"states at different frames {sorted(ks)} cannot be batched")
    stacked = [torch.stack(xs) for xs in zip(*(_leaves(s) for s in states))]
    return _rebuild(states[0], stacked, ks.pop())


def state_at(batched: fused.StepState, b: int) -> fused.StepState:
    """State ``b`` of a batched state: views into the batched tensors, so
    the in-place history writes of ``chunk_step`` land in the batch."""
    return _rebuild(batched, [x[b] for x in _leaves(batched)], batched.k)


def _put(batched: fused.StepState, b: int, state: fused.StepState) -> None:
    """Write state ``b`` of the batch in place (a tensor that already is
    the batch's view, as an in-place updated history is, is left)."""
    for dst, src in zip(_leaves(batched), _leaves(state)):
        view = dst[b]
        if src.data_ptr() != view.data_ptr() or src.stride() != view.stride():
            view.copy_(src)


def local_rows(mesh: Mesh, B: int) -> range:
    """The rows of a batch of ``B`` states that this rank steps on
    ``mesh``: [d*B/dp, (d+1)*B/dp) for dp coordinate d, the block
    ``shard_map`` gives it in the JAX package."""
    dp, d = mesh.shape["dp"], mesh.coord["dp"]
    if B % dp:
        raise ValueError(f"a batch of {B} states does not split over dp={dp}")
    n = B // dp
    return range(d * n, (d + 1) * n)


def make_batched_chunk_step(mesh: Mesh | None, cfg: fused.StepConfig, device=None):
    """The batched chunk step: on ``device`` (``None``: the GPU, an error
    without one) with ``mesh=None``; on the mesh's device with a mesh, where
    it takes this rank's rows of the batch (:func:`local_rows`) and issues
    no collective.

    Signature: (state (B, ...), imgs_u8 (B, C, H, W), gt_steps (B, C),
    gens (B generators or None), K (3, 3)) -> (state, stats), ``stats`` a
    list of B lists of per-frame stats, B the rows the caller hands in. The
    batched state is updated in place and returned with the new ``k``.
    """
    if mesh is None:
        dev = resolve_device(device)
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh) or None, not {type(mesh).__name__}")
    elif device is not None:
        raise ValueError("with a mesh the step runs on the mesh's device; pass device=None")
    else:
        dev = mesh.device
        if cfg.response == "min_eig":
            # The JAX package swaps its Pallas response for the XLA one under
            # shard_map; in the port both names run the min_eig_response
            # kernel (frontend/corners.py), so the swap changes nothing.
            cfg = cfg._replace(response="min_eig_xla")

    @torch.no_grad()
    def batched(state, imgs_u8, gt_steps, gens, K):
        on = state.R.device
        if on.type != dev.type or dev.index not in (None, on.index):
            raise ValueError(f"the batched state lies on {on}, the step runs on {dev}")
        imgs_u8 = torch.as_tensor(imgs_u8).to(dev)
        K = K.to(dev)
        B = state.R.shape[0]
        gens = [None] * B if gens is None else gens
        stats, k = [], state.k
        for b in range(B):
            with span("multi_seq.state"):
                out, st = fused.chunk_step(state_at(state, b), imgs_u8[b], gt_steps[b], gens[b], K, cfg)
            with span("multi_seq.put"):
                _put(state, b, out)
            stats.append(st)
            k = out.k
        return state._replace(k=k), stats

    return batched
