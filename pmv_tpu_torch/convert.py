"""Carry state across from the JAX package.

The system has no weights; what crosses between ``pmv_tpu`` and this port is
the per-frame ``StepState``. It travels as a flat dict of numpy arrays keyed
by ``pmv_tpu``'s field names (``table.xy``, ``map.alive``, ``R_hist``,
``tbl_lm_hist``, ``blocks.<lvl>.region|r0|c0``, ...). This module imports no
JAX: whoever holds the JAX state does the ``np.asarray`` on that side.

With ``matcher=knn`` the JAX package's ``blocks`` is ``((image,),)``, the
previous level-0 image; it travels as ``blocks.0.image``. The landmark
snapshots ``map_hist`` travel with all their rows; a dict without them (a
state of the format before snapshots) gives an empty history, as a run with
``map_hist_rows=0`` has.

LK blocks are accepted in either layout of the JAX package — feature-major
``(N, Rg, Rg)`` (``lucas_kanade.capture_blocks``) or feature-lanes
``(Rg, Rg, N)`` (``pallas_lk.capture_blocks``) — and stored ``(N, Rg, Rg)``.

A batch of states (``parallel.multi_seq``) travels as the same dict with a
leading batch axis on every array; :func:`batch_item` takes one state's dict
out of it. What the global refinement reads of a finished run (``R``,
``t``, ``K``, ``map``, ``tables``) travels as a dict too
(:func:`run_from_reference`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.pipeline.fused import StepState

_TABLE = ("xy", "valid", "landmark", "score")
_MAP = ("xyz", "alive", "head")
# The StepState fields that are one tensor each, under their own names
STATE_FIELDS = (
    "R", "t", "R_s", "t_s", "scale", "R_hist", "t_hist",
    "tbl_xy_hist", "tbl_valid_hist", "tbl_lm_hist", "map_hist", "ba_overflow",
)
_DTYPES = {
    "table.valid": torch.bool, "table.landmark": torch.int32,
    "map.alive": torch.bool, "map.head": torch.int32,
    "tbl_valid_hist": torch.bool, "tbl_lm_hist": torch.int32,
    "ba_overflow": torch.int32,
}


def _tensor(d: dict, key: str, device) -> torch.Tensor:
    dtype = _DTYPES.get(key, torch.float32)
    # np.array copies: arrays handed over from JAX are read-only
    return torch.from_numpy(np.array(d[key])).to(device=device, dtype=dtype).contiguous()


def _region(a: np.ndarray, n: int) -> np.ndarray:
    """(N, Rg, Rg) from either block layout."""
    a = np.asarray(a)
    if a.ndim != 3:
        raise ValueError(f"LK block must be 3-D, got shape {a.shape}")
    if a.shape[0] == n and a.shape[1] == a.shape[2]:
        return a
    if a.shape[2] == n and a.shape[0] == a.shape[1]:
        return np.transpose(a, (2, 0, 1))
    raise ValueError(f"LK block of shape {a.shape} fits no layout for N={n}")


def state_from_reference(d: dict[str, np.ndarray], device) -> StepState:
    """Build a :class:`StepState` on ``device`` from the flat dict."""
    n = np.asarray(d["table.xy"]).shape[0]
    if "blocks.0.image" in d:
        blocks = ((_tensor(d, "blocks.0.image", device),),)
    else:
        levels = sorted({int(k.split(".")[1]) for k in d if k.startswith("blocks.")})
        blocks = tuple(
            (
                torch.from_numpy(_region(d[f"blocks.{l}.region"], n).astype(np.float32))
                .to(device).contiguous(),
                torch.from_numpy(np.array(d[f"blocks.{l}.r0"])).to(device, torch.int32),
                torch.from_numpy(np.array(d[f"blocks.{l}.c0"])).to(device, torch.int32),
            )
            for l in levels
        )
    table = FeatureTable(*(_tensor(d, f"table.{f}", device) for f in _TABLE))
    map_state = MapState(*(_tensor(d, f"map.{f}", device) for f in _MAP))
    rest = {k: _tensor(d, k, device) for k in STATE_FIELDS if k in d}
    if "map_hist" not in rest:
        rest["map_hist"] = torch.zeros((0, map_state.capacity, 3), device=device)
    if "ba_overflow" not in rest:
        rest["ba_overflow"] = torch.zeros((), dtype=torch.int32, device=device)
    return StepState(
        blocks=blocks, table=table, map=map_state, k=int(np.asarray(d["k"])), **rest
    )


def state_to_numpy(state: StepState) -> dict[str, np.ndarray]:
    """The inverse of :func:`state_from_reference` (blocks feature-major)."""
    out: dict[str, np.ndarray] = {}
    if len(state.blocks[0]) == 1:  # matcher=knn: the previous level-0 image
        out["blocks.0.image"] = state.blocks[0][0].cpu().numpy()
    else:
        for l, (region, r0, c0) in enumerate(state.blocks):
            out[f"blocks.{l}.region"] = region.cpu().numpy()
            out[f"blocks.{l}.r0"] = r0.cpu().numpy()
            out[f"blocks.{l}.c0"] = c0.cpu().numpy()
    for f in _TABLE:
        out[f"table.{f}"] = getattr(state.table, f).cpu().numpy()
    for f in _MAP:
        out[f"map.{f}"] = getattr(state.map, f).cpu().numpy()
    for k in STATE_FIELDS:
        v = getattr(state, k)
        if v is not None:
            out[k] = v.cpu().numpy()
    out["k"] = np.asarray(state.k, np.int32)
    return out


def batch_item(d: dict[str, np.ndarray], b: int) -> dict[str, np.ndarray]:
    """State ``b`` of a batched state's flat dict (every array's leading
    axis is the batch)."""
    return {k: np.asarray(v)[b] for k, v in d.items()}


@dataclass
class FinishedRun:
    """What the global refinement reads of a finished run, as an
    ``OdometryPipeline`` holds it after ``run()``: per-frame poses (float64
    numpy lists, which the refinement replaces), intrinsics, the end-of-run
    map and the per-frame tables."""

    R: list
    t: list
    K: torch.Tensor
    map: MapState
    tables: list


def run_from_reference(d: dict[str, np.ndarray], device) -> FinishedRun:
    """A :class:`FinishedRun` on ``device`` from a flat dict: ``R`` (n, 3,
    3), ``t`` (n, 3), ``K``, ``map.xyz|alive|head`` and ``tables.xy|valid|
    landmark|score`` (n, N, ...)."""
    n = np.asarray(d["t"]).shape[0]
    tables = [
        FeatureTable(*(torch.from_numpy(np.array(d[f"tables.{f}"][i])).to(
            device=device, dtype=_DTYPES.get(f"table.{f}", torch.float32)) for f in _TABLE))
        for i in range(n)
    ]
    return FinishedRun(
        R=[np.asarray(r, np.float64) for r in np.asarray(d["R"])],
        t=[np.asarray(x, np.float64) for x in np.asarray(d["t"])],
        K=_tensor(d, "K", device),
        map=MapState(*(_tensor(d, f"map.{f}", device) for f in _MAP)),
        tables=tables,
    )


def run_to_numpy(run) -> dict[str, np.ndarray]:
    """The inverse of :func:`run_from_reference`, from a finished
    ``OdometryPipeline`` or a :class:`FinishedRun`."""
    out = {"R": np.stack(run.R), "t": np.stack(run.t), "K": run.K.cpu().numpy()}
    for f in _MAP:
        out[f"map.{f}"] = getattr(run.map, f).cpu().numpy()
    for f in _TABLE:
        out[f"tables.{f}"] = np.stack([getattr(tb, f).cpu().numpy() for tb in run.tables])
    return out
