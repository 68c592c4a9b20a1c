"""Carry state across from the JAX package.

The system has no weights; what crosses between ``pmv_tpu`` and this port is
the per-frame ``StepState``. It travels as a flat dict of numpy arrays keyed
by ``pmv_tpu``'s field names (``table.xy``, ``map.alive``, ``R_hist``,
``tbl_lm_hist``, ``blocks.<lvl>.region|r0|c0``, ...). This module imports no
JAX: whoever holds the JAX state does the ``np.asarray`` on that side.

LK blocks are accepted in either layout of the JAX package — feature-major
``(N, Rg, Rg)`` (``lucas_kanade.capture_blocks``) or feature-lanes
``(Rg, Rg, N)`` (``pallas_lk.capture_blocks``) — and stored ``(N, Rg, Rg)``.
"""

from __future__ import annotations

import numpy as np
import torch

from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.pipeline.fused import StepState

_TABLE = ("xy", "valid", "landmark", "score")
_MAP = ("xyz", "alive", "head")
_PLAIN = (
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
    levels = sorted(
        {int(k.split(".")[1]) for k in d if k.startswith("blocks.")}
    )
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
    rest = {k: _tensor(d, k, device) for k in _PLAIN if k in d}
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
    for l, (region, r0, c0) in enumerate(state.blocks):
        out[f"blocks.{l}.region"] = region.cpu().numpy()
        out[f"blocks.{l}.r0"] = r0.cpu().numpy()
        out[f"blocks.{l}.c0"] = c0.cpu().numpy()
    for f in _TABLE:
        out[f"table.{f}"] = getattr(state.table, f).cpu().numpy()
    for f in _MAP:
        out[f"map.{f}"] = getattr(state.map, f).cpu().numpy()
    for k in _PLAIN:
        v = getattr(state, k)
        if v is not None:
            out[k] = v.cpu().numpy()
    out["k"] = np.asarray(state.k, np.int32)
    return out
