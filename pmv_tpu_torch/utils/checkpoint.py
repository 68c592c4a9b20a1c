"""Checkpoint / resume for pipeline runs — PyTorch counterpart of
``pmv_tpu/utils/checkpoint.py``.

A snapshot is one compressed npz with the JAX package's keys and
``FORMAT_VERSION``: the fused loop's ``StepState`` (per-level block tuples,
feature table, landmark map, poses, trajectory and table histories,
``map_hist``) or the modular pipeline's host lists. It adds one key of its
own, ``rng_state``: the state of the ``torch.Generator`` that feeds the
RANSAC draws. The port draws from one generator consumed in order, not from
keys split per frame ahead of the run, so a resumed run repeats the
uninterrupted one bit for bit only if the generator stands where it stood at
the snapshot. A snapshot written by ``pmv_tpu`` carries no ``rng_state``,
and one written on another kind of device carries a state that does not fit
the caller's generator; both load, and the generator is left as it is.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pmv_tpu_torch import convert, resolve_device
from pmv_tpu_torch.core.state import FeatureTable, MapState

FORMAT_VERSION = 3  # v3: StepState gained the landmark-snapshot history
# (map_hist); v2 added the per-frame table history


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _restore_generator(z, generator: torch.Generator | None) -> None:
    """Put ``generator`` where the snapshot's generator stood. A generator's
    state is device-specific (16 bytes on a CUDA device: seed and offset; a
    few kilobytes on the CPU), so a state that does not fit leaves the
    generator as it is, as a snapshot without one (written by ``pmv_tpu``)
    does; the run then loads, but its later RANSAC draws are not the
    uninterrupted run's."""
    if generator is None:
        return
    if "rng_state" not in z.files:
        print("pmv_tpu_torch: the snapshot holds no generator state; "
              "the RANSAC generator is left as it is", flush=True)
        return
    saved = torch.from_numpy(np.array(z["rng_state"], np.uint8))
    have = generator.get_state()
    if saved.numel() != have.numel():
        print(f"pmv_tpu_torch: the snapshot's generator state ({saved.numel()} bytes) does "
              f"not fit a {generator.device.type} generator ({have.numel()} bytes); "
              "the RANSAC generator is left as it is", flush=True)
        return
    generator.set_state(saved)


def save_fused_state(
    state, path: str | Path, generator: torch.Generator | None = None, **meta
) -> None:
    """Snapshot a fused-loop ``StepState`` (pipeline/fused.py) mid-run, with
    the state of ``generator`` when one is given, so that ``chunk_step``
    resumes mid-sequence bit-identically."""
    data: dict = {"fused_version": FORMAT_VERSION, "n_levels": len(state.blocks)}
    # Blocks are per-level tuples: (region, r0, c0) for the LK matchers, a
    # 1-tuple (previous level-0 image) for knn.
    for lvl, parts in enumerate(state.blocks):
        data[f"blk{lvl}_n"] = len(parts)
        for j, part in enumerate(parts):
            data[f"blk{lvl}_p{j}"] = _np(part)
    for name in ("xy", "valid", "landmark", "score"):
        data[f"tbl_{name}"] = _np(getattr(state.table, name))
    for name in ("xyz", "alive", "head"):
        data[f"map_{name}"] = _np(getattr(state.map, name))
    for name in convert.STATE_FIELDS:
        data[name] = _np(getattr(state, name))
    data["k"] = np.asarray(state.k, np.int32)
    if generator is not None:
        data["rng_state"] = _np(generator.get_state())
    for key, val in meta.items():
        data[f"meta_{key}"] = val
    np.savez_compressed(path, **data)


def load_fused_state(
    path: str | Path, device=None, generator: torch.Generator | None = None
):
    """Restore a fused-loop ``StepState`` with every tensor on ``device``
    (``None``: the GPU). Restores ``generator`` to the snapshot's state when
    both are there. Returns (state, meta dict)."""
    z = np.load(path)
    if int(z["fused_version"]) != FORMAT_VERSION:
        raise ValueError(
            f"fused checkpoint version {z['fused_version']} != {FORMAT_VERSION}"
        )
    d: dict[str, np.ndarray] = {}
    for lvl in range(int(z["n_levels"])):
        parts = [z[f"blk{lvl}_p{j}"] for j in range(int(z[f"blk{lvl}_n"]))]
        if len(parts) == 1:
            d[f"blocks.{lvl}.image"] = parts[0]
        else:
            for name, part in zip(("region", "r0", "c0"), parts):
                d[f"blocks.{lvl}.{name}"] = part
    for name in ("xy", "valid", "landmark", "score"):
        d[f"table.{name}"] = z[f"tbl_{name}"]
    for name in ("xyz", "alive", "head"):
        d[f"map.{name}"] = z[f"map_{name}"]
    for name in convert.STATE_FIELDS + ("k",):
        d[name] = z[name]
    state = convert.state_from_reference(d, resolve_device(device))
    _restore_generator(z, generator)
    meta = {key[len("meta_"):]: z[key] for key in z.files if key.startswith("meta_")}
    return state, meta


def save(pipe, path: str | Path) -> None:
    """Snapshot an OdometryPipeline mid- or post-run (the modular loop's
    host lists, map and per-frame tables)."""
    tables = pipe.tables

    def stack(field, empty):
        return np.stack([_np(getattr(tb, field)) for tb in tables]) if tables else empty

    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        init_offset=pipe.init_offset,
        scale=pipe.scale,
        runtime=pipe.runtime,
        rng_state=_np(pipe._gen.get_state()),
        R=np.stack(pipe.R) if pipe.R else np.zeros((0, 3, 3)),
        t=np.stack(pipe.t) if pipe.t else np.zeros((0, 3)),
        R_s=np.stack(pipe.R_s) if pipe.R_s else np.zeros((0, 3, 3)),
        t_s=np.stack(pipe.t_s) if pipe.t_s else np.zeros((0, 3)),
        map_xyz=_np(pipe.map.xyz),
        map_alive=_np(pipe.map.alive),
        map_head=_np(pipe.map.head),
        tbl_xy=stack("xy", np.zeros((0, 0, 2))),
        tbl_valid=stack("valid", np.zeros((0, 0), bool)),
        tbl_landmark=stack("landmark", np.zeros((0, 0), np.int32)),
        tbl_score=stack("score", np.zeros((0, 0))),
    )


def load(pipe, path: str | Path) -> None:
    """Restore a snapshot into an OdometryPipeline (same config/dataset),
    onto the pipeline's device."""
    z = np.load(path)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {z['version']} != {FORMAT_VERSION}")
    dev = pipe.device

    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)

    pipe.init_offset = int(z["init_offset"])
    pipe.scale = float(z["scale"])
    pipe.runtime = float(z["runtime"])
    _restore_generator(z, pipe._gen)
    pipe.R = [r for r in z["R"]]
    pipe.t = [x for x in z["t"]]
    pipe.R_s = [r for r in z["R_s"]]
    pipe.t_s = [x for x in z["t_s"]]
    pipe.map = MapState(
        xyz=t(z["map_xyz"], torch.float32),
        alive=t(z["map_alive"], torch.bool),
        head=t(z["map_head"], torch.int32),
    )
    pipe.tables = [
        FeatureTable(
            xy=t(z["tbl_xy"][i], torch.float32),
            valid=t(z["tbl_valid"][i], torch.bool),
            landmark=t(z["tbl_landmark"][i], torch.int32),
            score=t(z["tbl_score"][i], torch.float32),
        )
        for i in range(z["tbl_xy"].shape[0])
    ]
