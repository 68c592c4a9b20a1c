"""Fixed-capacity, mask-based pipeline state — PyTorch counterpart of
``pmv_tpu/core/state.py``.

The reference keeps a dynamic ``shared_ptr``/``weak_ptr`` graph of features
and landmarks (include/Frame.h:25-27, include/OdometryPipeline.h:49). Here
that is fixed-capacity struct-of-tensors tables with validity masks:

- :class:`FeatureTable` replaces ``Frame::map`` + ``feat_corr``: slot ``i`` in
  frame ``k`` corresponds to slot ``i`` in frame ``k+1`` (LK preserves slot
  order), landmark association is an integer column instead of a weak_ptr.
- :class:`MapState` replaces the global ``feats3d`` vector; erasing a RANSAC
  outlier landmark (OpenCVEPnPSolver.cpp:40-49) becomes clearing an alive bit.

Updates are functional (they return new tables) and never read a value back
to the host: masked-out rows are scattered into a dummy pad row, so shapes
stay fixed and no ``nonzero`` synchronises the stream.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

NO_LANDMARK = -1


def scatter_rows(dst: Tensor, idx: Tensor, src, mask: Tensor) -> Tensor:
    """Copy of ``dst`` with ``dst[idx[i]] = src[i]`` where ``mask[i]``.

    Masked-out rows land in a pad row that is cut off again, so they can
    never clobber a real row. ``src`` is a tensor of rows or a scalar. Rows
    kept by ``mask`` must carry distinct indices.
    """
    cap = dst.shape[0]
    target = torch.where(mask, idx, cap).long()
    padded = torch.cat([dst, torch.zeros_like(dst[:1])])
    if torch.is_tensor(src):
        src = src.to(dst.dtype)
    padded[target] = src
    return padded[:cap]


class FeatureTable(NamedTuple):
    """Per-frame feature table, capacity ``N``.

    xy:       (N, 2) float32 — (u=column, v=row) pixel positions
    valid:    (N,) bool      — slot holds a live feature
    landmark: (N,) int32     — row into MapState.xyz, or -1 if untracked
    score:    (N,) float32   — detector response (corner strength)
    """

    xy: Tensor
    valid: Tensor
    landmark: Tensor
    score: Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @staticmethod
    def empty(capacity: int, device="cpu", dtype=torch.float32) -> "FeatureTable":
        return FeatureTable(
            xy=torch.zeros((capacity, 2), dtype=dtype, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            landmark=torch.full((capacity,), NO_LANDMARK, dtype=torch.int32, device=device),
            score=torch.zeros((capacity,), dtype=dtype, device=device),
        )

    def num_valid(self) -> Tensor:
        return torch.sum(self.valid)

    def count_3d(self, map_alive: Tensor) -> Tensor:
        """Number of live features bound to a live landmark — the analogue of
        ``Frame::count3DPoints`` (Frame.cpp:14-24), where weak_ptr expiry is
        modelled by the map's alive mask."""
        bound = self.landmark >= 0
        lm = torch.clamp(self.landmark, min=0).long()
        alive = map_alive[lm] & bound
        return torch.sum(self.valid & alive)


class MapState(NamedTuple):
    """Global landmark table, capacity ``M`` (ring buffer).

    xyz:   (M, 3) float32 — world-frame landmark positions
    alive: (M,) bool      — landmark exists (cleared on outlier erase)
    head:  () int32       — next ring-allocation slot
    """

    xyz: Tensor
    alive: Tensor
    head: Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @staticmethod
    def empty(capacity: int, device="cpu", dtype=torch.float32) -> "MapState":
        return MapState(
            xyz=torch.zeros((capacity, 3), dtype=dtype, device=device),
            alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
            head=torch.zeros((), dtype=torch.int32, device=device),
        )

    def insert(self, pts: Tensor, mask: Tensor) -> tuple["MapState", Tensor]:
        """Ring-insert ``pts`` (N, 3) where ``mask`` (N,) is set.

        Returns the new map and the (N,) int32 slot indices assigned to each
        masked point (-1 where the mask is clear). Every point gets a reserved
        slot position via a masked prefix-sum. If more points than the ring
        holds are inserted at once, the later write wins: only the last
        ``capacity`` masked points are written.
        """
        cap = self.capacity
        m = mask.to(torch.int32)
        offsets = torch.cumsum(m, dim=0, dtype=torch.int32) - 1
        total = torch.sum(m, dtype=torch.int32)
        slots = torch.where(mask, (self.head + offsets) % cap, -1).to(torch.int32)
        write = mask & (offsets >= total - cap)
        xyz = scatter_rows(self.xyz, slots, pts, write)
        alive = scatter_rows(self.alive, slots, True, write)
        new_head = ((self.head + total) % cap).to(torch.int32)
        return MapState(xyz=xyz, alive=alive, head=new_head), slots

    def kill(self, slots: Tensor, mask: Tensor) -> "MapState":
        """Clear alive bits for ``slots`` where ``mask`` — the erase-outlier
        semantics of OpenCVEPnPSolver.cpp:40-49. (Duplicate slots all write
        the same value, so their order does not matter.)"""
        alive = scatter_rows(self.alive, slots, False, mask & (slots >= 0))
        return self._replace(alive=alive)

    def update_points(self, slots: Tensor, pts: Tensor, mask: Tensor) -> "MapState":
        """Write back optimized landmark positions (BA write-back,
        CeresBundleAdjustment.cpp:84-87): ``xyz[slots[i]] = pts[i]`` where
        ``mask[i]`` and ``slots[i] >= 0``. Slots written must be distinct."""
        xyz = scatter_rows(self.xyz, slots, pts, mask & (slots >= 0))
        return self._replace(xyz=xyz)


def has_neighbor(
    new_xy: Tensor, existing_xy: Tensor, existing_valid: Tensor, dist: int = 5
) -> Tensor:
    """Chebyshev-distance neighbor test: for each row of ``new_xy`` (K, 2),
    True iff any valid existing feature lies within Chebyshev distance
    < ``dist`` (reference ``Frame::hasNeighbor``, Frame.cpp:3-12 with
    ``Feature::distance`` = max-norm, Feature.cpp:9-15)."""
    d = torch.abs(new_xy[:, None, :] - existing_xy[None, :, :])
    cheb = torch.amax(d, dim=-1)
    near = (cheb < dist) & existing_valid[None, :]
    return torch.any(near, dim=-1)
