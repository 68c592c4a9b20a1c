"""LK search-region block capture — wrapper of the CUDA kernel
``csrc/capture.cu`` and its plain version.

Replaces the TPU kernel ``pmv_tpu/frontend/pallas_capture.py``
(``capture_level`` / ``_capture_call``). It runs once per pyramid level at
init and after a reseed, when the cached blocks do not cover the new feature
positions; on a tracked frame ``lk_kernels.lk_track_level`` captures its own
region.

Bound on this card: bytes (each level pixel under a region read once,
N*Rg*Rg*4 bytes written, no arithmetic). The kernel reads the *unpadded*
level at clamped coordinates, which equals edge replication bit for bit, so
no padded copy of the level is made first. One thread block per feature
derives its own origin from the float centre (the floor-and-clip of
:func:`lk.block_origins`); a warp takes a block row and its lanes the
columns, so no index is divided and reads and writes are coalesced along
rows. Result is bit-exact against the plain version
:func:`capture_level_plain`.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch import build
from pmv_tpu_torch.frontend import lucas_kanade as lk
from pmv_tpu_torch.frontend.image import _pad_edge

Tensor = torch.Tensor


def capture_level_plain(level: Tensor, center_padded: Tensor, win: int, search: int):
    """Plain PyTorch version (edge-pad, then an advanced-indexing gather),
    used for CPU tensors and as the yardstick the kernel is held against on
    the card."""
    img_p = _pad_edge(level, lk._pad_for(win, search))
    return lk._capture_region(img_p, center_padded, win, search)


def capture_level_clamped(level: Tensor, center_padded: Tensor, win: int, search: int):
    """The kernels' addressing written out in PyTorch: the same blocks and
    origins as :func:`capture_level_plain`, read from the unpadded level at
    clamped coordinates. No caller on the main path; the tests hold it
    against pad-then-gather, bit for bit, at borders and corners."""
    H, W = level.shape
    PAD = lk._pad_for(win, search)
    r0, c0 = lk.block_origins((H + 2 * PAD, W + 2 * PAD), center_padded, win, search)
    ar = torch.arange(lk.region_size(win, search), device=level.device) - PAD
    rows = torch.clamp(r0.long()[:, None] + ar, 0, H - 1)[:, :, None]
    cols = torch.clamp(c0.long()[:, None] + ar, 0, W - 1)[:, None, :]
    return level[rows, cols], r0, c0


def capture_level(level: Tensor, center_padded: Tensor, win: int, search: int):
    """(N, Rg, Rg) blocks around float ``center_padded`` positions ((u, v),
    in the coordinates of ``level`` edge-padded by ``lk._pad_for(win,
    search)``) plus their integer origins (r0, c0) in the same coordinates.
    ``level`` is the unpadded (H, W) pyramid level.

    CUDA tensors go through the hand-written kernel (or raise); the plain
    version runs only for CPU tensors.
    """
    if level.device.type == "cpu":
        return capture_level_plain(level, center_padded, win, search)
    dev = level.device
    H, W = level.shape
    N = center_padded.shape[0]
    Rg = lk.region_size(win, search)
    build.check(level, "level", torch.float32, (H, W), dev)
    build.check(center_padded, "center_padded", torch.float32, (N, 2), dev)
    out = torch.empty((N, Rg, Rg), dtype=torch.float32, device=dev)
    r0 = torch.empty((N,), dtype=torch.int32, device=dev)
    c0 = torch.empty((N,), dtype=torch.int32, device=dev)
    build.launch(
        "pmv_capture_level", dev,
        level.data_ptr(), H, W, lk._pad_for(win, search),
        center_padded.data_ptr(), N, Rg, win,
        out.data_ptr(), r0.data_ptr(), c0.data_ptr(),
    )
    capture_level.launches += 1
    return out, r0, c0


capture_level.launches = 0
