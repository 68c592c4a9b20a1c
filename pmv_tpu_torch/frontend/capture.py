"""LK search-region block capture — wrapper of the CUDA kernel
``csrc/capture.cu`` and its plain version.

Replaces the TPU kernel ``pmv_tpu/frontend/pallas_capture.py``
(``capture_level`` / ``_capture_call``). The tracker loads every feature's
(Rg, Rg) search region from each freshly built pyramid level once per frame,
and once more per level at init and after a reseed.

Bound on this card: bytes (N*Rg*Rg*4 read and as much written, no
arithmetic). The kernel is one thread block per feature that derives its own
origin from the float centre (the floor-and-clip of :func:`lk.block_origins`)
and copies coalesced along block rows. Result is bit-exact against the plain
version :func:`capture_level_plain`.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch import build
from pmv_tpu_torch.frontend import lucas_kanade as lk

Tensor = torch.Tensor

# Plain PyTorch version (advanced-indexing gather), used for CPU tensors and
# as the yardstick the kernel is held against on the card.
capture_level_plain = lk._capture_region


def capture_level(img_padded: Tensor, center: Tensor, win: int, search: int):
    """(N, Rg, Rg) blocks of ``img_padded`` around float ``center`` positions
    (padded-image coords, (u, v)) plus their integer origins (r0, c0).

    CUDA tensors go through the hand-written kernel (or raise); the plain
    version runs only for CPU tensors.
    """
    if img_padded.device.type == "cpu":
        return capture_level_plain(img_padded, center, win, search)
    dev = img_padded.device
    Hp, Wp = img_padded.shape
    N = center.shape[0]
    Rg = lk.region_size(win, search)
    if Hp < Rg or Wp < Rg:
        raise ValueError(f"capture_level: image {Hp}x{Wp} smaller than block {Rg}")
    build.check(img_padded, "img_padded", torch.float32, (Hp, Wp), dev)
    build.check(center, "center", torch.float32, (N, 2), dev)
    out = torch.empty((N, Rg, Rg), dtype=torch.float32, device=dev)
    r0 = torch.empty((N,), dtype=torch.int32, device=dev)
    c0 = torch.empty((N,), dtype=torch.int32, device=dev)
    build.launch(
        "pmv_capture_level", dev,
        img_padded.data_ptr(), Hp, Wp, center.data_ptr(), N, Rg, win,
        out.data_ptr(), r0.data_ptr(), c0.data_ptr(),
    )
    capture_level.launches += 1
    return out, r0, c0


capture_level.launches = 0
