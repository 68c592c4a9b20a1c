"""Shi-Tomasi corner response — wrapper of the CUDA kernel
``csrc/min_eig.cu`` and its plain version.

Replaces the TPU kernel ``pmv_tpu/frontend/pallas_kernels.py``
(``min_eig_response``): image -> response in one pass.

Bound on this card: bytes (one image read, one response written). The plain
version materialises eight full-size intermediates in device memory; the
kernel stages a tile with its apron in shared memory and writes each output
once. Border semantics are the plain version's (zero gradient on the 1-px
border, edge-replicated blur), so the two agree on the whole image.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch import build
from pmv_tpu_torch.frontend import image

Tensor = torch.Tensor

# Plain PyTorch version, used for CPU tensors and as the yardstick the kernel
# is held against on the card.
min_eig_response_plain = image.min_eig_response


def min_eig_response(img: Tensor) -> Tensor:
    """Shi-Tomasi response map, (H, W) float32 -> (H, W)."""
    if img.device.type == "cpu":
        return min_eig_response_plain(img)
    if img.dim() != 2:
        raise ValueError(f"min_eig_response: expected (H, W), got {tuple(img.shape)}")
    H, W = img.shape
    build.check(img, "img", torch.float32, (H, W), img.device)
    out = torch.empty_like(img)
    build.launch("pmv_min_eig_response", img.device, img.data_ptr(), H, W, out.data_ptr())
    min_eig_response.launches += 1
    return out


min_eig_response.launches = 0
