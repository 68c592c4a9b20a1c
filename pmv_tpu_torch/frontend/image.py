"""Image-domain primitives: gradients, structure tensor, pyramids — PyTorch
counterpart of ``pmv_tpu/frontend/image.py``.

Rewrite of the reference's lazy per-frame image cache (Frame.cpp:58-86
central-difference gradients, Frame.cpp:119-138 gradient products + 3x3 box
blur "Harris matrix") over (..., H, W) float32 images.

The blurs are written as the shifted sums they are, in the JAX package's
order of additions, and not as ``conv2d``: a float32 convolution would go
through cuDNN, whose default is TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _pad_edge(x: Tensor, pad: int) -> Tensor:
    """Edge-replicate the last two dims by ``pad`` on every side
    (``F.pad(mode="replicate")`` wants a 3-D or 4-D input)."""
    lead = x.shape[:-2]
    y = F.pad(x.reshape((1, -1) + x.shape[-2:]), (pad, pad, pad, pad), mode="replicate")
    return y.reshape(lead + y.shape[-2:])


def spatial_gradient(img: Tensor) -> tuple[Tensor, Tensor]:
    """Central-difference gradients with zero borders
    (Frame::computeSpatialGradient, Frame.cpp:58-86)."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[..., 1:-1, 1:-1] = (img[..., 1:-1, 2:] - img[..., 1:-1, :-2]) * 0.5
    gy[..., 1:-1, 1:-1] = (img[..., 2:, 1:-1] - img[..., :-2, 1:-1]) * 0.5
    return gx, gy


def box_blur3(x: Tensor) -> Tensor:
    """3x3 box blur with replicated borders, as two 3-tap shifted sums."""
    p = _pad_edge(x, 1)
    h = (p[..., :, :-2] + p[..., :, 1:-1] + p[..., :, 2:]) / 3.0
    return (h[..., :-2, :] + h[..., 1:-1, :] + h[..., 2:, :]) / 3.0


def structure_tensor(img: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Blurred second-moment matrix entries (Ixx, Iyy, Ixy), each (H, W) —
    the reference's "Harris matrix" (Frame.cpp:119-138)."""
    gx, gy = spatial_gradient(img)
    return box_blur3(gx * gx), box_blur3(gy * gy), box_blur3(gx * gy)


def min_eig_response(img: Tensor) -> Tensor:
    """Shi-Tomasi response: min eigenvalue of the 2x2 structure tensor,
    closed form (ShiTomasiFeatureExtractor.cpp:49-75). This is the plain
    version of the ``min_eig_response`` CUDA kernel
    (``pmv_tpu_torch/frontend/min_eig.py``), border included."""
    Ixx, Iyy, Ixy = structure_tensor(img)
    mean = (Ixx + Iyy) * 0.5
    d = (Ixx - Iyy) * 0.5
    rad = torch.sqrt(d * d + Ixy * Ixy)
    return mean - rad


def downsample2(img: Tensor) -> Tensor:
    """2x downsample with a 2x2 average (pyramid level step). Odd trailing
    row/col are dropped."""
    H, W = img.shape[-2], img.shape[-1]
    h2, w2 = H // 2, W // 2
    x = img[..., : h2 * 2, : w2 * 2]
    x = x.reshape(*x.shape[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def gaussian_blur5(img: Tensor) -> Tensor:
    """Separable 5-tap binomial blur (1,4,6,4,1)/16 — the anti-alias filter
    applied before each pyramid downsample, like OpenCV's pyrDown."""
    k = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
    H, W = img.shape[-2], img.shape[-1]
    p = _pad_edge(img, 2)
    h = k[0] * p[..., :, 0:W]
    for i in range(1, 5):
        h = h + k[i] * p[..., :, i : i + W]
    v = k[0] * h[..., 0:H, :]
    for i in range(1, 5):
        v = v + k[i] * h[..., i : i + H, :]
    return v


def build_pyramid(img: Tensor, levels: int) -> list[Tensor]:
    """Gaussian image pyramid: ``levels + 1`` images, level 0 = input
    (cv::calcOpticalFlowPyrLK with maxLevel = ``levels``)."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(downsample2(gaussian_blur5(pyr[-1])))
    return pyr
