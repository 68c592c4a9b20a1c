"""Tiny-matrix linear algebra — PyTorch counterpart of
``pmv_tpu/core/linalg.py``.

Every small system here is damped/ridge-regularized SPD (LM normal
equations, ridged Gram matrices, Tikhonov-damped Schur complements), so the
JAX package solves them by pivot-free Gauss-Jordan elimination. The port
keeps that algorithm so both sides round alike; whether ``torch.linalg.solve``
serves the GPU better is a later decision.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def gj_solve(A: Tensor, B: Tensor) -> Tensor:
    """Solve ``A X = B`` by pivot-free Gauss-Jordan elimination.

    A: (..., n, n), B: (..., n, k) -> (..., n, k); batch dims broadcast. NO
    row pivoting: callers must guarantee a safely nonzero diagonal throughout
    elimination (true for the damped SPD systems of this package).
    """
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A = A.expand(batch + A.shape[-2:])
    B = B.expand(batch + B.shape[-2:]).to(A.dtype)
    M = torch.cat([A, B], dim=-1)  # (..., n, n+k)
    for i in range(n):
        row = M[..., i, :] / M[..., i, i, None]  # normalized pivot row
        col = M[..., :, i].clone()
        # Eliminate column i from every row (the pivot row zeroes itself),
        # then write back the normalized pivot row.
        M = M - col[..., :, None] * row[..., None, :]
        M[..., i, :] = M[..., i, :] + row
    return M[..., :, n:]


def gj_inverse(A: Tensor) -> Tensor:
    """Pivot-free Gauss-Jordan inverse of (..., n, n) damped-SPD matrices."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return gj_solve(A, eye)


def det3(M: Tensor) -> Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
