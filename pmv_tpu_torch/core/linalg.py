"""Tiny-matrix linear algebra — PyTorch counterpart of
``pmv_tpu/core/linalg.py``.

Every small system here is damped/ridge-regularized SPD (LM normal
equations, ridged Gram matrices, Tikhonov-damped Schur complements), so the
JAX package solves them by pivot-free Gauss-Jordan elimination. The port
keeps that algorithm so both sides round alike; whether ``torch.linalg.solve``
serves the GPU better is a later decision.

XLA contracts a multiply feeding an add into one fused multiply-add (one
rounding) wherever both land in one fusion, so the JAX package's compiled
eliminations round once where PyTorch's separate operators round twice.
:func:`fma` restores the single rounding where that changes an outcome.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a * b + c`` with one rounding, as XLA's contraction computes it.

    For float32 the product is formed in float64, where the product of two
    float32 numbers is exact, the sum is rounded to float64 and then to
    float32. That double rounding differs from a true fused multiply-add
    only when the float64 sum lands exactly halfway between two float32
    numbers (tests/test_torch_contraction.py counts such cases). Other
    dtypes take ``a * b + c`` as it is (the float64 paths are held to the
    JAX package at 1e-10 as they are). Plain elementwise operators, so the
    CPU and the card give the same bits (no ``addcmul``, whose fusion
    depends on the device).
    """
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def gj_solve(A: Tensor, B: Tensor) -> Tensor:
    """Solve ``A X = B`` by pivot-free Gauss-Jordan elimination.

    A: (..., n, n), B: (..., n, k) -> (..., n, k); batch dims broadcast. NO
    row pivoting: callers must guarantee a safely nonzero diagonal throughout
    elimination (true for the damped SPD systems of this package). Each
    elimination step is rounded once (:func:`fma`), as in the JAX package's
    compiled solve.
    """
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A = A.expand(batch + A.shape[-2:])
    B = B.expand(batch + B.shape[-2:]).to(A.dtype)
    M = torch.cat([A, B], dim=-1)  # (..., n, n+k)
    for i in range(n):
        row = M[..., i, :] / M[..., i, i, None]  # normalized pivot row
        col = M[..., :, i].clone()
        # Eliminate column i from every row (the pivot row zeroes itself,
        # up to the fused rounding's residual, as in the JAX package), then
        # write back the normalized pivot row.
        M = fma(-col[..., :, None], row[..., None, :], M)
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
