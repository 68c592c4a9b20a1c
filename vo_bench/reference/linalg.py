"""The eliminations the configuration's solvers use: pivot-free
Gauss-Jordan on damped SPD systems (each step rounded once to the stored
precision), and the closed-form 3x3 adjugate inverse."""

from __future__ import annotations

import torch

from vo_bench.reference.prec import Prec


def gj_solve(A, B, P: Prec):
    """Solve ``A X = B`` for (..., n, n) and (..., n, k) without pivoting;
    every elimination step ``M - col * row`` is formed in float64 and stored
    once in ``P``."""
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    M = torch.cat([A.expand(batch + A.shape[-2:]), B.expand(batch + B.shape[-2:]).to(A.dtype)], dim=-1)
    M = P.q(M)
    for i in range(n):
        row = P.q(M[..., i, :] / M[..., i, i, None])
        col = M[..., :, i].clone()
        M = P.q(M.double() - col.double()[..., :, None] * row.double()[..., None, :])
        M[..., i, :] = P.q(M[..., i, :] + row)
    return M[..., :, n:]


def gj_inverse(A, P: Prec):
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return gj_solve(A, eye, P)


def inv3x3(V, P: Prec):
    """Adjugate inverse of (..., 3, 3) blocks; a block with |det| <= 1e-12
    gets 0 (its landmark's update vanishes)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A, B, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * C
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    adj = torch.stack([torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
                       torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
                       torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], dim=-2)
    return P.q(adj * inv_det[..., None, None])
