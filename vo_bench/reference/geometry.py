"""Rotations and projections of the reference (the conventions the port's
configuration states: angle-axis with ``R = I + sinc [w]x + cosc [w]x^2``,
the BA block ``[angle_axis(R^T), -t]`` with the z-flipped projection)."""

from __future__ import annotations

import math

import torch


def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([torch.stack([zero, -wz, wy], -1), torch.stack([wz, zero, -wx], -1),
                        torch.stack([-wy, wx, zero], -1)], -2)


def rodrigues(aa):
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=torch.finfo(aa.dtype).tiny))
    small = theta2 < 1e-12
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = hat(aa)
    return torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape) + sinc * K + cosc * (K @ K)


def rodrigues_inv(R):
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.acos(cos_t)
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    scale = torch.where(theta < 1e-6, 1.0 + theta * theta / 6.0,
                        theta / torch.where(sin_t == 0, torch.ones_like(sin_t), sin_t))
    aa = w * scale[..., None]
    B = (R + R.transpose(-1, -2)) / 2.0
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag - cos_t[..., None])
                                  / torch.clamp(1.0 - cos_t, min=1e-12)[..., None], min=0.0))
    aa_pi = torch.where(w >= 0, 1.0, -1.0).to(R.dtype) * axis * theta[..., None]
    return torch.where((theta > math.pi - 1e-4)[..., None], aa_pi, aa)


def angle_axis_rotate(aa, p):
    aa, p = torch.broadcast_tensors(aa, p)
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=torch.finfo(aa.dtype).tiny))
    small = theta2 < 1e-12
    axis = aa / torch.where(small, torch.ones_like(theta), theta)
    cos_t = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta))
    sin_t = torch.where(small, theta, torch.sin(theta))
    rotated = (cos_t * p + sin_t * torch.linalg.cross(axis, p, dim=-1)
               + (1.0 - cos_t) * torch.sum(axis * p, dim=-1, keepdim=True) * axis)
    return torch.where(small, p + torch.linalg.cross(aa, p, dim=-1), rotated)


def rotate_jac(aa, p):
    """``q = R(aa) p`` for p (..., N, 3), ``dq/daa`` (..., N, 3, 3) and R."""
    R = rodrigues(aa)
    q = p @ R.transpose(-1, -2)
    t2 = torch.sum(aa * aa, dim=-1)[..., None, None]
    t = torch.sqrt(torch.clamp(t2, min=1e-4))
    series = t2 < 1e-2
    b = torch.where(series, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, 2.0 * torch.sin(0.5 * t) ** 2 / (t * t))
    c = torch.where(series, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (t - torch.sin(t)) / (t * t * t))
    W = hat(aa)
    Jr = torch.eye(3, dtype=aa.dtype, device=aa.device) - b * W + c * (W @ W)
    return q, -(R[..., None, :, :] @ hat(p) @ Jr[..., None, :, :]), R


def det3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def ba_project(tr, X, K):
    p = angle_axis_rotate(tr[..., :3], X + tr[..., 3:6])
    z = -p[..., 2]
    return torch.stack([p[..., 0] / z * K[0, 0] + K[0, 2], p[..., 1] / z * K[1, 1] + K[1, 2]], dim=-1)


def rotation_gap(Ra, Rb):
    """Angle in radians between two rotations, ``2 asin(|Ra - Rb|_F / sqrt 8)``
    (exact for rotations, and accurate at small angles, where acos is not)."""
    s = torch.linalg.norm(Ra - Rb, dim=(-2, -1)) / 8.0 ** 0.5
    return 2.0 * torch.asin(torch.clamp(s, max=1.0))
