"""Sliding-window bundle adjustment as the configuration states it: Huber
(1 px) reprojection cost over the window's (pose, slot) grid with the
z-flipped projection, Levenberg-Marquardt with the Schur complement
(landmark blocks eliminated by their adjugate inverses, the reduced camera
system by pivot-free Gauss-Jordan), lambda from 1e-4, /3 on an accepted step
(floor 1e-6) and x4 on a rejected one (cap 1e6), the 1e-6 relative
Tikhonov term on both block diagonals, fixed poses pinned."""

from __future__ import annotations

import torch

from vo_bench.reference import geometry as geo
from vo_bench.reference.linalg import gj_solve, inv3x3
from vo_bench.reference.prec import Prec


def _huber(r2, delta: float = 1.0):
    return torch.where(r2 <= delta * delta, r2, 2.0 * delta * torch.sqrt(torch.clamp(r2, min=1e-300)) - delta * delta)


def cost(tr, lm, obs_uv, local, mask, K):
    """The window's Huber cost, evaluated in float64."""
    d = torch.float64
    pred = geo.ba_project(tr.to(d)[:, None, :].expand(mask.shape + (6,)), lm.to(d)[local.long()], K.to(d))
    r2 = torch.sum((obs_uv.to(d) - pred) ** 2, dim=-1)
    return torch.sum(torch.where(mask, _huber(r2), 0.0))


def _blocks(tr, lm, obs_uv, local, mask, pose_free, K, P: Prec):
    Pn, N = mask.shape
    L = lm.shape[0]
    local = local.long()
    q, dq_daa, R = geo.rotate_jac(tr[:, :3], lm[local] + tr[:, None, 3:6])
    z = -q[..., 2]
    fx, fy = K[0, 0], K[1, 1]
    pred = torch.stack([q[..., 0] / z * fx + K[0, 2], q[..., 1] / z * fy + K[1, 2]], dim=-1)
    zero = torch.zeros_like(z)
    dpred = torch.stack([torch.stack([fx / z, zero, fx * q[..., 0] / (z * z)], -1),
                         torch.stack([zero, fy / z, fy * q[..., 1] / (z * z)], -1)], -2)
    Jl = -(dpred @ R[:, None])
    Jp = torch.cat([-(dpred @ dq_daa), Jl], dim=-1)
    m = mask[..., None]
    r = P.q(torch.where(m, obs_uv - pred, 0.0))
    Jp = P.q(torch.where(m[..., None], Jp, 0.0)) * pose_free[:, None, None, None]
    Jl = P.q(torch.where(m[..., None], Jl, 0.0))
    r2 = torch.sum(r * r, dim=-1)
    w = torch.where(r2 <= 1.0, torch.ones_like(r2), 1.0 / torch.sqrt(torch.clamp(r2, min=1e-300))) * mask
    wJp, wJl = Jp * w[..., None, None], Jl * w[..., None, None]
    U = torch.einsum("pnik,pnij->pkj", wJp, Jp)
    b_pose = -torch.einsum("pnik,pni->pk", wJp, r)
    key = (local * Pn + torch.arange(Pn, device=tr.device)[:, None]).reshape(-1)
    vals = torch.cat([torch.einsum("pnik,pnij->pnkj", wJl, Jl).reshape(Pn * N, 9),
                      torch.einsum("pnik,pnij->pnkj", wJp, Jl).reshape(Pn * N, 18),
                      -torch.einsum("pnik,pni->pnk", wJl, r).reshape(Pn * N, 3),
                      mask.reshape(Pn * N, 1).to(tr.dtype)], dim=1)
    rows = torch.zeros((L * Pn, 31), dtype=tr.dtype, device=tr.device).index_add_(0, key, vals)
    rows = rows.reshape(L, Pn, 31)
    per_lm = rows.sum(dim=1)
    return (U, per_lm[:, :9].reshape(L, 3, 3), rows[:, :, 9:27].reshape(L, Pn, 6, 3), b_pose,
            per_lm[:, 27:30], per_lm[:, 30] > 0)


def _schur(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam, P: Prec):
    Pn = b_pose.shape[0]
    dt, dev = b_pose.dtype, b_pose.device
    eye3, eye6 = torch.eye(3, dtype=dt, device=dev), torch.eye(6, dtype=dt, device=dev)
    muV = (1e-6 * torch.mean(torch.diagonal(V, dim1=-2, dim2=-1).abs(), dim=-1) + 1e-9)[:, None, None]
    V_d = V + lam * (V * eye3) + muV * eye3
    V_inv = inv3x3(V_d, P)
    Y = torch.einsum("lpij,ljk->lpik", Wc, V_inv)
    muP = 1e-6 * torch.mean(torch.diagonal(U, dim1=-2, dim2=-1).abs()) + 1e-9
    S = -torch.einsum("lpik,lqjk->piqj", Y, Wc)
    ar = torch.arange(Pn, device=dev)
    S[ar, :, ar, :] += U + lam * (U * eye6) + muP * eye6
    b_red = b_pose - torch.einsum("lpik,lk->pi", Y, b_lm)
    m6 = pose_free.repeat_interleave(6).to(dt)
    S = S.reshape(6 * Pn, 6 * Pn) * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
    dp = gj_solve(P.q(S), P.q(b_red.reshape(-1) * m6)[:, None], P)[:, 0].reshape(Pn, 6)
    dx = torch.einsum("ljk,lk->lj", V_inv, b_lm - torch.einsum("lpik,pi->lk", Wc, dp))
    return dp, dx * has_obs[:, None]


def solve(tr, lm, obs_uv, local, mask, pose_free, K, iters: int, P: Prec, gate_px: float = 0.0):
    """``iters`` LM iterations; returns (tr, lm)."""
    tr, lm, obs_uv, K = P.q(tr), P.q(lm), P.q(obs_uv), P.q(K)
    if gate_px > 0:
        pred = geo.ba_project(tr[:, None, :].expand(mask.shape + (6,)), lm[local.long()], K)
        mask = mask & (torch.sum((obs_uv - pred) ** 2, dim=-1) < gate_px * gate_px)
    free = pose_free.to(tr.dtype)

    def f(tr_c, lm_c):
        pred = geo.ba_project(tr_c[:, None, :].expand(mask.shape + (6,)), lm_c[local.long()], K)
        return torch.sum(torch.where(mask, _huber(torch.sum((obs_uv - pred) ** 2, dim=-1)), 0.0))

    c = f(tr, lm)
    lam = 1e-4
    for _ in range(iters):
        dp, dx = _schur(*_blocks(tr, lm, obs_uv, local, mask, free, K, P), pose_free, lam, P)
        tr_try, lm_try = P.q(tr + dp * free[:, None]), P.q(lm + dx)
        c_try = f(tr_try, lm_try)
        if bool(c_try < c):
            tr, lm, c, lam = tr_try, lm_try, c_try, max(lam / 3.0, 1e-6)
        else:
            lam = min(lam * 4.0, 1e6)
    return tr, lm
