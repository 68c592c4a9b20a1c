"""Sliding-window bundle adjustment: Levenberg-Marquardt with Schur
complement reduction of the landmark blocks — PyTorch counterpart of
``pmv_tpu/ba/schur_lm.py`` (grid solver only).

Replacement for CeresBundleAdjustment.cpp:5-89 (SPARSE_SCHUR, Huber(1.0),
``max_iterations`` from config). Parameterization is identical to the
reference: each window pose is the 6-vector ``[angle_axis(R^T), -t]``
(CeresBundleAdjustment.cpp:26-34), each landmark a world-frame 3-vector, and
the residual is ``observed - ba_project(tr, X)``
(include/ProjectionResidual.h:38-58).

Structure exploited as SPARSE_SCHUR does, but as dense batched tensor
algebra: landmark Hessian blocks V are (L, 3, 3) and inverted in closed
form; pose-landmark coupling W is a dense (L, P, 6, 3) tensor (P = window
size <= ~10); the reduced camera system S is a tiny (6P, 6P) dense solve.

Observations are laid out (P, N) pose-major (slot-aligned windows observe
each landmark at most once per pose). The landmark blocks are assembled by
``index_add_`` over the observation -> landmark map; the JAX package's
one-hot matrix products and their chunking were scatter workarounds of its
target and are not carried over. ``index_add_`` on a CUDA tensor sums with
atomics, in no fixed order, so every block is first added into its own
(landmark, pose) row — one observation at most — and the rows of a landmark
are then summed over the pose axis in a fixed order: the same inputs give
the same V/Wc/b_lm bit for bit.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core.linalg import gj_solve

Tensor = torch.Tensor


def _huber_cost(r2: Tensor, delta: float) -> Tensor:
    """Huber rho(s) on squared norms s (Ceres HuberLoss semantics)."""
    d2 = delta * delta
    return torch.where(
        r2 <= d2, r2, 2.0 * delta * torch.sqrt(torch.clamp(r2, min=1e-18)) - d2
    )


def _inv3x3(V: Tensor) -> Tensor:
    """Batched closed-form 3x3 inverse via adjugate; (L, 3, 3) -> (L, 3, 3).
    Singular blocks (landmarks with too few observations) return ~0 so their
    update vanishes instead of exploding."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _residual_jacobians(tr: Tensor, lm_o: Tensor, obs_uv: Tensor, K: Tensor):
    """Residual ``uv - ba_project(tr, X)`` and its Jacobians with respect to
    the pose block and the landmark, per observation of a (P, N) grid: tr
    (P, 6), lm_o (P, N, 3) -> r (P, N, 2), Jp (P, N, 2, 6), Jl (P, N, 2, 3).
    In closed form (the JAX package takes ``jacfwd`` of the same residual)."""
    q, dq_daa, R = geo.angle_axis_rotate_jac(tr[:, :3], lm_o + tr[:, None, 3:6])
    z = -q[..., 2]
    fx, fy = K[0, 0], K[1, 1]
    pred = torch.stack([q[..., 0] / z * fx + K[0, 2], q[..., 1] / z * fy + K[1, 2]], dim=-1)
    zero = torch.zeros_like(z)
    # d pred / d q, with z = -q_z
    dpred_dq = torch.stack(
        [
            torch.stack([fx / z, zero, fx * q[..., 0] / (z * z)], dim=-1),
            torch.stack([zero, fy / z, fy * q[..., 1] / (z * z)], dim=-1),
        ],
        dim=-2,
    )  # (P, N, 2, 3)
    Jl = -(dpred_dq @ R[:, None])  # dq/dX = dq/d(tr[3:6]) = R
    Jp = torch.cat([-(dpred_dq @ dq_daa), Jl], dim=-1)
    return obs_uv - pred, Jp, Jl


def assemble_blocks_grid(tr, lm, obs_uv, local, obs_mask, pose_free, K, delta):
    """Assemble the Schur building blocks from (P, N)-grid observations.

    tr (P, 6), lm (L, 3), obs_uv (P, N, 2), local (P, N) landmark index of
    each observation, obs_mask (P, N), pose_free (P,). Returns (U (P,6,6),
    V (L,3,3), Wc (L,P,6,3), b_pose (P,6), b_lm (L,3), has_obs (L,)).
    """
    P, N = obs_mask.shape
    L = lm.shape[0]
    local = local.long()
    r, Jp, Jl = _residual_jacobians(tr, lm[local], obs_uv, K)
    # Masked observations must be inert even when their residual is NaN/Inf
    # (padded slots index arbitrary pose/landmark pairs, which can divide by
    # z = 0; NaN * 0-weight is still NaN).
    r = torch.where(obs_mask[..., None], r, 0.0)
    Jp = torch.where(obs_mask[..., None, None], Jp, 0.0)
    Jl = torch.where(obs_mask[..., None, None], Jl, 0.0)

    r2 = torch.sum(r * r, dim=-1)
    w = geo.huber_weight(r2, delta) * obs_mask  # IRLS weights (P, N)
    # A fixed pose contributes no pose Jacobian, but its observations still
    # constrain the landmarks.
    Jp = Jp * pose_free[:, None, None, None]
    wJp = Jp * w[..., None, None]
    wJl = Jl * w[..., None, None]

    U = torch.einsum("pnik,pnij->pkj", wJp, Jp)
    # Gradient (minimize 1/2 w r^2 with J = dr/dtheta -> solve
    # H delta = -J^T w r; the minus is folded into b).
    b_pose = -torch.einsum("pnik,pni->pk", wJp, r)
    VV = torch.einsum("pnik,pnij->pnkj", wJl, Jl).reshape(P * N, 9)
    WW = torch.einsum("pnik,pnij->pnkj", wJp, Jl).reshape(P * N, 18)
    bl = -torch.einsum("pnik,pni->pnk", wJl, r).reshape(P * N, 3)

    # One row per (landmark, pose): 9 of V, 18 of Wc, 3 of b_lm, 1 count.
    pose = torch.arange(P, device=tr.device).repeat_interleave(N)
    count = obs_mask.reshape(P * N, 1).to(tr.dtype)
    rows = torch.zeros((L * P, 31), dtype=tr.dtype, device=tr.device).index_add_(
        0, local.reshape(P * N) * P + pose, torch.cat([VV, WW, bl, count], dim=1)
    ).reshape(L, P, 31)
    per_lm = rows.sum(dim=1)
    V, b_lm, n_obs = per_lm[:, :9], per_lm[:, 27:30], per_lm[:, 30]
    Wc = rows[:, :, 9:27]
    return U, V.reshape(L, 3, 3), Wc.reshape(L, P, 6, 3), b_pose, b_lm, n_obs > 0


def schur_solve(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam):
    """Damped Schur-complement solve from assembled blocks. Returns
    (dp (P,6), dx (L,3))."""
    P = b_pose.shape[0]
    dtype, dev = b_pose.dtype, b_pose.device
    eyeP = torch.eye(6, dtype=dtype, device=dev)
    eyeL = torch.eye(3, dtype=dtype, device=dev)
    # f32 gauge hygiene: the window often has NO pinned pose (reference
    # semantics, CeresBundleAdjustment.cpp:22-24 skips only global frame 0),
    # so the normal equations carry a 7-DOF null space. Ceres survives it in
    # double precision; in f32 the gradient's numerical null-space component
    # divided by a near-zero damped eigenvalue produces meter-scale gauge
    # jumps. A scale-aware absolute Tikhonov term caps the null-direction
    # step while staying ~1e-6 relative to the data directions.
    muV = (
        1e-6 * torch.mean(torch.diagonal(V, dim1=-2, dim2=-1).abs(), dim=-1) + 1e-9
    )[:, None, None]
    V_d = V + lam * (V * eyeL) + muV * eyeL

    V_inv = _inv3x3(V_d)  # (L, 3, 3)
    Y = torch.einsum("lpij,ljk->lpik", Wc, V_inv)  # (L, P, 6, 3)

    # Reduced camera system S = U_d - sum_l W V^-1 W^T.
    S_corr = torch.einsum("lpik,lqjk->piqj", Y, Wc)
    b_corr = torch.einsum("lpik,lk->pi", Y, b_lm)
    muP = 1e-6 * torch.mean(torch.diagonal(U, dim1=-2, dim2=-1).abs()) + 1e-9
    U_d = U + lam * (U * eyeP) + muP * eyeP
    S = -S_corr
    ar = torch.arange(P, device=dev)
    S[ar, :, ar, :] += U_d
    b_red = b_pose - b_corr

    # Pin non-free poses: identity rows/cols, zero rhs.
    m6 = pose_free.repeat_interleave(6).to(dtype)  # (6P,)
    S_flat = S.reshape(6 * P, 6 * P)
    S_flat = S_flat * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
    b_flat = b_red.reshape(-1) * m6

    # Pivot-free Gauss-Jordan: S is Tikhonov+LM-damped SPD (pinned rows carry
    # an explicit unit diagonal).
    dp = gj_solve(S_flat, b_flat[:, None])[:, 0].reshape(P, 6)
    # Back-substitute landmarks: dx = V^-1 (b_lm - W^T dp).
    Wt_dp = torch.einsum("lpik,pi->lk", Wc, dp)
    dx = torch.einsum("ljk,lk->lj", V_inv, b_lm - Wt_dp)
    dx = dx * has_obs[:, None]
    return dp, dx


def _lm_loop(tr, lm, lam0, iters, step_fn, cost_fn):
    """The LM accept/damping loop.

    ``step_fn(tr, lm, lam) -> (tr_try, lm_try)`` proposes a damped step;
    ``cost_fn(tr, lm)`` evaluates the robust cost. Accept iff the cost
    decreases; on accept lam /= 3 (floored at 1e-6 — in f32 a near-zero lam
    lets the Schur solve amplify rounding noise along weakly-observed
    directions), on reject lam *= 4 (capped at 1e6). The accept test is a
    ``torch.where`` on device values: no host synchronisation.
    """
    cost0 = cost_fn(tr, lm)
    cost = cost0
    lam = torch.as_tensor(lam0, dtype=tr.dtype, device=tr.device)
    hist = []
    for _ in range(iters):
        tr_try, lm_try = step_fn(tr, lm, lam)
        cost_try = cost_fn(tr_try, lm_try)
        accept = cost_try < cost
        tr = torch.where(accept, tr_try, tr)
        lm = torch.where(accept, lm_try, lm)
        lam = torch.where(
            accept, torch.clamp(lam / 3.0, min=1e-6), torch.clamp(lam * 4.0, max=1e6)
        )
        cost = torch.where(accept, cost_try, cost)
        hist.append(cost)
    history = torch.stack(hist) if hist else cost0.new_zeros((0,))
    return tr, lm, {"cost0": cost0, "cost": cost, "history": history}


def _cost_grid(tr, lm, obs_uv, local, obs_mask, K, delta):
    """Huber cost over (P, N)-grid observations."""
    tr_o = tr[:, None, :].expand(obs_mask.shape + (6,))
    pred = geo.ba_project(tr_o, lm[local.long()], K)
    r = obs_uv - pred
    r2 = torch.sum(r * r, dim=-1)
    return torch.sum(torch.where(obs_mask, _huber_cost(r2, delta), 0.0))


def ba_solve_grid(
    tr,
    lm,
    obs_uv,
    local,
    obs_mask,
    pose_free,
    K,
    iters: int = 5,
    delta: float = 1.0,
    lam0: float = 1e-4,
    obs_gate_px: float = 0.0,
):
    """Run ``iters`` LM iterations (the config's ``max_iterations``, matching
    CeresBundleAdjustment.cpp:59) over (P, N)-grid observations. Returns
    (tr, lm, stats).

    ``obs_gate_px`` > 0 drops observations whose INITIAL reprojection
    residual exceeds the gate before solving — the standard defense against
    corrupted associations, which Huber alone cannot contain when they are
    numerous. The reference has no such gate (0 for strict parity)."""
    if obs_gate_px > 0:
        pred = geo.ba_project(
            tr[:, None, :].expand(obs_mask.shape + (6,)), lm[local.long()], K
        )
        r0 = obs_uv - pred
        ok = torch.sum(r0 * r0, dim=-1) < obs_gate_px * obs_gate_px
        obs_mask = obs_mask & ok

    def step_fn(tr_c, lm_c, lam):
        U, V, Wc, b_pose, b_lm, has_obs = assemble_blocks_grid(
            tr_c, lm_c, obs_uv, local, obs_mask, pose_free, K, delta
        )
        dp, dx = schur_solve(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam)
        return tr_c + dp * pose_free[:, None], lm_c + dx

    def cost_fn(tr_c, lm_c):
        return _cost_grid(tr_c, lm_c, obs_uv, local, obs_mask, K, delta)

    return _lm_loop(tr, lm, lam0, iters, step_fn, cost_fn)
