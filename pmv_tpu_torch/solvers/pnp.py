"""Perspective-n-Point pose estimation: batched DLT hypotheses + IRLS
Gauss-Newton refinement — PyTorch counterpart of ``pmv_tpu/solvers/pnp.py``.

Replacement for the reference's PnP stage (OpenCVEPnPSolver.cpp:4-50):
``cv::solvePnPRansac(..., useExtrinsicGuess=true, 100 iters, 8 px, .99)``.
A fixed batch of 6-point DLT hypotheses (batched 12x12 ridged inverse
iteration), plus the extrinsic guess as one extra hypothesis, scored by
reprojection error; the winner is polished by a fixed-iteration Gauss-Newton
on all inliers. The returned inlier mask drives landmark erasure exactly like
the reference's outlier removal (:40-49).

Convention (standard, like OpenCV): object points X are in a reference frame
(here: the previous camera's standard frame), and the solved pose maps them
into the current camera: ``x_cam = R X + t``, z > 0 in front,
``uv = f * xy / z + c``.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core.linalg import det3, gj_inverse, gj_solve
from pmv_tpu_torch.solvers.ransac import best_hypothesis, sample_minimal_sets

Tensor = torch.Tensor


def _project_std(aa: Tensor, t: Tensor, X: Tensor, K: Tensor) -> Tensor:
    """Standard-convention projection of (N, 3) points by pose (aa, t), each
    (..., 3): returns (..., N, 2)."""
    xc = geo.angle_axis_rotate(aa[..., None, :], X) + t[..., None, :]
    z = torch.clamp(xc[..., 2], min=1e-9)
    u = xc[..., 0] / z * K[0, 0] + K[0, 2]
    v = xc[..., 1] / z * K[1, 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)


def _smallest_eigvec12(M: Tensor) -> Tensor:
    """Smallest eigenvector of PSD (..., 12, 12) matrices by ridged inverse
    iteration (one pivot-free Gauss-Jordan inverse + 3 matvecs).
    Hypothesis-grade accuracy only: RANSAC scoring and the GN polish do the
    precision work downstream."""
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    mu = 1e-7 * tr / 12.0 + 1e-12
    eye = torch.eye(12, dtype=M.dtype, device=M.device)
    Minv = gj_inverse(M + mu[..., None, None] * eye)
    v = torch.full(M.shape[:-1], 1.0 / 12.0**0.5, dtype=M.dtype, device=M.device)
    for _ in range(3):
        v = (Minv @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def _polar_so3(M: Tensor) -> Tensor:
    """Nearest rotation to (..., 3, 3) matrices with det > 0: Newton polar
    iteration ``X <- (X + X^-T) / 2`` with the closed-form adjugate inverse.
    Degenerate samples produce garbage hypotheses that RANSAC scoring
    discards like any other bad draw."""

    def inv_T(X):
        a, b, c = X[..., 0, 0], X[..., 0, 1], X[..., 0, 2]
        d, e, f = X[..., 1, 0], X[..., 1, 1], X[..., 1, 2]
        g, h, i = X[..., 2, 0], X[..., 2, 1], X[..., 2, 2]
        A = e * i - f * h
        B = -(d * i - f * g)
        C = d * h - e * g
        det = a * A + b * B + c * C
        det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        adj_T = torch.stack(
            [
                torch.stack([A, B, C], dim=-1),
                torch.stack([-(b * i - c * h), a * i - c * g, -(a * h - b * g)], dim=-1),
                torch.stack([b * f - c * e, -(a * f - c * d), a * e - b * d], dim=-1),
            ],
            dim=-2,
        )
        return adj_T / det[..., None, None]

    X = M
    for _ in range(6):
        X = 0.5 * (X + inv_T(X))
    return X


def _dlt_pose(X: Tensor, x: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    """Weighted DLT for [R|t] from >= 6 3D-2D pairs on unit-plane coords,
    batched over leading dims.

    X: (..., n, 3) object points, x: (..., n, 2) normalized image coords, w:
    (..., n) weights. Returns (R (..., 3, 3), t (..., 3)) with R
    orthogonalized (Newton polar) and the scale/sign fixed by the determinant.
    """
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., n, 4)
    r1 = torch.cat([Xh, zeros, -x[..., 0:1] * Xh], dim=-1)  # (..., n, 12)
    r2 = torch.cat([zeros, Xh, -x[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (..., 2n, 12)
    AtA = A.transpose(-1, -2) @ A
    P = _smallest_eigvec12(AtA).reshape(X.shape[:-2] + (3, 4))
    M = P[..., :3]
    # M ~ c * R with c = signed cbrt(det M); dividing by c resolves the +-P
    # sign ambiguity of the eigenvector.
    detM = det3(M)
    c = torch.sign(detM) * detM.abs() ** (1.0 / 3.0)
    c = torch.where(c.abs() < 1e-12, torch.full_like(c, 1e-12), c)
    R = _polar_so3(M / c[..., None, None])
    t = P[..., 3] / c[..., None]
    return R, t


def gauss_newton_refine(
    aa0: Tensor, t0: Tensor, X: Tensor, uv: Tensor, weights: Tensor, K: Tensor,
    iters: int = 10,
) -> tuple[Tensor, Tensor]:
    """Fixed-iteration damped Gauss-Newton on the reprojection residual (the
    SOLVEPNP_ITERATIVE-equivalent polish).

    The Jacobian is in closed form (the JAX package takes ``jacfwd`` of the
    same residual)."""
    fx, fy = K[0, 0], K[1, 1]
    eye = torch.eye(6, dtype=X.dtype, device=X.device)
    params = torch.cat([aa0, t0])
    w = weights[:, None]
    for _ in range(iters):
        q, dq_daa, _ = geo.angle_axis_rotate_jac(params[:3], X)
        xc = q + params[3:]
        in_front = xc[:, 2] > 1e-9  # _project_std clamps z there: no z-derivative
        z = torch.clamp(xc[:, 2], min=1e-9)
        pred = torch.stack([xc[:, 0] / z * fx + K[0, 2], xc[:, 1] / z * fy + K[1, 2]], dim=-1)
        zero = torch.zeros_like(z)
        dz = in_front.to(X.dtype) / (z * z)
        dpred_dxc = torch.stack(
            [
                torch.stack([fx / z, zero, -fx * xc[:, 0] * dz], dim=-1),
                torch.stack([zero, fy / z, -fy * xc[:, 1] * dz], dim=-1),
            ],
            dim=-2,
        )  # (N, 2, 3)
        J = -torch.cat([dpred_dxc @ dq_daa, dpred_dxc], dim=-1) * w[:, :, None]  # (N, 2, 6)
        J = J.reshape(-1, 6)
        r = ((uv - pred) * w).reshape(-1)
        H = J.T @ J + 1e-6 * eye
        g = J.T @ r
        params = params - gj_solve(H, g[:, None])[:, 0]
    return params[:3], params[3:]


def solve_pnp_ransac(
    X: Tensor,
    uv: Tensor,
    valid: Tensor,
    K: Tensor,
    gen: torch.Generator | None,
    R_guess: Tensor,
    t_guess: Tensor,
    n_hypos: int = 128,
    thresh_px: float = 8.0,
    refine_iters: int = 10,
    samples: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """RANSAC PnP: returns (R (3,3), t (3,), inliers (N,)).

    X (N, 3): object points (standard camera-frame convention of the caller),
    uv (N, 2): observed pixels, valid (N,): mask. ``R_guess/t_guess`` join the
    hypothesis pool (the reference passes the previous pose with
    useExtrinsicGuess=true, OpenCVEPnPSolver.cpp:35-36). ``samples``
    (n_hypos, 6) index tensor, when given, replaces the generator draw.
    """
    xn = torch.stack(
        [(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], dim=-1
    )
    idx = samples if samples is not None else sample_minimal_sets(gen, valid, n_hypos, 6)
    idx = idx.long()
    ones6 = torch.ones(idx.shape, dtype=X.dtype, device=X.device)
    Rs, ts = _dlt_pose(X[idx], xn[idx], ones6)  # (H, 3, 3), (H, 3)
    # Extrinsic guess as an extra hypothesis.
    Rs = torch.cat([Rs, R_guess[None]], dim=0)
    ts = torch.cat([ts, t_guess[None]], dim=0)

    def reproj_err(R, t):
        pred = _project_std(geo.rodrigues_inv(R), t, X, K)
        behind = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2] <= 0
        err = torch.linalg.norm(uv - pred, dim=-1)
        return torch.where(behind, torch.full_like(err, torch.inf), err)

    errs = reproj_err(Rs, ts)  # (H+1, N)
    inl = (errs < thresh_px) & valid[None, :]
    best, best_mask = best_hypothesis(inl)
    R_best, t_best = Rs[best], ts[best]

    w = best_mask.to(X.dtype)
    aa, t = gauss_newton_refine(
        geo.rodrigues_inv(R_best), t_best, X, uv, w, K, iters=refine_iters
    )
    R = geo.rodrigues(aa)
    err = reproj_err(R, t)
    inliers = (err < thresh_px) & valid
    # Keep the refinement only if it did not lose inliers.
    better = torch.sum(inliers) >= torch.sum(best_mask)
    R = torch.where(better, R, R_best)
    t = torch.where(better, t, t_best)
    inliers = torch.where(better, inliers, best_mask)
    return R, t, inliers
