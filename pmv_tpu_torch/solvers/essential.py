"""Essential-matrix refit, pose recovery and triangulation — PyTorch
counterpart of ``pmv_tpu/solvers/essential.py``.

Replacement for the reference's bootstrap triangulator
(OpenCVFivePointTri.cpp:5-54): ``cv::findEssentialMat`` + ``cv::recoverPose``
(cheirality + triangulation). The default minimal solver is the five-point
algorithm (``five_point.py``); this module holds the eight-point RANSAC
(``essential_solver=eight_point``: batched normalized 8-point hypotheses,
Sampson scoring, MSAC selection, iterated refit), the weighted 8-point
refit, pose recovery and the Sampson Gauss-Newton polish.

Conventions (identical to OpenCV): points x1 in camera-1 frame map to camera
2 as ``x2 = R x1 + t``; E satisfies ``x2_hat^T E x1_hat = 0`` with
``E = [t]_x R``; triangulated points are in the camera-1 frame with z > 0 in
front.
"""

from __future__ import annotations

import torch

from pmv_tpu_torch.core.geometry import hat as geo_hat
from pmv_tpu_torch.core.geometry import rodrigues as geo_rodrigues
from pmv_tpu_torch.core.linalg import det3
from pmv_tpu_torch.solvers.ransac import sample_minimal_sets

Tensor = torch.Tensor


def normalize_points(p: Tensor, K: Tensor) -> Tensor:
    """Pixels (..., 2) -> unit-plane coordinates via K^-1."""
    x = (p[..., 0] - K[0, 2]) / K[0, 0]
    y = (p[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)


def _eight_point(x1: Tensor, x2: Tensor, w: Tensor) -> Tensor:
    """Weighted 8-point solve on unit-plane coords.

    x1, x2: (..., N, 2); w: (..., N) nonnegative weights (0 excludes a row).
    Returns E (..., 3, 3) with the (1, 1, 0) singular-value constraint
    enforced.
    """
    ones = torch.ones_like(x1[..., 0])
    A = torch.stack(
        [
            x2[..., 0] * x1[..., 0],
            x2[..., 0] * x1[..., 1],
            x2[..., 0],
            x2[..., 1] * x1[..., 0],
            x2[..., 1] * x1[..., 1],
            x2[..., 1],
            x1[..., 0],
            x1[..., 1],
            ones,
        ],
        dim=-1,
    )  # (N, 9)
    A = A * w[..., None]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)  # ascending eigenvalues
    E = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    # Enforce rank-2 essential structure with equal singular values.
    U, s, Vt = torch.linalg.svd(E)
    s_mean = (s[..., 0] + s[..., 1]) * 0.5
    zero = torch.zeros_like(s_mean)
    return (U * torch.stack([s_mean, s_mean, zero], dim=-1)[..., None, :]) @ Vt


def sampson_error(E: Tensor, x1: Tensor, x2: Tensor) -> Tensor:
    """First-order (Sampson) epipolar distance squared, unit-plane units.
    E: (..., 3, 3); x1, x2: (N, 2). Returns (..., N) squared distances."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Ex1 = x1h @ E.transpose(-1, -2)  # (..., N, 3)
    Etx2 = x2h @ E  # (..., N, 3)
    num = torch.sum(x2h * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-18)


def find_essential_ransac(
    p1: Tensor,
    p2: Tensor,
    valid: Tensor,
    K: Tensor,
    gen: torch.Generator | None,
    n_hypos: int = 256,
    thresh_px: float = 1.0,
    samples: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """RANSAC essential matrix from pixel correspondences with the 8-point
    minimal solver.

    p1, p2: (N, 2) pixels; valid: (N,) mask. Returns (E (3,3), inliers (N,)).
    Replaces cv::findEssentialMat(RANSAC, 0.99, 1px) at
    OpenCVFivePointTri.cpp:24 with a fixed batch of ``n_hypos`` hypotheses,
    selected by MSAC and refit three times. ``samples`` (n_hypos, 8) index
    tensor, when given, replaces the generator draw.
    """
    x1 = normalize_points(p1, K)
    x2 = normalize_points(p2, K)
    f_avg = (K[0, 0] + K[1, 1]) * 0.5
    thresh2 = (thresh_px / f_avg) ** 2

    idx = samples if samples is not None else sample_minimal_sets(gen, valid, n_hypos, 8)
    idx = idx.long()
    Es = _eight_point(x1[idx], x2[idx], torch.ones(idx.shape, dtype=x1.dtype, device=x1.device))
    errs = sampson_error(Es, x1, x2)  # (H, N)
    # MSAC model selection: minimize the truncated error sum.
    msac = torch.sum(torch.where(valid[None, :], torch.minimum(errs, thresh2), 0.0), dim=1)
    best = torch.argmin(msac)
    best_mask = (errs[best] < thresh2) & valid
    return refit_essential(Es[best], best_mask, x1, x2, valid, thresh2)


def refit_essential(E: Tensor, mask: Tensor, x1: Tensor, x2: Tensor, valid: Tensor,
                    thresh2, rounds: int = 3) -> tuple[Tensor, Tensor]:
    """Iterated refit: weighted 8-point on the current inliers -> new inlier
    set, kept when it does not lose inliers."""
    for _ in range(rounds):
        E_new = _eight_point(x1, x2, mask.to(x1.dtype))
        err = sampson_error(E_new, x1, x2)
        mask_new = (err < thresh2) & valid
        better = torch.sum(mask_new) >= torch.sum(mask)
        E = torch.where(better, E_new, E)
        mask = torch.where(better, mask_new, mask)
    return E, mask


def refine_relative_pose(
    R: Tensor, t: Tensor, x1: Tensor, x2: Tensor, weights: Tensor, iters: int = 10
) -> tuple[Tensor, Tensor]:
    """Polish (R, t) by damped Gauss-Newton on the Sampson error (unit-plane
    coords). t is renormalized to unit length each step (5-DOF problem with a
    6-param chart + damping)."""

    def residual(params):
        Rp = geo_rodrigues(params[:3]) @ R
        tp = params[3:]
        tn = tp / torch.clamp(torch.linalg.norm(tp), min=1e-12)
        E = geo_hat(tn) @ Rp
        return torch.sqrt(sampson_error(E, x1, x2) + 1e-18) * weights

    jac = torch.func.jacfwd(residual)
    eye = torch.eye(6, dtype=R.dtype, device=R.device)
    params0 = torch.cat([torch.zeros(3, dtype=R.dtype, device=R.device), t])
    params = params0
    for _ in range(iters):
        J = jac(params)
        r = residual(params)
        H = J.T @ J + 1e-8 * eye
        g = J.T @ r
        params = params - torch.linalg.solve(H, g)
    R_out = geo_rodrigues(params[:3]) @ R
    t_out = params[3:] / torch.clamp(torch.linalg.norm(params[3:]), min=1e-12)
    # Reject a diverged polish.
    cost0 = torch.sum(residual(params0) ** 2)
    cost1 = torch.sum(residual(params) ** 2)
    ok = cost1 < cost0
    return torch.where(ok, R_out, R), torch.where(ok, t_out, t)


def triangulate_points(R: Tensor, t: Tensor, x1: Tensor, x2: Tensor) -> Tensor:
    """Linear (DLT) triangulation on unit-plane coordinates, batched over N:
    the eigenvector of the least eigenvalue of each (4, 4) ``A^T A``. Camera
    1 is [I|0], camera 2 is [R|t] (x2 = R x1 + t). Returns (N, 3) points in
    the camera-1 frame (z <= 0 possible for outliers; callers apply
    cheirality masks). The eigenvector's sign cancels in the division by its
    fourth component. The per-frame path uses :func:`triangulate_points_fast`
    (a batched small ``eigh`` is slow on an accelerator)."""
    dt, dev = R.dtype, R.device
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev), torch.zeros((3, 1), dtype=dt, device=dev)], dim=1)
    P2 = torch.cat([R, t[:, None]], dim=1)

    def rows(P, x):
        r1 = x[..., 0:1] * P[2][None, :] - P[0][None, :]
        r2 = x[..., 1:2] * P[2][None, :] - P[1][None, :]
        return r1, r2

    a1, a2 = rows(P1, x1)
    a3, a4 = rows(P2, x2)
    A = torch.stack([a1, a2, a3, a4], dim=-2)  # (N, 4, 4)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Xh = vecs[..., :, 0]
    w = Xh[..., 3]
    w_safe = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / w_safe[..., None]


def triangulate_points_fast(R: Tensor, t: Tensor, x1: Tensor, x2: Tensor) -> Tensor:
    """Inhomogeneous DLT triangulation, batched over N: the 4 DLT rows with
    w fixed to 1, so the solve is a 3x3 normal-equation closed form
    (adjugate). Camera 1 is [I|0], camera 2 is [R|t]. Returns (N, 3) points
    in the camera-1 frame (z <= 0 possible for outliers; callers apply
    cheirality masks)."""
    dt, dev = R.dtype, R.device
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev), torch.zeros((3, 1), dtype=dt, device=dev)], dim=1)
    P2 = torch.cat([R, t[:, None]], dim=1)

    def rows(P, x):
        r1 = x[..., 0:1] * P[2][None, :] - P[0][None, :]
        r2 = x[..., 1:2] * P[2][None, :] - P[1][None, :]
        return r1, r2

    a1, a2 = rows(P1, x1)
    a3, a4 = rows(P2, x2)
    A = torch.stack([a1, a2, a3, a4], dim=-2)  # (N, 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = torch.einsum("nij,nik->njk", M, M)
    Atb = torch.einsum("nij,ni->nj", M, b)
    r0, r1_, r2_ = AtA[..., 0, :], AtA[..., 1, :], AtA[..., 2, :]
    cof0 = torch.stack(
        [
            r1_[..., 1] * r2_[..., 2] - r1_[..., 2] * r2_[..., 1],
            r0[..., 2] * r2_[..., 1] - r0[..., 1] * r2_[..., 2],
            r0[..., 1] * r1_[..., 2] - r0[..., 2] * r1_[..., 1],
        ],
        dim=-1,
    )
    cof1 = torch.stack(
        [
            r1_[..., 2] * r2_[..., 0] - r1_[..., 0] * r2_[..., 2],
            r0[..., 0] * r2_[..., 2] - r0[..., 2] * r2_[..., 0],
            r0[..., 2] * r1_[..., 0] - r0[..., 0] * r1_[..., 2],
        ],
        dim=-1,
    )
    cof2 = torch.stack(
        [
            r1_[..., 0] * r2_[..., 1] - r1_[..., 1] * r2_[..., 0],
            r0[..., 1] * r2_[..., 0] - r0[..., 0] * r2_[..., 1],
            r0[..., 0] * r1_[..., 1] - r0[..., 1] * r1_[..., 0],
        ],
        dim=-1,
    )
    det = torch.sum(r0 * cof0, dim=-1)
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    inv = torch.stack([cof0, cof1, cof2], dim=-1)  # adjugate^T rows
    return torch.einsum("njk,nk->nj", inv, Atb) / det[..., None]


def recover_pose(
    E: Tensor, p1: Tensor, p2: Tensor, valid: Tensor, K: Tensor
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Cheirality-disambiguated pose from E + triangulation.

    Mirrors cv::recoverPose (OpenCVFivePointTri.cpp:26): decompose E into the
    4 (R, t) candidates, pick the one with most triangulated points in front
    of both cameras, polish it, and return (R, t_unit, points3d (N, 3) in
    cam-1 frame, in_front (N,) mask). |t| = 1.
    """
    U, _, Vt = torch.linalg.svd(E)
    # Ensure proper rotations
    U = U * torch.sign(det3(U))
    Vt = Vt * torch.sign(det3(Vt))
    W = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device
    )
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    tu = U[:, 2]
    x1 = normalize_points(p1, K)
    x2 = normalize_points(p2, K)

    def score(R, t):
        X = triangulate_points_fast(R, t, x1, x2)
        z1 = X[:, 2]
        z2 = (X @ R.T + t)[:, 2]
        front = (z1 > 0) & (z2 > 0) & valid
        return torch.sum(front), X, front

    cands = [(Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)]
    scores = torch.stack([score(R, t)[0] for R, t in cands])
    k = torch.argmax(scores)
    R = torch.stack([c[0] for c in cands])[k]
    t = torch.stack([c[1] for c in cands])[k]
    # Gauss-Newton Sampson polish on the inlier set, then re-triangulate.
    R, t = refine_relative_pose(R, t, x1, x2, valid.to(x1.dtype))
    _, X, front = score(R, t)
    return R, t, X, front
