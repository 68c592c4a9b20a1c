"""The bootstrap's essential matrix and pose, as the configuration states
them. The matrix: five-point RANSAC (a fixed batch of 5-point sets from the
frame's generator, every real solution of each scored by MSAC, the truncated
Sampson error), then three rounds of the weighted 8-point refit on the
inliers, each kept when it loses none. The pose: the four (R, t) of E's SVD, the one with most points in front of
both cameras (inhomogeneous DLT triangulation), a 10-step damped
Gauss-Newton polish of the Sampson error on the inliers (kept only when it
lowers the cost), and the points triangulated again."""

from __future__ import annotations

import torch

from vo_bench.reference import five_point
from vo_bench.reference import geometry as geo
from vo_bench.reference.prec import Prec
from vo_bench.reference.ransac import draw


def normalize(p, K):
    return torch.stack([(p[..., 0] - K[0, 2]) / K[0, 0], (p[..., 1] - K[1, 2]) / K[1, 1]], dim=-1)


def sampson(E, x1, x2):
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Ex1 = x1h @ E.transpose(-1, -2)
    Etx2 = x2h @ E
    num = torch.sum(x2h * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-18)


def eight_point(x1, x2, w, P: Prec):
    """Weighted 8-point E (least eigenvector of A^T A), its singular values
    made (s, s, 0) with s the mean of the first two."""
    ones = torch.ones_like(x1[..., :1])
    x1h, x2h = torch.cat([x1, ones], -1), torch.cat([x2, ones], -1)
    A = torch.einsum("ni,nj->nij", x2h, x1h).reshape(-1, 9) * w[:, None]
    _, vecs = torch.linalg.eigh(P.q(A.T @ A))
    U, s, Vt = torch.linalg.svd(P.q(vecs[:, 0].reshape(3, 3)))
    m = (s[0] + s[1]) * 0.5
    return P.q(U @ torch.diag(torch.stack([m, m, torch.zeros_like(m)])) @ Vt)


def support(E, p1, p2, valid, K, thresh_px: float) -> int:
    """How many valid correspondences E holds under the configuration's
    threshold (Sampson error in float64, unit-plane units)."""
    d = torch.float64
    K = K.to(d)
    thresh2 = (thresh_px / ((K[0, 0] + K[1, 1]) * 0.5)) ** 2
    err = sampson(E.to(d), normalize(p1.to(d), K), normalize(p2.to(d), K))
    return int(((err < thresh2) & valid).sum())


def ransac(p1, p2, valid, K, gen_state, n_hypos: int, thresh_px: float, P: Prec):
    """Returns (E, inliers) of the five-point RANSAC and its refit."""
    p1, p2, K = P.q(p1), P.q(p2), P.q(K)
    x1, x2 = P.q(normalize(p1, K)), P.q(normalize(p2, K))
    thresh2 = (thresh_px / ((K[0, 0] + K[1, 1]) * 0.5)) ** 2
    idx = draw(gen_state, valid, n_hypos, 5)
    Es, ok = five_point.solve(x1[idx], x2[idx], P)
    Es, ok = Es.reshape(-1, 3, 3), ok.reshape(-1)
    errs = P.q(sampson(Es, x1, x2))
    cost = torch.where(ok, torch.sum(torch.where(valid, torch.clamp(errs, max=thresh2), 0.0), dim=1), torch.inf)
    best = torch.argmin(cost)
    E, mask = Es[best], (errs[best] < thresh2) & valid
    for _ in range(3):
        E_new = eight_point(x1, x2, mask.to(x1.dtype), P)
        mask_new = (P.q(sampson(E_new, x1, x2)) < thresh2) & valid
        if int(mask_new.sum()) >= int(mask.sum()):
            E, mask = E_new, mask_new
    return E, mask


def triangulate(R, t, x1, x2):
    """Least-squares point (w = 1) of the four DLT rows of [I|0] and [R|t]."""
    def rows(Pm, x):
        return x[..., 0:1] * Pm[2] - Pm[0], x[..., 1:2] * Pm[2] - Pm[1]

    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P1 = torch.cat([eye, torch.zeros_like(t)[:, None]], dim=1)
    P2 = torch.cat([R, t[:, None]], dim=1)
    A = torch.stack([*rows(P1, x1), *rows(P2, x2)], dim=-2)  # (N, 4, 4)
    M, b = A[..., :3], -A[..., 3]
    AtA = M.transpose(-1, -2) @ M
    det = geo.det3(AtA)
    ok = det.abs() >= 1e-30
    AtA = torch.where(ok[:, None, None], AtA, eye)
    X = torch.linalg.solve(AtA, (M.transpose(-1, -2) @ b[..., None])[..., 0])
    return torch.where(ok[:, None], X, 0.0)


def _residual(params, R, x1, x2, w):
    tn = params[3:] / torch.clamp(torch.linalg.norm(params[3:]), min=1e-12)
    E = geo.hat(tn) @ (geo.rodrigues(params[:3]) @ R)
    return torch.sqrt(sampson(E, x1, x2) + 1e-18) * w


def polish(R, t, x1, x2, w, P: Prec, iters: int = 10):
    jac = torch.func.jacfwd(_residual)
    eye = torch.eye(6, dtype=R.dtype, device=R.device)
    p0 = torch.cat([torch.zeros_like(t), t])
    p = p0
    for _ in range(iters):
        J = jac(p, R, x1, x2, w)
        r = _residual(p, R, x1, x2, w)
        p = P.q(p - torch.linalg.solve(J.T @ J + 1e-8 * eye, J.T @ r))
    if torch.sum(_residual(p, R, x1, x2, w) ** 2) < torch.sum(_residual(p0, R, x1, x2, w) ** 2):
        return geo.rodrigues(p[:3]) @ R, p[3:] / torch.clamp(torch.linalg.norm(p[3:]), min=1e-12)
    return R, t


def recover_pose(E, p1, p2, valid, K, P: Prec):
    """Returns (R, t, X, front) from E and the pixel correspondences."""
    E, p1, p2, K = P.q(E), P.q(p1), P.q(p2), P.q(K)
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(geo.det3(U))
    Vt = Vt * torch.sign(geo.det3(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    x1, x2 = normalize(p1, K), normalize(p2, K)

    def score(R, t):
        X = triangulate(R, t, x1, x2)
        front = (X[:, 2] > 0) & ((X @ R.T + t)[:, 2] > 0) & valid
        return X, front

    Ra, Rb, tu = U @ W @ Vt, U @ W.T @ Vt, U[:, 2]
    cands = [(Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)]
    counts = [int(score(R, t)[1].sum()) for R, t in cands]
    R, t = cands[max(range(4), key=lambda i: (counts[i], -i))]
    R, t = polish(P.q(R), P.q(t), x1, x2, valid.to(x1.dtype), P)
    X, front = score(P.q(R), P.q(t))
    return P.q(R), P.q(t), P.q(X), front
