"""Nister five-point minimal essential-matrix solver, batched over
hypotheses — PyTorch counterpart of ``pmv_tpu/solvers/five_point.py``.

The reference's default triangulator calls cv::findEssentialMat, whose
minimal solver is Nister's five-point algorithm (OpenCVFivePointTri.cpp:24).

1. The 4-dim nullspace of the 5x9 epipolar constraint matrix gives
   ``E = x*E1 + y*E2 + z*E3 + E4``.
2. The 10 cubic constraints (det E = 0 and the trace constraint
   ``2 E E^T E - tr(E E^T) E = 0``) are cubic forms in the 36 basis entries.
   Their monomial structure is fixed, so it is expanded ONCE symbolically
   (a tiny polynomial algebra in pure Python) into a constant matrix; at run
   time the (H, 10, 20) coefficient matrices of all hypotheses are one
   gather-multiply and one matrix product.
3. Gauss-Jordan elimination (partial pivoting, batched) of the 10
   higher-degree (x,y)-monomials leaves three equations linear in (x, y)
   with polynomial-in-z coefficients; their 3x3 determinant is the classic
   degree-10 polynomial p(z).
4. Real roots without a nonsymmetric eigensolver: p is evaluated on a
   tan-substituted grid covering the whole real line, sign changes are
   bracketed, and a fixed number of bisection steps polishes each root —
   branch-free and vectorized over hypotheses.
5. Each root yields (x, y) by a 2x2 solve; candidate E matrices are scored
   downstream by Sampson error like every other hypothesis.

Where the JAX package maps over hypotheses with ``vmap``, every function
here carries a leading hypothesis dimension H.

Reference for the algorithm: D. Nister, "An efficient solution to the
five-point relative pose problem", PAMI 2004.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pmv_tpu_torch.solvers.essential import (
    normalize_points,
    refit_essential,
    sampson_error,
)
from pmv_tpu_torch.solvers.ransac import sample_minimal_sets

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# One-time symbolic expansion. A polynomial in (x, y, z) is
# {(a, b, c): coeff}; a coeff is itself a polynomial in the 36 basis entries,
# {sorted tuple of entry indices: float}.
# ---------------------------------------------------------------------------


def _cmul(u, v):
    out = {}
    for m1, c1 in u.items():
        for m2, c2 in v.items():
            k = tuple(sorted(m1 + m2))
            out[k] = out.get(k, 0.0) + c1 * c2
    return out


def _cadd(u, v, sign=1.0):
    out = dict(u)
    for k, c in v.items():
        out[k] = out.get(k, 0.0) + sign * c
    return out


def _pmul(p, q):
    out = {}
    for (a1, b1, c1), v1 in p.items():
        for (a2, b2, c2), v2 in q.items():
            k = (a1 + a2, b1 + b2, c1 + c2)
            out[k] = _cadd(out.get(k, {}), _cmul(v1, v2))
    return out


def _padd(p, q, sign=1.0):
    out = dict(p)
    for k, v in q.items():
        out[k] = _cadd(out.get(k, {}), v, sign)
    return out


def _pscale(p, s):
    return {k: {m: c * s for m, c in v.items()} for k, v in p.items()}


# Nister column order: the 10 eliminated monomials, then the 10 kept ones.
_ELIM = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
]
_KEPT = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_COLS = _ELIM + _KEPT


@functools.lru_cache(maxsize=None)
def _constraint_structure():
    """The 10 cubic constraints as constants: (triples (T, 3) int64 of basis
    entry indices, select (T, 200) float32) such that, with ``e`` the 36
    flattened basis entries, ``prod_t = e[i_t] e[j_t] e[k_t]`` and
    ``M.reshape(200) = prod @ select``."""
    ent = [
        [
            {
                (1, 0, 0): {(0 * 9 + i * 3 + j,): 1.0},
                (0, 1, 0): {(1 * 9 + i * 3 + j,): 1.0},
                (0, 0, 1): {(2 * 9 + i * 3 + j,): 1.0},
                (0, 0, 0): {(3 * 9 + i * 3 + j,): 1.0},
            }
            for j in range(3)
        ]
        for i in range(3)
    ]
    rows = []

    # det(E) = 0
    def det3(m):
        t1 = _pmul(m[0][0], _padd(_pmul(m[1][1], m[2][2]), _pmul(m[1][2], m[2][1]), -1.0))
        t2 = _pmul(m[0][1], _padd(_pmul(m[1][0], m[2][2]), _pmul(m[1][2], m[2][0]), -1.0))
        t3 = _pmul(m[0][2], _padd(_pmul(m[1][0], m[2][1]), _pmul(m[1][1], m[2][0]), -1.0))
        return _padd(_padd(t1, t2, -1.0), t3)

    rows.append(det3(ent))

    # trace constraint: 2 E E^T E - tr(E E^T) E = 0  (9 equations)
    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(ent[i][k], ent[j][k]))
            EEt[i][j] = acc
    tr = _padd(_padd(EEt[0][0], EEt[1][1]), EEt[2][2])
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(EEt[i][k], ent[k][j]))
            acc = _pscale(acc, 2.0)
            acc = _padd(acc, _pmul(tr, ent[i][j]), -1.0)
            rows.append(acc)

    triple_id: dict[tuple, int] = {}
    entries = []  # (triple index, flat position, coeff)
    for r, row in enumerate(rows):
        for c, mono in enumerate(_COLS):
            for triple, coeff in row.get(mono, {}).items():
                if coeff == 0.0:
                    continue
                t = triple_id.setdefault(triple, len(triple_id))
                entries.append((t, r * 20 + c, coeff))
    triples = np.zeros((len(triple_id), 3), np.int64)
    for triple, t in triple_id.items():
        triples[t] = triple
    select = np.zeros((len(triple_id), 200), np.float32)
    for t, pos, coeff in entries:
        select[t, pos] += coeff
    return triples, select


@functools.lru_cache(maxsize=None)
def _constraint_tensors(device: torch.device):
    triples, select = _constraint_structure()
    return torch.from_numpy(triples).to(device), torch.from_numpy(select).to(device)


def _constraint_rows(Eb: Tensor) -> Tensor:
    """Eb: (H, 4, 3, 3) nullspace bases. Returns the (H, 10, 20) coefficient
    matrices of the 10 cubic constraints in Nister's column order."""
    H = Eb.shape[0]
    triples, select = _constraint_tensors(Eb.device)
    e = Eb.reshape(H, 36)
    prod = e[:, triples[:, 0]] * e[:, triples[:, 1]] * e[:, triples[:, 2]]
    return (prod @ select).reshape(H, 10, 20)


def _gauss_jordan10(A: Tensor) -> Tensor:
    """Reduce the (H, 10, 20) systems so the left 10x10 blocks become
    identity (partial pivoting, fixed 10 steps)."""
    H = A.shape[0]
    ar = torch.arange(H, device=A.device)
    idx = torch.arange(10, device=A.device)
    A = A.clone()
    for col in range(10):
        # choose pivot among rows >= col
        cand = torch.where(idx >= col, A[:, :, col].abs(), -1.0)
        p = torch.argmax(cand, dim=1)
        # swap rows p and col
        rp = A[ar, p].clone()
        rc = A[:, col].clone()
        A[:, col] = rp
        A[ar, p] = torch.where((p == col)[:, None], rp, rc)
        pivot = A[:, col, col]
        safe = torch.where(pivot.abs() < 1e-12, torch.full_like(pivot, 1e-12), pivot)
        A[:, col] = A[:, col] / safe[:, None]
        # eliminate this column from all other rows
        factors = A[:, :, col].clone()
        factors[:, col] = 0.0
        A = A - factors[:, :, None] * A[:, col][:, None, :]
    return A


def _conv(a: Tensor, b: Tensor) -> Tensor:
    """Polynomial product along the last dim (ascending coefficients)."""
    n = a.shape[-1] + b.shape[-1] - 1
    out = torch.zeros(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    for i in range(a.shape[-1]):
        out[..., i : i + b.shape[-1]] += a[..., i : i + 1] * b
    return out


def _pad_to(c: Tensor, n: int) -> Tensor:
    return torch.nn.functional.pad(c, (0, n - c.shape[-1]))


def _poly_from_rows(A: Tensor):
    """Degree-10 polynomial coefficients from the reduced systems.

    Rows (by leading eliminated monomial): 4 -> x^2 z, 5 -> x^2, 6 -> y^2 z,
    7 -> y^2, 8 -> xyz, 9 -> xy. k = row<x^2 z> - z*row<x^2> etc. give three
    equations B(z) [x, y, 1]^T = 0; p(z) = det B(z). Returns ((H, 11)
    coeffs, ascending powers of z, and the (k, l, m) coefficient groups).
    """
    R = A[:, :, 10:]  # coefficients over the _KEPT columns

    def row_groups(r):
        # r: (H, 10) over [xz^2, xz, x, yz^2, yz, y, z^3, z^2, z, 1]
        cx = torch.stack([r[:, 2], r[:, 1], r[:, 0]], dim=-1)  # x: 1, z, z^2
        cy = torch.stack([r[:, 5], r[:, 4], r[:, 3]], dim=-1)  # y: 1, z, z^2
        c1 = torch.stack([r[:, 9], r[:, 8], r[:, 7], r[:, 6]], dim=-1)  # 1..z^3
        return cx, cy, c1

    def combine(row_hi, row_lo):
        # k = row_hi - z * row_lo, coefficient lists per (x, y, 1) group
        hi = row_groups(row_hi)
        lo = row_groups(row_lo)
        return tuple(
            torch.nn.functional.pad(h, (0, 1)) - torch.nn.functional.pad(l, (1, 0))
            for h, l in zip(hi, lo)
        )  # degrees 3, 3, 4

    k = combine(R[:, 4], R[:, 5])
    l = combine(R[:, 6], R[:, 7])
    m = combine(R[:, 8], R[:, 9])

    def det_term(a, b, c):
        return _pad_to(_conv(a, _conv(b, c)), 11)

    p = (
        det_term(k[0], l[1], m[2])
        - det_term(k[0], l[2], m[1])
        - det_term(k[1], l[0], m[2])
        + det_term(k[1], l[2], m[0])
        + det_term(k[2], l[0], m[1])
        - det_term(k[2], l[1], m[0])
    )
    return p, (k, l, m)


def _peval(p: Tensor, z: Tensor) -> Tensor:
    """Horner evaluation of (H, d+1) ascending coefficients at z (H, G)."""
    out = torch.zeros_like(z)
    for i in range(p.shape[-1] - 1, -1, -1):
        out = out * z + p[:, i : i + 1]
    return out


@functools.lru_cache(maxsize=None)
def _root_grid(n_grid: int) -> np.ndarray:
    """tan-spaced grid over the real line, built in float64 and cast once."""
    theta = np.linspace(-np.pi / 2 * 0.999, np.pi / 2 * 0.999, n_grid)
    return np.tan(theta).astype(np.float32)


def _real_roots(p: Tensor, n_grid: int = 256, bisect_iters: int = 40):
    """Real roots of (H, 11) degree-10 polynomials, all-real-line coverage
    via z = tan(theta). Returns (roots (H, 10), valid (H, 10))."""
    H = p.shape[0]
    zs = torch.from_numpy(_root_grid(n_grid)).to(p.device)
    vals = _peval(p, zs[None, :].expand(H, n_grid))
    sign = torch.sign(vals)
    flips = sign[:, :-1] * sign[:, 1:] < 0  # (H, n_grid-1)
    # take up to 10 bracket positions (by grid order); the rest go to a pad
    rank = torch.cumsum(flips.to(torch.int64), dim=1) - 1
    idx = torch.where(flips & (rank < 10), rank, 10)
    lo_pad = torch.zeros((H, 11), dtype=p.dtype, device=p.device)
    hi_pad = torch.zeros((H, 11), dtype=p.dtype, device=p.device)
    ok_pad = torch.zeros((H, 11), dtype=torch.bool, device=p.device)
    lo_pad.scatter_(1, idx, zs[None, :-1].expand(H, -1))
    hi_pad.scatter_(1, idx, zs[None, 1:].expand(H, -1))
    ok_pad.scatter_(1, idx, torch.ones_like(flips))
    lo, hi, ok = lo_pad[:, :10], hi_pad[:, :10], ok_pad[:, :10]
    for _ in range(bisect_iters):
        mid = (lo + hi) / 2
        same = torch.sign(_peval(p, mid)) == torch.sign(_peval(p, lo))
        lo = torch.where(same, mid, lo)
        hi = torch.where(same, hi, mid)
    return (lo + hi) / 2, ok


def nullspace_basis(x1: Tensor, x2: Tensor) -> Tensor:
    """(H, 4, 3, 3) bases E1..E4 of the 4-dim nullspaces of the 5x9 epipolar
    constraint matrices, from x1, x2: (H, 5, 2). Any orthonormal basis of
    the nullspace serves; which one ``eigh`` returns depends on the LAPACK
    routine behind it."""
    H = x1.shape[0]
    ones = torch.ones((H, 5, 1), dtype=x1.dtype, device=x1.device)
    x1h = torch.cat([x1, ones], dim=2)
    x2h = torch.cat([x2, ones], dim=2)
    A = torch.einsum("hni,hnj->hnij", x2h, x1h).reshape(H, 5, 9)
    # eigenvectors of A^T A (9x9 symmetric), ascending eigenvalues
    AtA = A.transpose(1, 2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[:, :, :4].transpose(1, 2).reshape(H, 4, 3, 3).to(torch.float32)


def candidates_from_basis(Eb: Tensor):
    """Solve ``E = x*E1 + y*E2 + z*E3 + E4`` for the essential-matrix
    constraints. Eb: (H, 4, 3, 3). Returns (E (H, 10, 3, 3) unit Frobenius
    norm, valid (H, 10), roots z (H, 10))."""
    M = _constraint_rows(Eb)
    Mr = _gauss_jordan10(M)
    p, (k, l, m) = _poly_from_rows(Mr)
    z, ok = _real_roots(p)  # (H, 10)

    B = [[_peval(g, z) for g in grp] for grp in (k, l, m)]
    # solve [B00 B01; B10 B11] [x y] = -[B02; B12]
    det = B[0][0] * B[1][1] - B[0][1] * B[1][0]
    safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    x = (-B[0][2] * B[1][1] + B[0][1] * B[1][2]) / safe
    y = (-B[0][0] * B[1][2] + B[0][2] * B[1][0]) / safe
    coef = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)  # (H, 10, 4)
    E = torch.einsum("hrk,hkij->hrij", coef, Eb)
    n = torch.linalg.norm(E, dim=(-2, -1), keepdim=True)
    E = E / torch.where(n < 1e-12, torch.ones_like(n), n)
    return E, ok, z


def five_point_candidates(x1: Tensor, x2: Tensor):
    """Candidate essential matrices from 5 unit-plane correspondences per
    hypothesis. x1, x2: (H, 5, 2). Returns (E (H, 10, 3, 3), valid (H, 10))
    — up to 10 real solutions each, masked."""
    E, ok, _ = candidates_from_basis(nullspace_basis(x1, x2))
    return E, ok


def ransac_budget(e_hypos: int) -> int:
    """Shared five-point hypothesis budget: ``e_hypos // 4`` (= 64 at the
    default ransac_e_hypos=256), at least 16. The solver scores all 10
    candidate E's per 5-point sample and refits the winner with iterated
    weighted 8-point, so fewer samples are needed than an adaptive
    0.99-confidence loop draws (OpenCVFivePointTri.cpp:24)."""
    return max(16, e_hypos // 4)


def find_essential_5pt_ransac(
    p1: Tensor,
    p2: Tensor,
    valid: Tensor,
    K: Tensor,
    gen: torch.Generator | None,
    n_hypos: int = 64,
    thresh_px: float = 1.0,
    samples: Tensor | None = None,
):
    """RANSAC with the five-point minimal solver: ``n_hypos`` 5-point samples
    -> up to 10 candidate E each -> MSAC over all candidates -> iterated
    weighted 8-point refit on the winning inlier set. Returns (E (3, 3),
    inliers (N,)). ``samples`` (n_hypos, 5) index tensor, when given,
    replaces the generator draw."""
    x1 = normalize_points(p1, K)
    x2 = normalize_points(p2, K)
    f_avg = (K[0, 0] + K[1, 1]) * 0.5
    thresh2 = (thresh_px / f_avg) ** 2

    idx = samples if samples is not None else sample_minimal_sets(gen, valid, n_hypos, 5)
    idx = idx.long()
    Es, ok = five_point_candidates(x1[idx], x2[idx])
    Es = Es.reshape(-1, 3, 3)  # (H*10, 3, 3)
    ok = ok.reshape(-1)

    errs = sampson_error(Es, x1, x2)  # (H*10, N)
    masked = torch.where(valid[None, :], torch.minimum(errs, thresh2), 0.0)
    msac = torch.where(ok, torch.sum(masked, dim=1), torch.inf)
    best = torch.argmin(msac)
    best_mask = (errs[best] < thresh2) & valid
    best_E = Es[best].to(x1.dtype)
    return refit_essential(best_E, best_mask, x1, x2, valid, thresh2)
