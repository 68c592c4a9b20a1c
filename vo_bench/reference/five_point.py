"""The five-point minimal solver of the essential matrix, written plainly:
the 4-dimensional nullspace of the 5x9 epipolar constraints gives
``E = x E1 + y E2 + z E3 + E4``; the ten cubic constraints (``det E = 0``
and ``2 E E^T E - tr(E E^T) E = 0``) form a 10x20 matrix over the monomials
of degree 3 or less in graded reverse lexicographic order; eliminating the
ten cubic monomials leaves the action matrix of multiplication by ``x`` on
the basis ``x^2, xy, xz, y^2, yz, z^2, x, y, z, 1``, whose real eigenpairs
are the solutions (Stewenius, Engels and Nister, "Recent developments on
direct relative orientation", ISPRS 2006)."""

from __future__ import annotations

import itertools

import torch

from vo_bench.reference.prec import Prec

# monomials x^a y^b z^c of degree <= 3: the ten cubic ones first, then the basis
_MONO = [m for d in (3, 2, 1, 0) for m in sorted(
    (m for m in itertools.product(range(4), repeat=3) if sum(m) == d), reverse=True)]
_INDEX = {m: i for i, m in enumerate(_MONO)}
_BASIS = _MONO[10:]
assert _BASIS == [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
                  (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]


def _product_table(device):
    """T[i, j, k] = 1 where monomial i times monomial j is monomial k."""
    T = torch.zeros((20, 20, 20), dtype=torch.float64, device=device)
    for i, a in enumerate(_MONO):
        for j, b in enumerate(_MONO):
            k = _INDEX.get(tuple(p + q for p, q in zip(a, b)))
            if k is not None:
                T[i, j, k] = 1.0
    return T


def nullspace(x1, x2, P: Prec):
    """(H, 4, 3, 3) bases of the nullspaces of the (H, 5, 9) constraints
    ``x2h^T E x1h = 0`` (E row-major), from x1, x2: (H, 5, 2)."""
    ones = torch.ones_like(x1[..., :1])
    x1h, x2h = torch.cat([x1, ones], -1), torch.cat([x2, ones], -1)
    A = P.q(torch.einsum("hni,hnj->hnij", x2h, x1h).reshape(x1.shape[0], 5, 9))
    _, _, Vh = torch.linalg.svd(A, full_matrices=True)
    return P.q(Vh[:, 5:].reshape(-1, 4, 3, 3))


def constraints(Eb, P: Prec):
    """The (H, 10, 20) coefficients of the ten cubic constraints."""
    H, dev, dt = Eb.shape[0], Eb.device, Eb.dtype
    T = _product_table(dev).to(dt)
    E = torch.zeros((H, 3, 3, 20), dtype=dt, device=dev)
    for v, m in enumerate(((1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0))):
        E[..., _INDEX[m]] = Eb[:, v]

    def mul(p, q):
        return P.q(torch.einsum("...i,...j,ijk->...k", p, q, T))

    EEt = P.q(sum(mul(E[:, :, None, k], E[:, None, :, k]) for k in range(3)))
    EEtE = P.q(sum(mul(EEt[:, :, k, None], E[:, None, k, :]) for k in range(3)))
    tr = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    trace_rows = P.q(2.0 * EEtE - mul(tr[:, None, None], E)).reshape(H, 9, 20)
    e = lambda i, j: E[:, i, j]  # noqa: E731
    det = (mul(e(0, 0), mul(e(1, 1), e(2, 2)) - mul(e(1, 2), e(2, 1)))
           - mul(e(0, 1), mul(e(1, 0), e(2, 2)) - mul(e(1, 2), e(2, 0)))
           + mul(e(0, 2), mul(e(1, 0), e(2, 1)) - mul(e(1, 1), e(2, 0))))
    return P.q(torch.cat([det[:, None], trace_rows], dim=1))


def solve(x1, x2, P: Prec):
    """Up to ten essential matrices per 5-point set. x1, x2: (H, 5, 2) unit-
    plane points. Returns (E (H, 10, 3, 3) of unit Frobenius norm, ok (H, 10))."""
    Eb = nullspace(x1, x2, P)
    M = constraints(Eb, P)
    B, info = torch.linalg.solve_ex(M[:, :, :10], M[:, :, 10:])
    B = P.q(B)
    A = torch.zeros((M.shape[0], 10, 10), dtype=M.dtype, device=M.device)
    for j, b in enumerate(_BASIS):  # x * basis[j], in the basis
        k = _INDEX[(b[0] + 1, b[1], b[2])]
        if k < 10:
            A[:, j] = -B[:, k]
        else:
            A[:, j, k - 10] = 1.0
    good = (info == 0) & torch.isfinite(A).all(dim=(1, 2))
    A = torch.where(good[:, None, None], A, torch.eye(10, dtype=A.dtype, device=A.device))
    lam, V = torch.linalg.eig(A.cpu())
    lam, V = lam.to(A.device), V.to(A.device)
    w = V[:, 9].real
    ok = (lam.imag == 0) & (w.abs() > 1e-12 * V.abs().amax(dim=1)) & good[:, None]
    w = torch.where(ok, w, torch.ones_like(w))
    x, y, z = P.q(lam.real), P.q(V[:, 7].real / w), P.q(V[:, 8].real / w)
    E = (x[..., None, None] * Eb[:, None, 0] + y[..., None, None] * Eb[:, None, 1]
         + z[..., None, None] * Eb[:, None, 2] + Eb[:, None, 3])
    n = torch.linalg.norm(E.reshape(E.shape[:2] + (9,)), dim=-1)[..., None, None]
    return P.q(E / torch.where(n < 1e-12, torch.ones_like(n), n)), ok
