"""Nister five-point minimal essential-matrix solver, batched over
hypotheses — PyTorch counterpart of ``pmv_tpu/solvers/five_point.py``.

The reference's default triangulator calls cv::findEssentialMat, whose
minimal solver is Nister's five-point algorithm (OpenCVFivePointTri.cpp:24).

1. The 4-dim nullspace of the 5x9 epipolar constraint matrix gives
   ``E = x*E1 + y*E2 + z*E3 + E4``.
2. The 10 cubic constraints (det E = 0 and the trace constraint
   ``2 E E^T E - tr(E E^T) E = 0``) are cubic forms in the 36 basis entries.
   Their monomial structure is fixed, so it is expanded ONCE symbolically
   (a tiny polynomial algebra in pure Python), as the JAX package expands it
   at trace time, into a straight-line program of fused multiply-adds that
   rounds as XLA's compiled expansion does; at run time the (H, 10, 20)
   coefficient matrices of all hypotheses are its 10 levels.
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

from pmv_tpu_torch.core import linalg
from pmv_tpu_torch.solvers.essential import (
    normalize_points,
    refit_essential,
    sampson_error,
)
from pmv_tpu_torch.solvers.ransac import sample_minimal_sets

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# The 10 cubic constraints as XLA compiles the JAX package's expansion.
#
# The JAX package expands the constraints at trace time over jnp scalars, and
# XLA computes each of the 200 coefficients in a fusion of its own. Within a
# fusion LLVM first puts the operands of every add and multiply in rank order
# (its Reassociate pass: a read ranks by its place among the reads, an
# operation one above its higher operand), then contracts each add or
# subtract with a product used only there into a fused multiply-add, taking
# its first operand's product when both are. The port replays those rules on
# the same expansion (scripts/torch_hlo_contractions.py prints the fusions
# and their fused multiply-adds) and evaluates the result as one
# straight-line program of fused multiply-adds.
# ---------------------------------------------------------------------------

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


def _expansion():
    """The JAX package's trace-time expansion as XLA receives it: a list of
    nodes ``(op, *operands)``, op ``"in"`` (basis entry ``a*9 + i*3 + j``),
    ``"mul"``, ``"add"``, ``"neg"`` (times -1) or ``"twice"`` (times 2), and
    the (10, 20) coefficient nodes (None where a monomial is absent). An add
    or multiply equal to an earlier one up to operand order is that one, as
    XLA's CSE merges them; adds of 0 and products with 1 vanish."""
    nodes, index = [], {}

    def node(*t):
        key = (t[0], *sorted(t[1:])) if t[0] in ("add", "mul") else t
        if key not in index:
            index[key] = len(nodes)
            nodes.append(t)
        return index[key]

    def add(x, y):
        return y if x is None else node("add", x, y)

    def pmul(p, q):
        out = {}
        for (a1, b1, c1), v1 in p.items():
            for (a2, b2, c2), v2 in q.items():
                k = (a1 + a2, b1 + b2, c1 + c2)
                out[k] = add(out.get(k), node("mul", v1, v2))
        return out

    def padd(p, q, sign=1.0):
        out = dict(p)
        for k, v in q.items():
            out[k] = add(out.get(k), v if sign == 1.0 else node("neg", v))
        return out

    ent = [
        [
            {(1, 0, 0): node("in", i * 3 + j), (0, 1, 0): node("in", 9 + i * 3 + j),
             (0, 0, 1): node("in", 18 + i * 3 + j), (0, 0, 0): node("in", 27 + i * 3 + j)}
            for j in range(3)
        ]
        for i in range(3)
    ]

    def det3(m):
        t1 = pmul(m[0][0], padd(pmul(m[1][1], m[2][2]), pmul(m[1][2], m[2][1]), -1.0))
        t2 = pmul(m[0][1], padd(pmul(m[1][0], m[2][2]), pmul(m[1][2], m[2][0]), -1.0))
        t3 = pmul(m[0][2], padd(pmul(m[1][0], m[2][1]), pmul(m[1][1], m[2][0]), -1.0))
        return padd(padd(t1, t2, -1.0), t3)

    rows = [det3(ent)]  # det(E) = 0
    # trace constraint: 2 E E^T E - tr(E E^T) E = 0  (9 equations)
    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = padd(acc, pmul(ent[i][k], ent[j][k]))
            EEt[i][j] = acc
    tr = padd(padd(EEt[0][0], EEt[1][1]), EEt[2][2])
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = padd(acc, pmul(EEt[i][k], ent[k][j]))
            acc = {k: node("twice", v) for k, v in acc.items()}
            rows.append(padd(acc, pmul(tr, ent[i][j]), -1.0))
    return nodes, [[r.get(c) for c in _COLS] for r in rows]


def _operands(t):
    return () if t[0] == "in" else t[1:]


def _read_order(nodes, root):
    """The order in which XLA's emitter reads the basis entries of one
    fusion: it lists the nodes breadth first from the root (operands right to
    left), walks that list backwards and emits each node after its operands
    (left to right); a basis entry is read where it is emitted."""
    listed, seen, i = [root], {root}, 0
    while i < len(listed):
        for a in reversed(_operands(nodes[listed[i]])):
            if a not in seen:
                seen.add(a)
                listed.append(a)
        i += 1
    done, reads = set(), []

    def emit(n):
        if n in done:
            return
        done.add(n)
        for a in _operands(nodes[n]):
            emit(a)
        if nodes[n][0] == "in":
            reads.append(n)

    for n in reversed(listed):
        emit(n)
    return reads


def _fusion(nodes, root, from_eigh):
    """One coefficient's fusion after LLVM: {node: op}, where op is
    ``("in", k)``, ``("mul", a, b)``, ``("twice", a)`` or ``("fma", a, b, c,
    sa, sc)`` = sa * a * b + sc * c rounded once (an add or subtract takes the
    form ``("fma", x, one, y, 1, +-1)``). ``from_eigh``: XLA reads this
    fusion's entries straight from ``eigh``'s output (the coefficients of a
    pure power of x, y or z and the constant one), each through a select on
    ``eigh``'s status, whose one read after the first entry's gives the
    first two reads one rank."""
    rank = {}
    for k, n in enumerate(_read_order(nodes, root), 1):
        rank[n] = max(k + (k >= 2), 3) + 1 if from_eigh else k
    ops, order = {}, []

    def visit(n):
        if n in ops:
            return
        t = nodes[n]
        if t[0] == "add":  # x + (-y) is x - y (LLVM's InstCombine)
            x, y = t[1], t[2]
            if nodes[y][0] == "neg":
                t = ("sub", x, nodes[y][1])
            elif nodes[x][0] == "neg":
                t = ("sub", y, nodes[x][1])
        for a in _operands(t):
            visit(a)
        if t[0] != "in":
            rank[n] = max(rank[a] for a in _operands(t)) + (t[0] != "neg")
            if t[0] in ("add", "mul") and rank[t[2]] < rank[t[1]]:
                t = (t[0], t[2], t[1])
        ops[n] = t
        order.append(n)

    visit(root)
    uses = {}
    for n in order:
        for a in _operands(ops[n]):
            uses[a] = uses.get(a, 0) + 1
    out = {}
    for n in order:
        t = ops[n]
        if t[0] in ("add", "sub"):
            sign = 1.0 if t[0] == "add" else -1.0
            x, y = t[1], t[2]
            if ops[x][0] in ("mul", "twice") and uses[x] == 1:
                out[n] = ("fma", *_factors(ops[x]), y, 1.0, sign)
            elif ops[y][0] in ("mul", "twice") and uses[y] == 1:
                out[n] = ("fma", *_factors(ops[y]), x, sign, 1.0)
            else:
                out[n] = ("fma", x, "one", y, 1.0, sign)
        else:
            out[n] = t
    return out


def _factors(t):
    return (t[1], t[2]) if t[0] == "mul" else (t[1], "two")


@functools.lru_cache(maxsize=None)
def _constraint_program():
    """The 200 fusions merged into one straight-line program over a value
    table whose columns are the 36 basis entries, 0, 1, 2 and then every
    distinct operation. Returns (levels: a list of int64 arrays (5, n) of
    destination, a, b, c columns and float32 arrays (2, n) of the signs sa,
    sc, with every operation of a level depending only on earlier levels;
    the (200,) column of each coefficient; the number of columns)."""
    nodes, roots = _expansion()
    cols = {"zero": 36, "one": 37, "two": 38}
    program, level = [], {}
    out = np.full(200, cols["zero"], np.int64)
    for r in range(10):
        for c in range(20):
            if roots[r][c] is None:
                continue
            ops = _fusion(nodes, roots[r][c], _COLS[c].count(0) >= 2)
            memo = {}

            def column(n):
                if isinstance(n, str):
                    return cols[n]
                if n not in memo:
                    t = ops[n]
                    if t[0] == "in":
                        memo[n] = t[1]
                        return memo[n]
                    if t[0] == "mul":
                        key = (column(t[1]), column(t[2]), cols["zero"], 1.0, 1.0)
                    elif t[0] == "twice":
                        key = (column(t[1]), cols["two"], cols["zero"], 1.0, 1.0)
                    else:
                        key = (column(t[1]), column(t[2]), column(t[3]), t[4], t[5])
                    if key not in cols:
                        cols[key] = 39 + len(program)
                        program.append(key)
                        level[cols[key]] = 1 + max(level.get(k, 0) for k in key[:3])
                    memo[n] = cols[key]
                return memo[n]

            out[r * 20 + c] = column(roots[r][c])
    levels = []
    for lv in range(1, max(level.values()) + 1):
        sel = [(39 + i, *key) for i, key in enumerate(program) if level[39 + i] == lv]
        levels.append((np.array([k[:4] for k in sel], np.int64).T,
                       np.array([k[4:] for k in sel], np.float32).T))
    return levels, out, 39 + len(program)


@functools.lru_cache(maxsize=None)
def _constraint_tensors(device: torch.device):
    levels, out, width = _constraint_program()
    return ([(torch.from_numpy(i).to(device), torch.from_numpy(sg).to(device)) for i, sg in levels],
            torch.from_numpy(out).to(device), width)


def _constraint_rows(Eb: Tensor) -> Tensor:
    """Eb: (H, 4, 3, 3) nullspace bases. Returns the (H, 10, 20) coefficient
    matrices of the 10 cubic constraints in Nister's column order, each
    coefficient rounded as the JAX package's compiled expansion rounds it."""
    H = Eb.shape[0]
    levels, out, width = _constraint_tensors(Eb.device)
    V = torch.zeros((H, width), dtype=torch.float32, device=Eb.device)
    V[:, :36] = Eb.reshape(H, 36)
    V[:, 37], V[:, 38] = 1.0, 2.0
    for idx, sign in levels:
        dst, a, b, c = idx
        V[:, dst] = linalg.fma(V[:, a] * sign[0], V[:, b], V[:, c] * sign[1])
    return V[:, out].reshape(H, 10, 20)


def _gauss_jordan10(A: Tensor) -> Tensor:
    """Reduce the (H, 10, 20) systems so the left 10x10 blocks become
    identity (partial pivoting, fixed 10 steps). Each elimination step is
    rounded once (:func:`linalg.fma`), as in the JAX package's compiled
    reduction (tests/test_torch_contraction.py)."""
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
        A = linalg.fma(-factors[:, :, None], A[:, col][:, None, :], A)
    return A


def _conv(a: Tensor, b: Tensor, out: Tensor | None = None) -> Tensor:
    """Polynomial product along the last dim (ascending coefficients), as the
    JAX package's compiled ``conv``: the first step is the product
    ``a[0] * b``, and every later step ``out[i : i + len(b)] += a[i] * b`` is
    one fused multiply-add. Given ``out``, every step, the first too, adds
    into a copy of it: XLA folds a sum ``out + conv(a, b)`` into the conv's
    steps."""
    nb = b.shape[-1]
    if out is None:
        out = torch.zeros(a.shape[:-1] + (a.shape[-1] + nb - 1,), dtype=a.dtype, device=a.device)
        out[..., :nb] = a[..., :1] * b
        first = 1
    else:
        out, first = out.clone(), 0
    for i in range(first, a.shape[-1]):
        out[..., i : i + nb] = linalg.fma(a[..., i : i + 1], b, out[..., i : i + nb])
    return out


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

    def det_term(a, b, c):  # 11 coefficients for every term
        return _conv(a, _conv(b, c))

    # The determinant's six terms, combined as XLA compiles the JAX package's
    # ``((((t1 - t2) - t3) + t4) + t5) - t6``: the fourth term's steps add
    # into the running sum (scripts/torch_hlo_contractions.py prints the
    # fusions).
    p = (
        det_term(k[0], l[1], m[2])
        - det_term(k[0], l[2], m[1])
        - det_term(k[1], l[0], m[2])
    )
    p = _conv(k[1], _conv(l[2], m[0]), out=p)
    p = p + det_term(k[2], l[0], m[1]) - det_term(k[2], l[1], m[0])
    return p, (k, l, m)


def _peval(p: Tensor, z: Tensor) -> Tensor:
    """Horner evaluation of (H, d+1) ascending coefficients at z (H, G), one
    rounding a step as the JAX package's compiled Horner loop, and a step
    below the smallest normal float flushed to zero, as XLA's CPU runtime
    flushes denormals (near a root at 0 the bisection's signs depend on it)."""
    tiny = torch.finfo(torch.float32).tiny
    out = torch.zeros_like(z)
    for i in range(p.shape[-1] - 1, -1, -1):
        out = linalg.fma(out, z, p[:, i : i + 1])
        out = torch.where(out.abs() < tiny, out * 0.0, out)
    return out


# The points of the 256-point grid where glibc's ``tanf``, which XLA calls
# on the CPU, returns the float one ulp from the correctly rounded tan.
_TANF_ULPS = {40: -1, 80: 1, 83: 1, 177: 1, 189: -1, 227: -1}


@functools.lru_cache(maxsize=None)
def _root_grid(n_grid: int) -> np.ndarray:
    """The JAX package's tan-spaced grid over the real line, as its compiled
    root finder computes it: ``jnp.linspace`` in float32 (``start * (1 - i *
    r) + i * (stop * r)`` with ``r = 1 / (n - 1)``, every step rounded, the
    last point ``stop``), then tan rounded to float32 as glibc's ``tanf``
    rounds it."""
    f32 = np.float32
    start, stop = f32(-np.pi / 2 * 0.999), f32(np.pi / 2 * 0.999)
    i = np.arange(n_grid - 1, dtype=f32)
    r = f32(1.0 / (n_grid - 1))
    theta = np.append(start * (f32(1) - i * r) + i * (stop * r), stop)
    z = np.tan(theta.astype(np.float64)).astype(f32)
    if n_grid == 256:
        for k, ulps in _TANF_ULPS.items():
            z[k] = (z[k:k + 1].view(np.int32) + np.int32(ulps)).view(f32)[0]
    return z


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
    # solve [B00 B01; B10 B11] [x y] = -[B02; B12]; every product that XLA
    # contracts into the subtraction or sum after it is rounded once
    det = linalg.fma(B[0][0], B[1][1], -(B[0][1] * B[1][0]))
    safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    x = linalg.fma(B[0][1], B[1][2], -(B[0][2] * B[1][1])) / safe
    y = linalg.fma(B[0][2], B[1][0], -(B[0][0] * B[1][2])) / safe
    x, y, zz = (v[..., None, None] for v in (x, y, z))
    E0, E1, E2, E3 = (Eb[:, None, i] for i in range(4))
    E = linalg.fma(zz, E2, linalg.fma(x, E0, y * E1)) + E3  # (H, 10, 3, 3)
    e = E.reshape(E.shape[:2] + (9,))
    sq = e[..., 0] * e[..., 0]  # the norm's sum of squares, in row-major order
    for i in range(1, 9):
        sq = linalg.fma(e[..., i], e[..., i], sq)
    # sqrt in float64, rounded once: PyTorch's float32 sqrt on the CPU is not
    # correctly rounded (on 6,639 of 1e6 seeded values), XLA's and the card's are
    n = torch.sqrt(sq.double()).float()[..., None, None]
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
