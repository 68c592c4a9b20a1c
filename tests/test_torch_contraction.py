"""XLA's fused multiply-add in the port's eliminations, against the JAX
package under ``jax.jit`` on the CPU.

XLA contracts a multiply that feeds an add in the same fusion into one fused
multiply-add, rounded once; PyTorch's separate operators round twice. In the
pivot-free eliminations that difference is not an ulp here and there: the
pivot row's self-cancellation residual (ROADMAP Queue 3) is what the fused
rounding leaves, and at the PnP polish's scale it decides whether the polish
converges. ``pmv_tpu_torch.core.linalg.fma`` computes the single rounding,
and the port applies it at the sites where the audit below shows that the
contraction changes an outcome.

Every site is fed seeded inputs at full size (512 feature slots, KITTI's
focal length, 128 PnP and 64 five-point hypotheses) and run through the port
and through the JAX package under ``jit``; RANSAC draws come from the JAX
package's ``sample_minimal_sets`` and are injected into the port. The
five-point solver is compared stage by stage with what the JAX package's
``five_point_candidates`` computes inside its compiled call, vmapped over 64
hypotheses as the RANSAC calls it (scripts/torch_hlo_contractions.py prints
that call's fusions). Each test holds the port as it is (one rounding).
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_contraction.py``
prints the audit: every site's counts with two roundings (the port before
``fma``) and with one.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pmv_tpu.ba import schur_lm as j_ba
from pmv_tpu.core import geometry as j_geo
from pmv_tpu.core import linalg as j_linalg
from pmv_tpu.solvers import essential as j_ess
from pmv_tpu.solvers import five_point as j_fp
from pmv_tpu.solvers import pnp as j_pnp
from pmv_tpu.solvers import ransac as j_ransac
from pmv_tpu_torch.ba import schur_lm as ba
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core import linalg
from pmv_tpu_torch.io.synthetic import KITTI_K
from pmv_tpu_torch.solvers import essential as ess
from pmv_tpu_torch.solvers import five_point as fp
from pmv_tpu_torch.solvers import pnp
from pmv_tpu_torch.solvers.ransac import best_hypothesis

# One thread: see tests/test_torch_odometry.py.
torch.set_num_threads(1)

K = KITTI_K.astype(np.float32)
N = 512           # feature slots
PNP_HYPOS = 128   # VOConfig.ransac_pnp_hypos
PNP_THRESH = 3.0  # VOConfig.ransac_pnp_thresh
E_HYPOS = 64      # ransac_budget(256)
PNP_SEEDS = 30
E_SEEDS = 12
HIGHEST = jax.lax.Precision.HIGHEST


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def bits_equal(a, b) -> int:
    """Number of leading-axis items of ``a`` and ``b`` that are equal bit for bit."""
    a, b = np.asarray(a), np.asarray(b)
    return int(sum(np.array_equal(x.view(np.uint32), y.view(np.uint32)) for x, y in zip(a, b)))


def _load_sweep():
    """scripts/torch_contraction_sweep.py, whose ``two_roundings`` gives the
    audit its other rounding of a site."""
    path = Path(__file__).resolve().parent.parent / "scripts" / "torch_contraction_sweep.py"
    spec = importlib.util.spec_from_file_location("_torch_contraction_sweep", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_sweep = _load_sweep()
two_roundings = _sweep.two_roundings


def misrounded(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> tuple[int, int]:
    """(float64 sums that lie exactly halfway between two float32 numbers,
    those of them where ``fma``'s double rounding differs from one rounding
    of the exact a * b + c). Only a tie can differ: there the exact sum's
    side of the tie, the float64 sum's rounding error (TwoSum, exact),
    decides the single rounding, and ``fma`` rounds the tie to even."""
    p = a.double() * b.double()  # exact
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly
    f = s.float()
    toward = torch.where(s > f.double(), torch.full_like(f, np.inf), torch.full_like(f, -np.inf))
    g = torch.nextafter(f, toward)
    tie = (f.double() != s) & (s == (f.double() + g.double()) / 2)
    want = torch.where(err > 0, torch.maximum(f, g), torch.minimum(f, g))
    wrong = tie & (err != 0) & (want != f)
    return int(tie.sum()), int(wrong.sum())


@contextlib.contextmanager
def counting_ties(box: list):
    """Add :func:`misrounded`'s counts of every float32 ``fma`` called
    inside to ``box`` ([ties, misrounded])."""
    real = linalg.fma

    def counted(a, b, c):
        if a.dtype == torch.float32:
            ties, wrong = misrounded(*torch.broadcast_tensors(a, b, c))
            box[0] += ties
            box[1] += wrong
        return real(a, b, c)

    linalg.fma = counted
    try:
        yield
    finally:
        linalg.fma = real


# ------------------------------------------------------------------ inputs


def polish_systems(n=20):
    """tests/test_torch_parity.py's 20 normal equations at the PnP polish's
    scale: J^T J + 1e-6 I over 600 residuals, entries near 1e8."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        Jm = rng.normal(size=(600, 6)) * [800, 1300, 630, 66, 66, 30]
        Jm[:, 1] += 0.9 * Jm[:, 3] * 1300 / 66
        H = (Jm.T @ Jm + 1e-6 * np.eye(6)).astype(np.float32)
        g = (Jm.T @ rng.normal(size=600)).astype(np.float32)
        out.append((H, g))
    return out


def pnp_problem(seed):
    """One full-size PnP call: 512 slots, about 70 % with a landmark, 10 %
    of them outliers, 0.5 px of noise, a forward step of about 1 m at
    KITTI's focal length, and the previous step as the extrinsic guess."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-15, 15, N), rng.uniform(-2, 3, N), rng.uniform(4, 50, N)], -1)
    aa = rng.normal(size=3) * [0.002, 0.01, 0.002]
    th = np.linalg.norm(aa)
    k = aa / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([0.0, 0.0, -1.0]) + rng.normal(size=3) * 0.02
    Xc = X @ R.T + t
    uv = Xc[:, :2] / Xc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv += rng.normal(0, 0.5, uv.shape)
    out = rng.random(N) < 0.1
    uv[out] += rng.uniform(5, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    valid = rng.random(N) < 0.7
    tg = (t + rng.normal(size=3) * 0.05).astype(np.float32)
    return X.astype(np.float32), uv.astype(np.float32), valid, np.eye(3, dtype=np.float32), tg


def two_view(seed):
    """One full-size bootstrap: 512 slots, 80 % tracked, 15 % outliers,
    0.3 px of noise, a forward step at KITTI's focal length."""
    rng = np.random.default_rng(seed)
    X1 = np.stack([rng.uniform(-20, 20, N), rng.uniform(-3, 3, N), rng.uniform(5, 60, N)], -1)
    R = np.asarray(j_geo.rodrigues(J((rng.normal(size=3) * 0.01).astype(np.float32))), np.float64)
    t = np.array([0.02, -0.01, -1.0]) + rng.normal(size=3) * 0.01
    X2 = X1 @ R.T + t

    def proj(X):
        return X[:, :2] / X[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]

    uv1 = proj(X1) + rng.normal(0, 0.3, (N, 2))
    uv2 = proj(X2) + rng.normal(0, 0.3, (N, 2))
    out = rng.random(N) < 0.15
    uv2[out] += rng.uniform(3, 30, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), rng.random(N) < 0.8, hat(t) @ R


def hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


@jax.jit
def j_nullspace(x1, x2):
    """The JAX package's five-point nullspace basis (its ``eigh``), batched."""

    def one(a, b):
        ones = jnp.ones((5, 1), jnp.float32)
        A = jnp.einsum("ni,nj->nij", jnp.concatenate([b, ones], 1), jnp.concatenate([a, ones], 1),
                       precision=HIGHEST).reshape(5, 9)
        _, vecs = jnp.linalg.eigh(jnp.matmul(A.T, A, precision=HIGHEST))
        return vecs[:, :4].T.reshape(4, 3, 3).astype(jnp.float32)

    return jax.vmap(one)(x1, x2)


def five_point_inputs(seed):
    """(the JAX package's nullspace bases (64, 4, 3, 3), the scene, the key,
    the injected samples) of one bootstrap."""
    uv1, uv2, valid, _ = two_view(seed)
    key = jax.random.PRNGKey(seed)
    samples = np.asarray(j_ransac.sample_minimal_sets(key, J(valid), E_HYPOS, 5))
    x1 = ess.normalize_points(T(uv1), T(K))
    x2 = ess.normalize_points(T(uv2), T(K))
    idx = T(samples).long()
    Eb = np.asarray(j_nullspace(J(x1[idx].numpy()), J(x2[idx].numpy())))
    return Eb, (uv1, uv2, valid), key, samples


# ------------------------------------------------------------------ the JAX side, compiled

j_gj_solve = jax.jit(j_linalg.gj_solve)
j_gj_inverse = jax.jit(jax.vmap(j_linalg.gj_inverse))
j_gauss_jordan10 = jax.jit(jax.vmap(j_fp._gauss_jordan10))
j_constraint_rows = jax.jit(jax.vmap(j_fp._constraint_rows))
j_poly = jax.jit(jax.vmap(lambda A: j_fp._poly_from_rows(A)[0]))
j_real_roots = jax.jit(jax.vmap(j_fp._real_roots))
j_candidates = jax.jit(jax.vmap(j_fp.five_point_candidates))


def _stages(x1, x2):
    """``five_point_candidates`` with what each stage hands the next: the
    basis, the constraint rows, the reduced rows, the polynomial, the roots,
    the root grid, and the candidates with their validity."""
    got = {}
    saved = {name: getattr(j_fp, name) for name in
             ("_constraint_rows", "_gauss_jordan10", "_poly_from_rows", "_real_roots")}
    tan = jnp.tan

    def tap(name, key):
        def fn(x):
            if name == "_constraint_rows":
                got["Eb"] = x
            out = saved[name](x)
            got[key] = out[0] if isinstance(out, tuple) else out
            return out
        return fn

    def grid(x):
        got["grid"] = tan(x)
        return got["grid"]

    for name, key in (("_constraint_rows", "M"), ("_gauss_jordan10", "R"),
                      ("_poly_from_rows", "p"), ("_real_roots", "z")):
        setattr(j_fp, name, tap(name, key))
    jnp.tan = grid
    try:
        E, ok = j_fp.five_point_candidates(x1, x2)
    finally:
        for name, fn in saved.items():
            setattr(j_fp, name, fn)
        jnp.tan = tan
    return {k: got[k] for k in ("Eb", "M", "R", "p", "z", "grid")} | {"E": E, "ok": ok}


# The compiled call above with every stage's output as an output as well
# (the same arithmetic: the stages are materialised in the call anyway).
j_stages = jax.jit(jax.vmap(_stages))


@jax.jit
def j_horner(p, z):
    """``_real_roots``' ``peval`` (and ``assemble``'s ``ev``), batched."""

    def one(p, z):
        out = jnp.zeros_like(z)
        for i in range(p.shape[0] - 1, -1, -1):
            out = out * z + p[i]
        return out

    return jax.vmap(one)(p, z)


@functools.partial(jax.jit, static_argnames=("thresh", "hypos"))
def j_pnp_decisions(X, uv, valid, K, key, Rg, tg, thresh=PNP_THRESH, hypos=PNP_HYPOS):
    """``solve_pnp_ransac``'s steps (same pieces, same order), returning the
    winning DLT hypothesis, its inliers, the polish's keep decision and the
    final inliers."""
    xn = jnp.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], axis=-1)
    idx = j_ransac.sample_minimal_sets(key, valid, hypos, 6)
    Rs, ts = jax.vmap(lambda i: j_pnp._dlt_pose(X[i], xn[i], jnp.ones(6, X.dtype)))(idx)
    Rs = jnp.concatenate([Rs, Rg[None]])
    ts = jnp.concatenate([ts, tg[None]])

    def reproj_err(R, t):
        pred = j_pnp._project_std(j_geo.rodrigues_inv(R), t, X, K)
        behind = (jnp.matmul(X, R.T, precision=HIGHEST) + t)[:, 2] <= 0
        return jnp.where(behind, jnp.inf, jnp.linalg.norm(uv - pred, axis=-1))

    inl = (jax.vmap(reproj_err)(Rs, ts) < thresh) & valid[None]
    best, best_mask = j_ransac.best_hypothesis(inl)
    aa, t = j_pnp.gauss_newton_refine(j_geo.rodrigues_inv(Rs[best]), ts[best], X, uv,
                                      best_mask.astype(X.dtype), K)
    inliers = (reproj_err(j_geo.rodrigues(aa), t) < thresh) & valid
    better = jnp.sum(inliers) >= jnp.sum(best_mask)
    return best, best_mask, better, jnp.where(better, inliers, best_mask)


def t_pnp_decisions(X, uv, valid, samples, Rg, tg, K=K, thresh=PNP_THRESH):
    """The port's ``solve_pnp_ransac`` steps, returning what
    :func:`j_pnp_decisions` returns."""
    X, uv, valid, Kt = T(X), T(uv), T(valid), T(K)
    xn = torch.stack([(uv[:, 0] - Kt[0, 2]) / Kt[0, 0], (uv[:, 1] - Kt[1, 2]) / Kt[1, 1]], -1)
    idx = T(samples).long()
    Rs, ts = pnp._dlt_pose(X[idx], xn[idx], torch.ones(idx.shape))
    Rs = torch.cat([Rs, T(Rg)[None]])
    ts = torch.cat([ts, T(tg)[None]])

    def reproj_err(R, t):
        pred = pnp._project_std(geo.rodrigues_inv(R), t, X, Kt)
        behind = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2] <= 0
        err = torch.linalg.norm(uv - pred, dim=-1)
        return torch.where(behind, torch.full_like(err, torch.inf), err)

    inl = (reproj_err(Rs, ts) < thresh) & valid[None]
    best, best_mask = best_hypothesis(inl)
    aa, t = pnp.gauss_newton_refine(geo.rodrigues_inv(Rs[best]), ts[best], X, uv, best_mask.float(), Kt)
    inliers = (reproj_err(geo.rodrigues(aa), t) < thresh) & valid
    better = bool(inliers.sum() >= best_mask.sum())
    return int(best), best_mask.numpy(), better, (inliers if better else best_mask).numpy()


# ------------------------------------------------------------------ the audit, site by site


def audit_gj_solve():
    """``gj_solve`` on the polish-scale systems: bit-equal solutions, and
    float64 misses beyond 1 % (port, JAX)."""
    eq = miss = j_miss = 0
    for H, g in polish_systems():
        want = np.linalg.solve(H.astype(np.float64), g.astype(np.float64))
        got = linalg.gj_solve(T(H), T(g)[:, None]).numpy()
        ref = np.asarray(j_gj_solve(J(H), J(g)[:, None]))
        eq += bits_equal(got[None], ref[None])
        for x, box in ((got, "port"), (ref, "jax")):
            off = np.abs(x[:, 0].astype(np.float64) - want).max() > 1e-2 * np.abs(want).max()
            if box == "port":
                miss += off
            else:
                j_miss += off
    return {"n": 20, "bit_equal": eq, "f64_miss_port": int(miss), "f64_miss_jax": int(j_miss)}


def dlt_grams(seed):
    """The ridged 12x12 DLT Gram matrices of one PnP call's 128 hypotheses,
    as ``_smallest_eigvec12`` hands them to ``gj_inverse`` (built by the
    JAX package, so both sides invert the same matrices)."""
    X, uv, valid, _, _ = pnp_problem(seed)
    key = jax.random.PRNGKey(seed)
    idx = np.asarray(j_ransac.sample_minimal_sets(key, J(valid), PNP_HYPOS, 6))
    xn = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], -1)

    def gram(Xs, xs):
        Xh = jnp.concatenate([Xs, jnp.ones((6, 1), Xs.dtype)], 1)
        z = jnp.zeros((6, 4), Xs.dtype)
        A = jnp.concatenate([jnp.concatenate([Xh, z, -xs[:, 0:1] * Xh], 1),
                             jnp.concatenate([z, Xh, -xs[:, 1:2] * Xh], 1)], 0)
        M = jnp.matmul(A.T, A, precision=HIGHEST)
        return M + (1e-7 * jnp.trace(M) / 12.0 + 1e-12) * jnp.eye(12, dtype=M.dtype)

    return np.asarray(jax.jit(jax.vmap(gram))(J(X[idx]), J(xn[idx].astype(np.float32))))


def audit_gj_inverse(seeds=range(3)):
    eq = n = 0
    for s in seeds:
        M = dlt_grams(s)
        eq += bits_equal(linalg.gj_inverse(T(M)).numpy(), j_gj_inverse(J(M)))
        n += len(M)
    return {"n": n, "bit_equal": eq}


def audit_pnp(seeds=range(PNP_SEEDS)):
    """The whole PnP call: DLT winner, its inliers, the polish's keep
    decision and the final inliers, port against JAX."""
    st = dict(n=0, same_dlt_winner=0, same_dlt_inliers=0, polish_kept_jax=0,
              polish_kept_port=0, polish_disagree=0, final_inliers_disagree=0)
    for s in seeds:
        X, uv, valid, Rg, tg = pnp_problem(s)
        key = jax.random.PRNGKey(s)
        samples = np.asarray(j_ransac.sample_minimal_sets(key, J(valid), PNP_HYPOS, 6))
        jb, jm, jkeep, jinl = j_pnp_decisions(J(X), J(uv), J(valid), J(K), key, J(Rg), J(tg))
        b, m, keep, inl = t_pnp_decisions(X, uv, valid, samples, Rg, tg)
        st["n"] += 1
        st["same_dlt_winner"] += int(jb) == b
        st["same_dlt_inliers"] += np.array_equal(np.asarray(jm), m)
        st["polish_kept_jax"] += bool(jkeep)
        st["polish_kept_port"] += keep
        st["polish_disagree"] += bool(jkeep) != keep
        st["final_inliers_disagree"] += int((np.asarray(jinl) != inl).sum())
    return st


def e_dist(Ea, Eb):
    a = np.asarray(Ea, np.float64) / np.linalg.norm(Ea)
    b = np.asarray(Eb, np.float64) / np.linalg.norm(Eb)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


@functools.lru_cache(maxsize=None)
def five_point_stages(seed):
    """One bootstrap's 64 samples through the JAX package's compiled
    ``five_point_candidates`` (:data:`j_stages`), as numpy arrays."""
    _, (uv1, uv2, _), _, samples = five_point_inputs(seed)
    x1, x2 = (ess.normalize_points(T(u), T(K))[T(samples).long()].numpy() for u in (uv1, uv2))
    return {k: np.asarray(v) for k, v in j_stages(J(x1), J(x2)).items()}


def audit_five_point_chain(seeds=range(4)):
    """The port's five-point stages on the JAX package's compiled inputs of
    each stage (its nullspace bases, its constraint rows, its reduced rows,
    its polynomials), and chained from its bases through
    ``candidates_from_basis``: the systems whose stage output is bit-equal
    to the JAX package's, the systems whose roots' validity disagrees and
    the systems with a candidate E that is not bit-equal."""
    st = dict(n=0, rows=0, reductions=0, polys=0, roots=0, chained_roots=0,
              validity_disagree=0, candidates_differ=0)
    for s in seeds:
        j = five_point_stages(s)
        Eb = T(j["Eb"])
        st["n"] += len(Eb)
        st["rows"] += bits_equal(fp._constraint_rows(Eb).numpy(), j["M"])
        st["reductions"] += bits_equal(fp._gauss_jordan10(T(j["M"])).numpy(), j["R"])
        st["polys"] += bits_equal(fp._poly_from_rows(T(j["R"]))[0].numpy(), j["p"])
        st["roots"] += bits_equal(fp._real_roots(T(j["p"]))[0].numpy(), j["z"])
        E, ok, z = fp.candidates_from_basis(Eb)
        st["chained_roots"] += bits_equal(z.numpy(), j["z"])
        st["validity_disagree"] += int((ok.numpy() != j["ok"]).any(1).sum())
        st["candidates_differ"] += len(Eb) - bits_equal(E.numpy(), j["E"])
    return st


def audit_true_E_small(seeds=range(6, 14)):
    """tests/test_torch_solvers.py's ``test_candidates_contain_the_true_essential``
    over 8 scenes (its two-view geometry at f = 500, 40 points, 8 samples
    of 5 each): the samples whose own candidates hold the true E within
    5e-2, the port's (from its own ``eigh`` basis, so not a bar) and the JAX
    package's under ``jit``."""
    Ks = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
    st = dict(samples=0, true_E_port=0, true_E_jax=0)
    for seed in seeds:
        rng = np.random.default_rng(seed)
        X1 = np.stack([rng.uniform(-10, 10, 40), rng.uniform(-5, 5, 40), rng.uniform(8, 40, 40)], -1)
        R = np.asarray(j_geo.rodrigues(J(np.array([0.01, -0.04, 0.005]))))
        t = np.array([0.3, -0.05, -0.9])
        t = t / np.linalg.norm(t)
        X2 = X1 @ R.T + t
        uv = [(X[:, :2] / X[:, 2:3] * [Ks[0, 0], Ks[1, 1]] + [Ks[0, 2], Ks[1, 2]]).astype(np.float32)
              for X in (X1, X2)]
        x1, x2 = (ess.normalize_points(T(u), T(Ks)).reshape(8, 5, 2) for u in uv)
        Es, ok = fp.five_point_candidates(x1, x2)
        jEs, jok = map(np.asarray, j_candidates(J(x1.numpy()), J(x2.numpy())))
        E_gt = hat(t) @ R
        st["samples"] += 8
        for h in range(8):
            st["true_E_port"] += any(ok[h, i] and e_dist(Es[h, i].numpy(), E_gt) < 5e-2 for i in range(10))
            st["true_E_jax"] += any(jok[h, i] and e_dist(jEs[h, i], E_gt) < 5e-2 for i in range(10))
    return st


def audit_peval(seeds=range(4)):
    """``_peval`` on the JAX package's polynomials: values on the root grid
    (bit-equal), signs within 8 ulps of each of its roots, and
    ``_real_roots``' validity and bracket counts."""
    st = dict(grid_values=0, grid_bit_equal=0, near_root_values=0, near_root_sign_disagree=0,
              hypotheses=0, validity_disagree=0, bracket_count_disagree=0)
    zs = torch.from_numpy(fp._root_grid(256))
    for s in seeds:
        Eb, *_ = five_point_inputs(s)
        p = np.asarray(j_poly(j_gauss_jordan10(j_constraint_rows(J(Eb)))))
        H = len(p)
        grid = zs[None].expand(H, -1)
        v = fp._peval(T(p), grid).numpy()
        jv = np.asarray(j_horner(J(p), J(grid.numpy())))
        st["grid_values"] += v.size
        st["grid_bit_equal"] += int((v.view(np.uint32) == jv.view(np.uint32)).sum())
        jz, jok = map(np.asarray, j_real_roots(J(p)))
        near = np.repeat(jz[:, :, None], 17, axis=2)
        steps = np.arange(-8, 9, dtype=np.int32)
        near = (near.view(np.int32) + np.sign(near).astype(np.int32) * steps).view(np.float32)
        near = np.where(jok[:, :, None], near, 0.0).reshape(H, -1).astype(np.float32)
        sv = np.sign(fp._peval(T(p), T(near)).numpy())
        jsv = np.sign(np.asarray(j_horner(J(p), J(near))))
        keep = np.repeat(jok, 17, axis=1)
        st["near_root_values"] += int(keep.sum())
        st["near_root_sign_disagree"] += int((sv != jsv)[keep].sum())
        z, ok = fp._real_roots(T(p))
        st["hypotheses"] += H
        st["validity_disagree"] += int((ok.numpy() != jok).any(1).sum())
        st["bracket_count_disagree"] += int((ok.numpy().sum(1) != jok.sum(1)).sum())
    return st


def audit_five_point(seeds=range(E_SEEDS)):
    """The five-point RANSAC with the JAX package's nullspace bases in the
    port (its ``eigh`` differs from LAPACK's): the winning E and the inlier
    masks; then the Sampson polish from the same start on JAX's inliers."""
    st = dict(n=0, E_bit_equal=0, same_inliers=0, inliers_disagree=0,
              polish_kept_jax=0, polish_kept_port=0, polish_disagree=0)
    real = fp.nullspace_basis
    j_refine = jax.jit(j_ess.refine_relative_pose)
    try:
        for s in seeds:
            Eb, (uv1, uv2, valid), key, samples = five_point_inputs(s)
            fp.nullspace_basis = lambda x1, x2, Eb=Eb: T(Eb)
            jE, jinl = j_fp.find_essential_5pt_ransac(J(uv1), J(uv2), J(valid), J(K), key,
                                                      n_hypos=E_HYPOS, thresh_px=1.0)
            E, inl = fp.find_essential_5pt_ransac(T(uv1), T(uv2), T(valid), T(K), None,
                                                  n_hypos=E_HYPOS, thresh_px=1.0, samples=T(samples))
            jinl = np.asarray(jinl)
            st["n"] += 1
            st["E_bit_equal"] += bits_equal(E.numpy()[None], np.asarray(jE)[None])
            st["same_inliers"] += np.array_equal(inl.numpy(), jinl)
            st["inliers_disagree"] += int((inl.numpy() != jinl).sum())
            x1 = ess.normalize_points(T(uv1), T(K))
            x2 = ess.normalize_points(T(uv2), T(K))
            R0, t0 = np.eye(3, dtype=np.float32), np.array([0.0, 0.0, -1.0], np.float32)
            w = jinl.astype(np.float32)
            jR, _ = j_refine(J(R0), J(t0), J(x1.numpy()), J(x2.numpy()), J(w))
            R, _ = ess.refine_relative_pose(T(R0), T(t0), x1, x2, T(w))
            jkeep = not np.array_equal(np.asarray(jR), R0)
            keep = not np.array_equal(R.numpy(), R0)
            st["polish_kept_jax"] += jkeep
            st["polish_kept_port"] += keep
            st["polish_disagree"] += jkeep != keep
    finally:
        fp.nullspace_basis = real
    return st


def ba_window(seed, P=5, Nn=256, L=400):
    """A float32 BA window at the sliding window's shape (5 poses, KITTI's
    focal length), in the pipeline's conventions (tests/test_torch_ba.py)."""
    rng = np.random.default_rng(seed)
    lm = np.stack([rng.uniform(-15, 15, L), rng.uniform(-3, 3, L), rng.uniform(-50, -5, L)], -1)
    tr = np.zeros((P, 6))
    tr[:, :3] = rng.normal(size=(P, 3)) * 0.005
    tr[:, 5] = np.arange(P) * 1.0
    local = np.stack([rng.permutation(L)[:Nn] for _ in range(P)]).astype(np.int32)
    Kd = K.astype(np.float64)
    uv = np.asarray(j_geo.ba_project(J(tr)[:, None, :], J(lm)[J(local)], J(Kd)))
    uv = uv + rng.normal(size=uv.shape) * 0.5
    mask = rng.random((P, Nn)) > 0.15
    pose_free = np.arange(P) >= 1
    tr0 = tr + rng.normal(size=tr.shape) * 0.01 * pose_free[:, None]
    lm0 = lm + rng.normal(size=lm.shape) * 0.05
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(tr0), f32(lm0), f32(uv), local, mask, pose_free


def accepted(stats) -> np.ndarray:
    """The LM loop's accept decisions, from its cost history."""
    costs = np.concatenate([[float(stats["cost0"])], np.asarray(stats["history"], np.float64)])
    return np.diff(costs) < 0


def audit_ba(seeds=range(8)):
    """The float32 LM loop (``schur_lm.py:311`` solves its reduced camera
    system with ``gj_solve``), 5 iterations from the same start on each
    window: the reduced systems it solves against the JAX package's compiled
    ``gj_solve`` (bit-equal count); windows whose accept decisions equal
    the JAX package's; and the final cost over the float64 loop's, the
    median and the windows within 1.5x, of the port and of the JAX
    package's float32 loop."""
    st = dict(n=0, systems=0, systems_bit_equal=0, same_decisions=0, cost_ratio_median=0.0,
              within_1_5=0, cost_ratio_median_jax=0.0, within_1_5_jax=0)
    real = ba.gj_solve
    systems, ratios, jratios = [], [], []

    def caught(A, B):
        systems.append((A.clone(), B.clone()))
        return real(A, B)

    for s in seeds:
        tr, lm, uv, local, mask, pf = ba_window(s)
        _, _, jst = j_ba.ba_solve_grid(J(tr), J(lm), J(uv), J(local), J(mask), J(pf), J(K), iters=5)
        f64 = [T(a.astype(np.float64)) if a.dtype == np.float32 else T(a) for a in (tr, lm, uv)]
        _, _, st64 = ba.ba_solve_grid(*f64, T(local), T(mask), T(pf), T(K.astype(np.float64)), iters=5)
        ba.gj_solve = caught
        try:
            _, _, tst = ba.ba_solve_grid(T(tr), T(lm), T(uv), T(local), T(mask), T(pf), T(K), iters=5)
        finally:
            ba.gj_solve = real
        st["n"] += 1
        st["same_decisions"] += np.array_equal(accepted(tst), accepted(jst))
        ratios.append(float(tst["cost"]) / float(st64["cost"]))
        jratios.append(float(jst["cost"]) / float(st64["cost"]))
    st["cost_ratio_median"], st["cost_ratio_median_jax"] = float(np.median(ratios)), float(np.median(jratios))
    st["within_1_5"] = int(sum(r < 1.5 for r in ratios))
    st["within_1_5_jax"] = int(sum(r < 1.5 for r in jratios))
    for A, B in systems:
        ref = np.asarray(j_gj_solve(J(A.numpy()), J(B.numpy())))
        st["systems"] += 1
        st["systems_bit_equal"] += bits_equal(linalg.gj_solve(A, B).numpy()[None], ref[None])
    return st


def as_is_and_two_roundings(fn):
    """A site the port changed: (with two roundings, as the port is)."""
    def both():
        with two_roundings():
            before = fn()
        return before, fn()
    return both


# site -> (changed, () -> (two roundings, one rounding))
SITES = {
    "gj_solve (core/linalg.py), polish-scale systems": (True, as_is_and_two_roundings(audit_gj_solve)),
    "gj_inverse at the DLT's 12x12 (pnp._smallest_eigvec12)": (True, as_is_and_two_roundings(audit_gj_inverse)),
    "PnP RANSAC (DLT, polish, inlier scores)": (True, as_is_and_two_roundings(audit_pnp)),
    "five-point stages (five_point.py) from the JAX package's compiled inputs": (
        True, as_is_and_two_roundings(audit_five_point_chain)),
    "five-point: true E among a sample's own candidates, f = 500": (
        True, as_is_and_two_roundings(audit_true_E_small)),
    "_peval (five_point.py), _real_roots": (True, as_is_and_two_roundings(audit_peval)),
    "five-point RANSAC, Sampson polish (essential.py)": (False, as_is_and_two_roundings(audit_five_point)),
    "f32 BA, reduced camera system (schur_lm.py:311)": (True, as_is_and_two_roundings(audit_ba)),
}


# ------------------------------------------------------------------ the helper


def test_fma_rounds_once_like_xla():
    """``fma`` against ``a * b + c`` compiled by XLA, on 100,000 seeded
    float32 triples where the two roundings of eager arithmetic differ from
    one on most (x - p * (x / p) with x near 1e8): equal bit for bit, and no
    float64 sum lands on a float32 tie."""
    rng = np.random.default_rng(0)
    x = (rng.uniform(1, 2, 100_000) * 1e8).astype(np.float32)
    p = (rng.uniform(1, 2, 100_000) * 1e4).astype(np.float32)
    q = x / p
    want = np.asarray(jax.jit(lambda x, p, q: x - p * q)(J(x), J(p), J(q)))
    got = linalg.fma(-T(p), T(q), T(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.count_nonzero(want) >= 99_000
    assert np.count_nonzero(x - p * q) < 20_000  # numpy: two roundings
    assert misrounded(-T(p), T(q), T(x)) == (0, 0)


def test_fma_same_bits_on_strided_and_contiguous_inputs():
    rng = np.random.default_rng(1)
    a, b, c = (T(rng.normal(size=(64, 48)).astype(np.float32) * s) for s in (1e4, 1e3, 1e7))
    want = linalg.fma(a, b, c)
    at, bt, ct = (x.t().contiguous().t() for x in (a, b, c))  # column-major copies
    assert not at.is_contiguous()
    assert torch.equal(linalg.fma(at, bt, ct), want)
    big = torch.zeros(128, 96)
    big[::2, ::2] = a
    assert torch.equal(linalg.fma(big[::2, ::2], b, c), want)
    assert torch.equal(linalg.fma(a[:, :1].expand(64, 48).contiguous(), b, c),
                       linalg.fma(a[:, :1], b, c))  # broadcast


def test_fma_keeps_float64_as_it_is():
    rng = np.random.default_rng(2)
    a, b, c = (T(rng.normal(size=1000)) for _ in range(3))
    assert torch.equal(linalg.fma(a, b, c), a * b + c)


def test_double_rounding_on_the_seeded_systems():
    """Every float32 ``fma`` of the seeded systems, counted: float64 sums on
    a float32 tie are rare on the PnP polish's systems and the DLT's
    inverses and common in the five-point chain (Horner at grid points,
    constraint rows with short mantissas), and on every one of them the
    exact sum is the tie itself, so the double rounding is the single one."""
    polish, five = [0, 0], [0, 0]
    with counting_ties(polish):
        for H, g in polish_systems():
            linalg.gj_solve(T(H), T(g)[:, None])
        linalg.gj_inverse(T(dlt_grams(0)))
    with counting_ties(five):
        Eb, *_ = five_point_inputs(0)
        fp.candidates_from_basis(T(Eb))
    assert polish[0] <= 5 and five[0] > 0, (polish, five)
    assert polish[1] == five[1] == 0, (polish, five)


# ------------------------------------------------------------------ the sites


def test_gj_inverse_at_the_dlt_scale_is_xla_bit_for_bit():
    """All 384 ridged DLT Gram inverses equal the JAX package's; with two
    roundings none did."""
    st = audit_gj_inverse()
    assert st["bit_equal"] == st["n"] == 3 * PNP_HYPOS, st
    with two_roundings():
        assert audit_gj_inverse(seeds=[0])["bit_equal"] == 0


def test_gauss_jordan10_is_xla_bit_for_bit():
    """The port's reduction of the JAX package's compiled constraint rows,
    one rounding a step, equals the JAX package's compiled reduction on all
    256 systems; with two roundings a step it equals it on none."""
    st = audit_five_point_chain()
    assert st["reductions"] == st["n"] == 4 * E_HYPOS, st
    with two_roundings():
        assert audit_five_point_chain(seeds=[0])["reductions"] == 0


def test_poly_from_rows_is_xla_bit_for_bit():
    """From the same reduced rows the port's polynomial (each conv step one
    fused multiply-add, the fourth determinant term's steps added into the
    running sum) equals the JAX package's compiled one on all 256 systems."""
    st = audit_five_point_chain()
    assert st["polys"] == st["n"] == 4 * E_HYPOS, st


def test_constraint_rows_are_xla_bit_for_bit():
    """From the same nullspace bases the port's straight-line program gives
    the JAX package's compiled constraint rows bit for bit on all 256
    systems (the fusions read straight from ``eigh``'s output included)."""
    st = audit_five_point_chain()
    assert st["rows"] == st["n"] == 4 * E_HYPOS, st


def test_root_grid_is_xlas():
    """The port's root grid equals the one the JAX package's compiled
    ``_real_roots`` brackets on, point for point."""
    grid = five_point_stages(0)["grid"][0]
    assert np.array_equal(fp._root_grid(256).view(np.uint32), grid.view(np.uint32))


def test_roots_and_validity_from_the_same_basis_match_xla():
    """From the JAX package's nullspace bases the port's chain lands on the
    JAX package's roots bit for bit on all 256 systems, and the roots'
    validity agrees on every system."""
    st = audit_five_point_chain()
    assert st["roots"] == st["chained_roots"] == st["n"], st
    assert st["validity_disagree"] == 0, st


def test_candidates_from_the_same_basis_match_xla():
    """The candidate essential matrices, assembled with XLA's contractions
    and a correctly rounded norm, are bit-equal to the JAX package's on all
    256 systems."""
    st = audit_five_point_chain()
    assert st["candidates_differ"] == 0, st


def test_peval_signs_near_roots_match_xla():
    """Horner with one rounding a step: every value on the root grid equal
    to the JAX package's compiled ``peval``, and every sign within 8 ulps of
    its roots (the signs that steer the 40-step bisection); root validity
    and bracket counts agree on every hypothesis."""
    st = audit_peval()
    assert st["grid_bit_equal"] == st["grid_values"], st
    assert st["near_root_values"] > 1000 and st["near_root_sign_disagree"] == 0, st
    assert st["validity_disagree"] == st["bracket_count_disagree"] == 0, st


def test_pnp_polish_decisions_match_xla():
    """On 30 full-size PnP calls with the JAX package's samples, the port's
    DLT crowns the same hypothesis with the same inliers on every call (the
    DLT's inverse is bit-equal), and its Gauss-Newton polish is rejected
    where the JAX package's is: XLA's fused residual makes the
    polish-scale solve miss (ROADMAP Queue 3), and the port now carries it.
    J^T J still sums in another order, so a call may go either way; with two
    roundings the port kept the polish on nearly every call and JAX on none."""
    st = audit_pnp()
    assert st["same_dlt_winner"] == st["same_dlt_inliers"] == PNP_SEEDS, st
    assert st["polish_disagree"] <= 3, st
    assert st["polish_kept_jax"] <= 3, st


def test_five_point_and_sampson_polish_from_the_same_basis():
    """From the JAX package's nullspace bases the five-point RANSAC's
    inliers disagree on few slots (the refit's ``eigh``/``svd`` and the root
    grid are LAPACK's and numpy's, not a contraction; the inlier scores were
    left as they are), and the Sampson polish keeps its result where the
    JAX package's does."""
    st = audit_five_point()
    assert st["inliers_disagree"] <= 0.02 * N * E_SEEDS, st
    assert st["polish_disagree"] == 0, st


def test_f32_ba_lands_where_xlas_does():
    """The float32 LM loop at the sliding window's shape (5 poses, KITTI's
    focal length) on 8 windows: every reduced system it solves equals the
    JAX package's compiled solve bit for bit, and its final cost lands as
    far from the float64 loop's as the JAX package's does (the pivot row's
    residual: median 2x or more, few windows within 1.5x). With two
    roundings it was the float64 cost on most windows: the port
    bootstrapped fewer frames than the JAX package (PERF.md, section 6)."""
    st = audit_ba()
    assert st["systems"] == 5 * st["n"] and st["systems_bit_equal"] == st["systems"], st
    assert st["cost_ratio_median"] > 2 and st["cost_ratio_median_jax"] > 2, st
    assert st["within_1_5"] <= 2 and st["within_1_5_jax"] <= 2, st
    with two_roundings():
        two = audit_ba()
    assert two["systems_bit_equal"] == 0 and two["within_1_5"] >= 6, two


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
    for name, (changed, fn) in SITES.items():
        two, one = fn()
        print(f"{name} ({'changed' if changed else 'left at two roundings'})\n"
              f"  two roundings: {two}\n  one rounding:  {one}")
    # the JAX package runs without 64-bit types outside the tests
    jax.config.update("jax_enable_x64", False)
    two, one = as_is_and_two_roundings(audit_ba)()
    print(f"f32 BA, as above, the JAX package without 64-bit types\n"
          f"  two roundings: {two}\n  one rounding:  {one}")
