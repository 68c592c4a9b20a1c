"""solvers/ of the port against the JAX package on synthetic two-view and
PnP geometry. The RANSAC draws cannot be reproduced across frameworks, so
the tests compute the minimal sets with the JAX package's own
``sample_minimal_sets`` on the very key the JAX solver uses and inject them
into the port (``samples=``): both sides then solve the same hypotheses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.core import geometry as j_geo
from pmv_tpu.solvers import essential as j_ess
from pmv_tpu.solvers import five_point as j_fp
from pmv_tpu.solvers import pnp as j_pnp
from pmv_tpu.solvers import ransac as j_ransac
from pmv_tpu_torch.solvers import essential as ess
from pmv_tpu_torch.solvers import five_point as fp
from pmv_tpu_torch.solvers import pnp
from pmv_tpu_torch.solvers import ransac

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def make_two_view(seed, n=200, n_outliers=0, noise=0.0):
    """Two-view problem in the standard convention (x2 = R x1 + t, z > 0 in
    front), float32 pixels."""
    rng = np.random.default_rng(seed)
    X1 = np.stack([rng.uniform(-10, 10, n), rng.uniform(-5, 5, n), rng.uniform(8, 40, n)], -1)
    aa = np.array([0.01, -0.04, 0.005])
    R = np.asarray(j_geo.rodrigues(jnp.asarray(aa)))
    t = np.array([0.3, -0.05, -0.9])
    t = t / np.linalg.norm(t)
    X2 = X1 @ R.T + t
    uv1 = X1[:, :2] / X1[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv2 = X2[:, :2] / X2[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    if noise:
        uv1 = uv1 + rng.normal(0, noise, uv1.shape)
        uv2 = uv2 + rng.normal(0, noise, uv2.shape)
    if n_outliers:
        idx = rng.choice(n, n_outliers, replace=False)
        uv2[idx] += rng.uniform(20, 80, (n_outliers, 2)) * rng.choice([-1, 1], (n_outliers, 2))
    return {
        "X1": X1.astype(np.float32), "X2": X2.astype(np.float32), "R": R, "t": t,
        "uv1": uv1.astype(np.float32), "uv2": uv2.astype(np.float32),
    }


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


def e_dist(Ea, Eb):
    a = np.asarray(Ea, np.float64) / np.linalg.norm(Ea)
    b = np.asarray(Eb, np.float64) / np.linalg.norm(Eb)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


class TestRansacUtils:
    def test_sample_minimal_sets_draws_valid_distinct_indices(self):
        gen = torch.Generator().manual_seed(3)
        valid = torch.zeros(50, dtype=torch.bool)
        valid[10:30] = True
        idx = ransac.sample_minimal_sets(gen, valid, 64, 6)
        assert idx.shape == (64, 6)
        assert bool(valid[idx].all())
        assert all(len(set(r.tolist())) == 6 for r in idx)
        # roughly uniform over the valid slots
        counts = torch.bincount(idx.reshape(-1), minlength=50)[10:30]
        assert counts.min() >= 5
        # seeded: same generator state, same draw
        idx2 = ransac.sample_minimal_sets(torch.Generator().manual_seed(3), valid, 64, 6)
        assert torch.equal(idx, idx2)

    def test_best_hypothesis_first_among_equals(self):
        rng = np.random.default_rng(0)
        m = rng.random((9, 30)) > 0.5
        m[4] = m[2]
        b, mask = ransac.best_hypothesis(T(m))
        jb, jmask = j_ransac.best_hypothesis(J(m))
        assert int(b) == int(jb)
        assert np.array_equal(mask.numpy(), np.asarray(jmask))


class TestEssentialPieces:
    def test_sampson_and_normalize(self):
        tv = make_two_view(0, n=60, noise=0.5)
        x1 = ess.normalize_points(T(tv["uv1"]), T(K))
        jx1 = j_ess.normalize_points(J(tv["uv1"]), J(K))
        np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), rtol=1e-6, atol=1e-7)
        x2 = ess.normalize_points(T(tv["uv2"]), T(K))
        E = (np.asarray(j_geo.hat(J(tv["t"]))) @ tv["R"]).astype(np.float32)
        got = ess.sampson_error(T(E), x1, x2)
        ref = j_ess.sampson_error(J(E), J(x1.numpy()), J(x2.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-12)

    def test_eight_point_up_to_sign(self):
        """eigh/svd bases are not unique across LAPACK routines: compare E up
        to sign and scale (2e-3 on unit-norm entries, noisy data)."""
        tv = make_two_view(1, n=120, noise=0.3)
        x1 = ess.normalize_points(T(tv["uv1"]), T(K))
        x2 = ess.normalize_points(T(tv["uv2"]), T(K))
        w = (np.random.default_rng(1).random(120) > 0.2).astype(np.float32)
        got = ess._eight_point(x1, x2, T(w))
        ref = j_ess._eight_point(J(x1.numpy()), J(x2.numpy()), J(w))
        assert e_dist(got.numpy(), ref) < 2e-3

    def test_triangulate_fast(self):
        tv = make_two_view(2, n=80)
        x1 = ess.normalize_points(T(tv["uv1"]), T(K))
        x2 = ess.normalize_points(T(tv["uv2"]), T(K))
        R, t = tv["R"].astype(np.float32), tv["t"].astype(np.float32)
        got = ess.triangulate_points_fast(T(R), T(t), x1, x2)
        ref = j_ess.triangulate_points_fast(J(R), J(t), J(x1.numpy()), J(x2.numpy()))
        # closed-form solve of an f32 3x3 normal matrix whose conditioning
        # falls with the parallax (far points): 1e-2 relative between the two
        # frameworks' summation orders, median 1e-4
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-2, atol=1e-3)
        rel = np.abs(got.numpy() - np.asarray(ref)) / np.abs(np.asarray(ref)).clip(1e-3)
        assert np.median(rel) < 1e-4
        rel_gt = np.abs(got.numpy() - tv["X1"]) / np.abs(tv["X1"]).clip(1e-2)
        assert np.median(rel_gt) < 2e-3

    @pytest.mark.parametrize("noise", [0.0, 0.4])
    def test_recover_pose(self, noise):
        """(R, t) after recover_pose's own sign fixes: rotation within 1e-3
        rad, unit t within 1e-3, cheirality masks equal on >= 99 %."""
        tv = make_two_view(3, n=150, noise=noise)
        E = (np.asarray(j_geo.hat(J(tv["t"]))) @ tv["R"]).astype(np.float32) * 1.7
        valid = np.random.default_rng(3).random(150) > 0.1
        jR, jt, jX, jf = j_ess.recover_pose(J(E), J(tv["uv1"]), J(tv["uv2"]), J(valid), J(K))
        R, t, X, f = ess.recover_pose(T(E), T(tv["uv1"]), T(tv["uv2"]), T(valid), T(K))
        assert rot_angle(R.numpy(), jR) < 1e-3
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-3)
        assert (f.numpy() == np.asarray(jf)).mean() >= 0.99
        both = f.numpy() & np.asarray(jf)
        # triangulated points: ill-conditioned for far points (see
        # test_triangulate_fast), so median 1e-3 and 95th percentile 2e-2
        rel = np.abs(X.numpy()[both] - np.asarray(jX)[both]) / np.abs(np.asarray(jX)[both]).clip(1e-2)
        assert np.median(rel) < 1e-3
        assert np.quantile(rel, 0.95) < 2e-2
        assert rot_angle(R.numpy(), tv["R"]) < 5e-3


class TestFivePoint:
    def test_constraint_rows_match_the_jax_expansion(self):
        """The one-time symbolic expansion against the JAX package's
        trace-time one: rows agree to 1e-5 of the row scale."""
        rng = np.random.default_rng(4)
        Eb = rng.normal(size=(3, 4, 3, 3)).astype(np.float32)
        got = fp._constraint_rows(T(Eb)).numpy()
        for h in range(3):
            ref = np.asarray(j_fp._constraint_rows(J(Eb[h])))
            np.testing.assert_allclose(got[h], ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())

    def test_gauss_jordan_and_poly(self):
        rng = np.random.default_rng(5)
        A = rng.normal(size=(4, 10, 20)).astype(np.float32)
        got = fp._gauss_jordan10(T(A))
        for h in range(4):
            ref = np.asarray(j_fp._gauss_jordan10(J(A[h])))
            np.testing.assert_allclose(got[h].numpy(), ref, rtol=2e-3, atol=2e-3)
        p, _ = fp._poly_from_rows(got)
        for h in range(4):
            jp, _ = j_fp._poly_from_rows(J(got[h].numpy()))
            ref = np.asarray(jp)
            np.testing.assert_allclose(p[h].numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())

    def test_real_roots(self):
        """Known roots, batched; the grid is built in float64 on the port's
        side, so brackets agree with the JAX package except at near-double
        roots (none here). 1e-4 relative on the roots."""
        roots = np.array([[-3.0, -1.2, 0.1, 0.8, 2.5, 7.0], [-20.0, -0.5, 0.3, 1.1, 4.0, 50.0]])
        ps = []
        for r in roots:
            c = np.poly(r)  # descending
            c = np.polymul(c, [1, 0, 1])  # two complex pairs -> degree 10
            c = np.polymul(c, [1, 0.4, 3])
            ps.append(c[::-1])
        p = np.stack(ps).astype(np.float32)
        got, ok = fp._real_roots(T(p))
        for h in range(2):
            jr, jok = j_fp._real_roots(J(p[h]))
            assert np.array_equal(ok[h].numpy(), np.asarray(jok))
            k = int(ok[h].sum())
            assert k == 6
            np.testing.assert_allclose(got[h, :k].numpy(), np.asarray(jr)[:k], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got[h, :k].numpy(), roots[h], rtol=1e-3, atol=1e-4)

    def test_candidates_from_the_same_basis(self):
        """From the SAME nullspace basis (the JAX side's eigh), the roots and
        their masks agree (85 % of the roots z within 3e-2 relative + 5e-3:
        roots of a degree-10 polynomial whose coefficients went through an
        f32 elimination), and every port candidate
        satisfies the epipolar constraint on its 5 points (Sampson residual:
        median < 1e-8, max < 1e-4 unit-plane^2 in f32)."""
        tv = make_two_view(6, n=40)
        x1 = ess.normalize_points(T(tv["uv1"]), T(K))
        x2 = ess.normalize_points(T(tv["uv2"]), T(K))
        idx = torch.arange(40).reshape(8, 5)
        Ebs = []
        for h in range(8):
            a, b = J(x1[idx[h]].numpy()), J(x2[idx[h]].numpy())
            ones = jnp.ones((5, 1), jnp.float32)
            A = jnp.einsum("ni,nj->nij", jnp.concatenate([b, ones], 1), jnp.concatenate([a, ones], 1)).reshape(5, 9)
            _, vecs = jnp.linalg.eigh(A.T @ A)
            Ebs.append(np.asarray(vecs[:, :4].T.reshape(4, 3, 3), np.float32))
        Eb = np.stack(Ebs)
        Es, ok, z = fp.candidates_from_basis(T(Eb))
        res, agree, z_close = [], 0, []
        for h in range(8):
            M = j_fp._gauss_jordan10(j_fp._constraint_rows(J(Eb[h])))
            p, _ = j_fp._poly_from_rows(M)
            jz, jok = j_fp._real_roots(p)
            if np.array_equal(ok[h].numpy(), np.asarray(jok)):
                agree += 1
                k = int(ok[h].sum())
                dz = np.abs(z[h, :k].numpy() - np.asarray(jz)[:k])
                z_close += list(dz <= 5e-3 + 3e-2 * np.abs(np.asarray(jz)[:k]))
            for i in range(10):
                if ok[h, i]:
                    res.append(float(ess.sampson_error(Es[h, i], x1[idx[h]], x2[idx[h]]).max()))
        # a near-double root may flip a bracket between the two frameworks
        assert agree >= 7
        # ill-conditioned roots (near-double) move by more: 85 % of them
        assert len(z_close) >= 16 and np.mean(z_close) >= 0.85
        assert len(res) >= 16
        assert np.median(res) < 1e-8 and max(res) < 1e-4

    def test_candidates_contain_the_true_essential(self):
        """With its own eigh basis each framework finds the true E among its
        candidates for most samples (within 5e-2 up to sign/scale: minimal
        f32 solves of f32 pixel data), the port about as often as the JAX
        package; the candidate sets themselves depend on the basis."""
        tv = make_two_view(6, n=40)
        x1 = ess.normalize_points(T(tv["uv1"]), T(K))
        x2 = ess.normalize_points(T(tv["uv2"]), T(K))
        E_gt = np.asarray(j_geo.hat(J(tv["t"]))) @ tv["R"]
        idx = torch.arange(40).reshape(8, 5)
        Es, ok = fp.five_point_candidates(x1[idx], x2[idx])
        found = j_found = 0
        for h in range(8):
            jEs, jok = j_fp.five_point_candidates(J(x1[idx[h]].numpy()), J(x2[idx[h]].numpy()))
            found += any(ok[h, i] and e_dist(Es[h, i].numpy(), E_gt) < 5e-2 for i in range(10))
            j_found += any(bool(jok[i]) and e_dist(jEs[i], E_gt) < 5e-2 for i in range(10))
        assert found >= 5 and found >= j_found - 2

    @pytest.mark.parametrize("noise,n_out", [(0.0, 0), (0.3, 40)])
    def test_ransac_with_injected_samples(self, noise, n_out):
        """Same hypotheses on both sides: inlier masks equal on >= 99 %,
        E up to sign/scale, and the recovered pose within 1e-3 rad / 1e-3."""
        tv = make_two_view(7, n=150, n_outliers=n_out, noise=noise)
        valid = np.ones(150, bool)
        valid[:7] = False
        key = jax.random.PRNGKey(5)
        H = 32
        samples = np.asarray(j_ransac.sample_minimal_sets(key, J(valid), H, 5))
        jE, jinl = j_fp.find_essential_5pt_ransac(
            J(tv["uv1"]), J(tv["uv2"]), J(valid), J(K), key, n_hypos=H, thresh_px=1.0
        )
        E, inl = fp.find_essential_5pt_ransac(
            T(tv["uv1"]), T(tv["uv2"]), T(valid), T(K), None, n_hypos=H, thresh_px=1.0,
            samples=T(samples),
        )
        assert (inl.numpy() == np.asarray(jinl)).mean() >= 0.99
        assert int(inl.sum()) >= 100
        assert e_dist(E.numpy(), jE) < 2e-3
        jR, jt, _, _ = j_ess.recover_pose(jE, J(tv["uv1"]), J(tv["uv2"]), jinl, J(K))
        R, t, _, _ = ess.recover_pose(E, T(tv["uv1"]), T(tv["uv2"]), inl, T(K))
        assert rot_angle(R.numpy(), jR) < 1e-3
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-3)

    def test_budget(self):
        assert fp.ransac_budget(256) == j_fp.ransac_budget(256) == 64
        assert fp.ransac_budget(8) == j_fp.ransac_budget(8) == 16

    def test_generator_path_recovers_pose(self):
        tv = make_two_view(8, n=120)
        gen = torch.Generator().manual_seed(0)
        E, inl = fp.find_essential_5pt_ransac(
            T(tv["uv1"]), T(tv["uv2"]), torch.ones(120, dtype=torch.bool), T(K), gen, n_hypos=32
        )
        R, t, _, _ = ess.recover_pose(E, T(tv["uv1"]), T(tv["uv2"]), inl, T(K))
        assert int(inl.sum()) >= 110
        assert rot_angle(R.numpy(), tv["R"]) < 2e-3
        assert abs(float(np.dot(t.numpy(), tv["t"]))) > 0.9999


class TestPnP:
    def test_pieces(self):
        rng = np.random.default_rng(9)
        M = rng.normal(size=(6, 3, 3)).astype(np.float32)
        M = np.asarray(j_geo.rodrigues(J(rng.normal(size=(6, 3)).astype(np.float32) * 0.3))) + 0.05 * M
        got = pnp._polar_so3(T(M.astype(np.float32)))
        for h in range(6):
            np.testing.assert_allclose(got[h].numpy(), np.asarray(j_pnp._polar_so3(J(M[h].astype(np.float32)))), atol=1e-5)
        A = rng.normal(size=(4, 12, 12)).astype(np.float32)
        A = A @ A.transpose(0, 2, 1)
        v = pnp._smallest_eigvec12(T(A))
        for h in range(4):
            jv = np.asarray(j_pnp._smallest_eigvec12(J(A[h])))
            assert min(np.abs(v[h].numpy() - jv).max(), np.abs(v[h].numpy() + jv).max()) < 5e-3

    def test_dlt_pose_batched(self):
        tv = make_two_view(10, n=48)
        xn = ess.normalize_points(T(tv["uv2"]), T(K))
        idx = torch.arange(48).reshape(8, 6)
        R, t = pnp._dlt_pose(T(tv["X1"])[idx], xn[idx], torch.ones(8, 6))
        agree = 0
        for h in range(8):
            jR, jt = j_pnp._dlt_pose(J(tv["X1"][idx[h]]), J(xn[idx[h]].numpy()), jnp.ones(6, jnp.float32))
            # hypothesis-grade: the null vector of an f32 12x12 Gram matrix
            # by ridged inverse iteration amplifies rounding differences,
            # and a near-degenerate 6-point set gives garbage on both sides
            agree += rot_angle(R[h].numpy(), jR) < 2e-2 and np.abs(t[h].numpy() - np.asarray(jt)).max() < 3e-2
        assert agree >= 6

    def test_gauss_newton_refine(self):
        tv = make_two_view(11, n=100, noise=0.3)
        aa0 = np.array([0.0, 0.0, 0.0], np.float32)
        t0 = np.array([0.0, 0.0, -0.5], np.float32)
        w = (np.random.default_rng(11).random(100) > 0.2).astype(np.float32)
        jaa, jt = j_pnp.gauss_newton_refine(J(aa0), J(t0), J(tv["X1"]), J(tv["uv2"]), J(w), J(K))
        aa, t = pnp.gauss_newton_refine(T(aa0), T(t0), T(tv["X1"]), T(tv["uv2"]), T(w), T(K))
        np.testing.assert_allclose(aa.numpy(), np.asarray(jaa), atol=2e-4)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-3)

    @pytest.mark.parametrize("noise,n_out", [(0.05, 0), (0.5, 50)])
    def test_ransac_with_injected_samples(self, noise, n_out):
        """Same 6-point sets on both sides: inlier masks equal on >= 99 %;
        both poses near the truth and near each other (rotation 5e-3 rad, t
        2e-2: the JAX package's float32 polish jitters by a few 1e-3 rad from
        one iteration to the next on this data — measured — and the 6-point
        hypotheses are only hypothesis-grade, so the two sides can crown
        different winners and polish on different subsets); and the port's
        pose explains the common inliers at least as well as the JAX one
        (RMS reprojection error). The tight parity of the polish itself is
        test_gauss_newton_refine."""
        tv = make_two_view(12, n=200, n_outliers=n_out, noise=noise)
        valid = np.ones(200, bool)
        valid[190:] = False
        key = jax.random.PRNGKey(2)
        H = 64
        samples = np.asarray(j_ransac.sample_minimal_sets(key, J(valid), H, 6))
        Rg = np.eye(3, dtype=np.float32)
        tg = np.zeros(3, np.float32)
        jR, jt, jinl = j_pnp.solve_pnp_ransac(
            J(tv["X1"]), J(tv["uv2"]), J(valid), J(K), key, J(Rg), J(tg),
            n_hypos=H, thresh_px=3.0,
        )
        R, t, inl = pnp.solve_pnp_ransac(
            T(tv["X1"]), T(tv["uv2"]), T(valid), T(K), None, T(Rg), T(tg),
            n_hypos=H, thresh_px=3.0, samples=T(samples),
        )
        assert (inl.numpy() == np.asarray(jinl)).mean() >= 0.99
        assert int(inl.sum()) >= 130
        assert rot_angle(R.numpy(), jR) < 5e-3
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=2e-2)
        assert rot_angle(R.numpy(), tv["R"]) < 5e-3
        np.testing.assert_allclose(t.numpy(), tv["t"], atol=2e-2)
        common = inl.numpy() & np.asarray(jinl)

        def rms(Rx, tx):
            Xc = tv["X1"].astype(np.float64) @ np.asarray(Rx, np.float64).T + np.asarray(tx, np.float64)
            uv = Xc[:, :2] / Xc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
            return np.sqrt(((uv - tv["uv2"]) ** 2).sum(1)[common].mean())

        assert rms(R.numpy(), t.numpy()) <= 1.05 * rms(jR, jt) + 0.01

    def test_ransac_exact_data(self):
        """Noise-free data: both frameworks recover the true pose (5e-3)."""
        tv = make_two_view(12, n=200)
        valid = np.ones(200, bool)
        key = jax.random.PRNGKey(2)
        samples = np.asarray(j_ransac.sample_minimal_sets(key, J(valid), 64, 6))
        Rg, tg = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        jR, jt, jinl = j_pnp.solve_pnp_ransac(
            J(tv["X1"]), J(tv["uv2"]), J(valid), J(K), key, J(Rg), J(tg), n_hypos=64, thresh_px=3.0
        )
        R, t, inl = pnp.solve_pnp_ransac(
            T(tv["X1"]), T(tv["uv2"]), T(valid), T(K), None, T(Rg), T(tg),
            n_hypos=64, thresh_px=3.0, samples=T(samples),
        )
        assert int(inl.sum()) == int(jinl.sum()) == 200
        for Rx, tx in ((R.numpy(), t.numpy()), (np.asarray(jR), np.asarray(jt))):
            assert rot_angle(Rx, tv["R"]) < 5e-3
            np.testing.assert_allclose(tx, tv["t"], atol=5e-3)
