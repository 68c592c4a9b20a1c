"""ba/schur_lm of the port against the JAX package: the assembled Schur
blocks, one damped solve, and the whole LM loop, on a synthetic window."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.ba import schur_lm as j_ba
from pmv_tpu.core import geometry as j_geo
from pmv_tpu_torch.ba import schur_lm as ba

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def make_window(seed=0, P=4, N=48, L=60, noise=0.3, pose_noise=0.01, lm_noise=0.05):
    """A (P, N)-grid window in the pipeline's conventions: z-flipped world,
    pose blocks [angle_axis(R^T), -t], each slot observing one landmark."""
    rng = np.random.default_rng(seed)
    lm = np.stack([rng.uniform(-8, 8, L), rng.uniform(-4, 4, L), rng.uniform(-40, -10, L)], -1)
    tr = np.zeros((P, 6))
    tr[:, :3] = rng.normal(size=(P, 3)) * 0.01
    tr[:, 5] = np.arange(P) * 1.0  # -t: the camera advances along -z
    local = np.stack([rng.permutation(L)[:N] for _ in range(P)]).astype(np.int32)
    uv = np.asarray(j_geo.ba_project(J(tr)[:, None, :], J(lm)[J(local)], J(K.astype(np.float64))))
    uv = uv + rng.normal(size=uv.shape) * noise
    mask = rng.random((P, N)) > 0.15
    pose_free = np.arange(P) >= 1
    tr0 = tr + rng.normal(size=tr.shape) * pose_noise * pose_free[:, None]
    lm0 = lm + rng.normal(size=lm.shape) * lm_noise
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(tr0), f32(lm0), f32(uv), local, mask, pose_free


def onehot(local, mask, L):
    return ((local[..., None] == np.arange(L)) & mask[..., None]).astype(np.float32)


class TestAssemble:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_blocks_match_assemble_blocks_grid(self, seed):
        """U, V, Wc, b_pose, b_lm against ``assemble_blocks_grid`` (one-hot
        products there, ``index_add_`` here; forward-mode Jacobians on both
        sides): 1e-4 relative to each block's scale."""
        tr, lm, uv, local, mask, pf = make_window(seed)
        L = lm.shape[0]
        ref = j_ba.assemble_blocks_grid(
            J(tr), J(lm), J(uv), J(local), J(mask), J(onehot(local, mask, L)), J(pf), J(K), 1.0
        )
        got = ba.assemble_blocks_grid(T(tr), T(lm), T(uv), T(local), T(mask), T(pf), T(K), 1.0)
        for name, g, r in zip(("U", "V", "Wc", "b_pose", "b_lm"), got[:5], ref[:5]):
            r = np.asarray(r)
            np.testing.assert_allclose(
                g.numpy(), r, rtol=1e-4, atol=1e-5 * np.abs(r).max(), err_msg=name
            )
        assert np.array_equal(got[5].numpy(), np.asarray(ref[5]))

    def test_masked_nan_observations_are_inert(self):
        tr, lm, uv, local, mask, pf = make_window(2)
        lm[local[0, 0]] = [0.0, 0.0, -tr[0, 5]]  # projects with z = 0 from pose 0
        mask[0, 0] = False
        out = ba.assemble_blocks_grid(T(tr), T(lm), T(uv), T(local), T(mask), T(pf), T(K), 1.0)
        assert all(bool(torch.isfinite(o).all()) for o in out[:5])

    def test_schur_solve(self):
        """The same blocks through the same elimination. With one pose pinned
        a monocular window keeps its scale gauge, so the reduced system is
        near-singular and a float32 solve, in either package, is off its own
        float64 result by a few percent of the step. The algorithm is
        therefore held in float64 (rtol 1e-8), and the float32 solves are each
        held to the float64 step within 5 % of its size."""
        tr, lm, uv, local, mask, pf = make_window(3)
        L = lm.shape[0]
        blocks = j_ba.assemble_blocks_grid(
            J(tr), J(lm), J(uv), J(local), J(mask), J(onehot(local, mask, L)), J(pf), J(K), 1.0
        )
        blocks = [np.asarray(b) for b in blocks]

        def both(dtype):
            cast = [b if b.dtype == bool else b.astype(dtype) for b in blocks]
            jdp, jdx = j_ba.schur_solve(*map(J, cast), J(pf), jnp.asarray(1e-4, dtype))
            dp, dx = ba.schur_solve(*map(T, cast), T(pf), T(np.asarray(1e-4, dtype)))
            return np.asarray(jdp), np.asarray(jdx), dp.numpy(), dx.numpy()

        jdp, jdx, dp, dx = both(np.float64)
        assert jdp.dtype == dp.dtype == np.float64
        np.testing.assert_allclose(dp, jdp, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(dx, jdx, rtol=1e-8, atol=1e-8)
        jdp32, _, dp32, _ = both(np.float32)
        assert dp32.dtype == np.float32
        for got in (jdp32, dp32):
            assert np.abs(got - jdp).max() < 0.05 * np.abs(jdp).max()

    def test_inv3x3_and_huber(self):
        rng = np.random.default_rng(4)
        V = rng.normal(size=(9, 3, 3)).astype(np.float32)
        V = V @ V.transpose(0, 2, 1)
        V[0] = 0.0  # singular block -> zero inverse
        np.testing.assert_allclose(ba._inv3x3(T(V)).numpy(), np.asarray(j_ba._inv3x3(J(V))), rtol=1e-4, atol=1e-5)
        r2 = np.array([0.0, 0.3, 1.0, 2.0, 50.0], np.float32)
        np.testing.assert_allclose(ba._huber_cost(T(r2), 1.0).numpy(), np.asarray(j_ba._huber_cost(J(r2), 1.0)), rtol=1e-6)


class TestSolve:
    @pytest.mark.parametrize("seed,gate", [(0, 0.0), (1, 0.0), (2, 6.0)])
    def test_ba_solve_grid(self, seed, gate):
        """Five LM iterations from the same start. In float64 the two loops
        agree to rounding (poses, landmarks and the accept/reject history at
        rtol 1e-6). In float32 each loop's steps drift along the window's
        scale gauge (see ``test_schur_solve``), so there the bar is what both
        packages reach: the same initial cost (1e-4), the same final cost
        (1e-3), poses within 5e-2 of the float64 result."""
        tr, lm, uv, local, mask, pf = make_window(seed)

        def both(dtype):
            c = lambda a: a.astype(dtype)  # noqa: E731
            j = j_ba.ba_solve_grid(
                J(c(tr)), J(c(lm)), J(c(uv)), J(local), J(mask), J(pf), J(c(K)),
                iters=5, obs_gate_px=gate,
            )
            t = ba.ba_solve_grid(
                T(c(tr)), T(c(lm)), T(c(uv)), T(local), T(mask), T(pf), T(c(K)),
                iters=5, obs_gate_px=gate,
            )
            return j, t

        (jtr, jlm, jst), (ttr, tlm, tst) = both(np.float64)
        assert ttr.dtype == torch.float64 and np.asarray(jtr).dtype == np.float64
        np.testing.assert_allclose(tst["history"].numpy(), np.asarray(jst["history"]), rtol=1e-6)
        np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), rtol=1e-6, atol=1e-7)
        ref_tr = np.asarray(jtr)

        (jtr, jlm, jst), (ttr, tlm, tst) = both(np.float32)
        assert ttr.dtype == torch.float32
        np.testing.assert_allclose(float(tst["cost0"]), float(jst["cost0"]), rtol=1e-4)
        np.testing.assert_allclose(float(tst["cost"]), float(jst["cost"]), rtol=1e-3)
        for got in (ttr.numpy(), np.asarray(jtr)):
            assert np.abs(got - ref_tr).max() < 5e-2
        assert float(tst["cost"]) < 0.5 * float(tst["cost0"])
        # pinned pose untouched
        assert np.array_equal(ttr.numpy()[0], tr[0])

    def test_zero_iterations_and_empty_window(self):
        tr, lm, uv, local, mask, pf = make_window(5)
        ttr, tlm, st = ba.ba_solve_grid(T(tr), T(lm), T(uv), T(local), T(mask), T(pf), T(K), iters=0)
        assert np.array_equal(ttr.numpy(), tr) and st["history"].shape == (0,)
        ttr, tlm, st = ba.ba_solve_grid(
            T(tr), T(lm), T(uv), T(local), torch.zeros_like(T(mask)), T(pf), T(K), iters=2
        )
        assert np.array_equal(ttr.numpy(), tr) and np.array_equal(tlm.numpy(), lm)
