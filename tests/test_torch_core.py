"""core/ and frontend/corners of the port against the JAX package: the same
numpy-seeded float32 arrays through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.core import geometry as j_geo
from pmv_tpu.core import linalg as j_linalg
from pmv_tpu.core import state as j_state
from pmv_tpu.frontend import corners as j_corners
from pmv_tpu.io import synthetic as j_synthetic
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core import linalg
from pmv_tpu_torch.core import state
from pmv_tpu_torch.frontend import corners


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=rtol, atol=atol)


@pytest.fixture
def data():
    rng = np.random.default_rng(7)
    aa = (rng.normal(size=(9, 3)) * 0.4).astype(np.float32)
    aa[0] = 0.0  # the series branch
    aa[1] = [1e-7, -2e-7, 1e-7]
    R = np.asarray(j_geo.rodrigues(J(aa)), np.float32)
    t = rng.normal(size=(9, 3)).astype(np.float32)
    pts = (rng.normal(size=(9, 20, 3)) * 3 + [0, 0, -12]).astype(np.float32)
    K = np.array([[700, 0, 320], [0, 710, 240], [0, 0, 1]], np.float32)
    return aa, R, t, pts, K


class TestGeometry:
    """Elementwise float32 formulas in the same order: 1e-5 relative, with
    1e-6 absolute for values near zero."""

    def test_rodrigues_and_inverse(self, data):
        aa, R, *_ = data
        close(geo.rodrigues(T(aa)), j_geo.rodrigues(J(aa)))
        close(geo.rodrigues_inv(T(R)), j_geo.rodrigues_inv(J(R)), atol=1e-6)
        # near-pi branch
        Rpi = np.asarray(j_geo.rodrigues(J(np.array([[3.14159, 0.0, 0.0], [0, 2.2, -2.24]], np.float32))))
        close(geo.rodrigues_inv(T(Rpi)), j_geo.rodrigues_inv(J(Rpi)), atol=1e-4)

    def test_transform_project(self, data):
        aa, R, t, pts, K = data
        close(geo.transform(T(pts), T(R), T(t)), j_geo.transform(J(pts), J(R), J(t)), atol=1e-5)
        close(geo.transform_inv(T(pts), T(R), T(t)), j_geo.transform_inv(J(pts), J(R), J(t)), atol=1e-5)
        close(
            geo.project_points(T(pts), T(R), T(t), T(K)),
            j_geo.project_points(J(pts), J(R), J(t), J(K)), rtol=1e-4, atol=1e-2,
        )

    def test_ba_params_roundtrip_and_project(self, data):
        aa, R, t, pts, K = data
        tr = geo.pose_to_ba_params(T(R), T(t))
        close(tr, j_geo.pose_to_ba_params(J(R), J(t)), atol=1e-6)
        R2, t2 = geo.ba_params_to_pose(tr)
        jR2, jt2 = j_geo.ba_params_to_pose(J(tr.numpy()))
        close(R2, jR2)
        close(t2, jt2)
        close(
            geo.ba_project(tr[:, None, :], T(pts), T(K)),
            j_geo.ba_project(J(tr.numpy())[:, None, :], J(pts), J(K)), rtol=1e-4, atol=1e-2,
        )

    def test_compose_huber_yaw(self, data):
        aa, R, t, *_ = data
        Rn, tn = geo.compose_delta(T(R[2]), T(t[2]), T(R[3]), T(t[3]))
        jRn, jtn = j_geo.compose_delta(J(R[2]), J(t[2]), J(R[3]), J(t[3]))
        close(Rn, jRn)
        close(tn, jtn)
        r2 = np.array([0.0, 0.5, 1.0, 1.5, 9.0, 1e-30], np.float32)
        close(geo.huber_weight(T(r2), 1.0), j_geo.huber_weight(J(r2), 1.0))
        close(geo.calc_y_rotation(T(R)), j_geo.calc_y_rotation(J(R)), atol=1e-6)
        close(geo.calc_y_rotation(T(R), flip=True), j_geo.calc_y_rotation(J(R), flip=True), atol=1e-6)


    @pytest.mark.parametrize("scale", [0.0, 1e-7, 0.004, 0.09, 0.11, 0.4, 2.5])
    def test_rotation_jacobian_matches_jax_jacfwd(self, scale):
        """The closed-form d(R(aa) p)/d(aa) against ``jax.jacfwd`` of the JAX
        package's ``angle_axis_rotate`` in float64 (1e-6 of |p|: at theta ~ 0
        jacfwd sees only the first-order branch; on either side of the
        series switch at theta = 0.1 the closed form is exact to 1e-9), and
        in float32 to 2e-5 of |p|."""
        import jax

        rng = np.random.default_rng(11)
        aa = rng.normal(size=(5, 3)) * scale
        p = rng.normal(size=(5, 8, 3)) * 5
        jac = jax.vmap(jax.vmap(jax.jacfwd(j_geo.angle_axis_rotate, argnums=0), in_axes=(None, 0)))
        ref = np.asarray(jac(J(aa), J(p)))
        assert ref.dtype == np.float64
        q, dq, R = geo.angle_axis_rotate_jac(T(aa), T(p))
        np.testing.assert_allclose(dq.numpy(), ref, atol=1e-9 if scale > 1e-3 else 5e-6)
        np.testing.assert_allclose(
            q.numpy(), np.asarray(j_geo.angle_axis_rotate(J(aa)[:, None, :], J(p))), atol=1e-12
        )
        np.testing.assert_allclose(R.numpy(), np.asarray(j_geo.rodrigues(J(aa))), atol=1e-12)
        q32, dq32, _ = geo.angle_axis_rotate_jac(T(aa.astype(np.float32)), T(p.astype(np.float32)))
        assert dq32.dtype == torch.float32
        np.testing.assert_allclose(dq32.numpy(), ref, atol=1e-4)


class TestLinalg:
    def test_gj_solve_inverse_det(self):
        """Pivot-free Gauss-Jordan, the same elimination order: 1e-4 on
        well-conditioned damped SPD systems."""
        rng = np.random.default_rng(8)
        A = rng.normal(size=(5, 12, 12)).astype(np.float32)
        A = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(12, dtype=np.float32)
        B = rng.normal(size=(5, 12, 3)).astype(np.float32)
        close(linalg.gj_solve(T(A), T(B)), j_linalg.gj_solve(J(A), J(B)), rtol=1e-4, atol=1e-5)
        close(linalg.gj_inverse(T(A)), j_linalg.gj_inverse(J(A)), rtol=1e-4, atol=1e-5)
        close(linalg.gj_solve(T(A[0]), T(B)), j_linalg.gj_solve(J(A[0]), J(B)), rtol=1e-4, atol=1e-5)
        M = rng.normal(size=(7, 3, 3)).astype(np.float32)
        close(linalg.det3(T(M)), j_linalg.det3(J(M)), atol=1e-5)


class TestState:
    def _tables(self):
        rng = np.random.default_rng(9)
        N, M = 24, 16
        lm = rng.integers(-1, M, N).astype(np.int32)
        valid = rng.random(N) > 0.3
        alive = rng.random(M) > 0.4
        xy = rng.uniform(0, 100, (N, 2)).astype(np.float32)
        return N, M, xy, valid, lm, alive

    def test_count_3d(self):
        N, M, xy, valid, lm, alive = self._tables()
        jt = j_state.FeatureTable(J(xy), J(valid), J(lm), J(np.zeros(N, np.float32)))
        tt = state.FeatureTable(T(xy), T(valid), T(lm), torch.zeros(N))
        assert int(tt.count_3d(T(alive))) == int(jt.count_3d(J(alive)))
        assert int(tt.num_valid()) == int(jt.num_valid())

    @pytest.mark.parametrize("head", [0, 13])
    def test_insert_kill_ring(self, head):
        """Ring insert with wrap-around (head 13 of 16) and kill: identical
        tables and slots."""
        N, M, _, valid, lm, alive = self._tables()
        rng = np.random.default_rng(10)
        pts = rng.normal(size=(N, 3)).astype(np.float32)
        mask = rng.random(N) > 0.7
        assert 0 < mask.sum() <= M
        xyz = rng.normal(size=(M, 3)).astype(np.float32)
        jm = j_state.MapState(J(xyz), J(alive), jnp.int32(head))
        tm = state.MapState(T(xyz), T(alive), torch.tensor(head, dtype=torch.int32))
        jm2, jslots = jm.insert(J(pts), J(mask))
        tm2, tslots = tm.insert(T(pts), T(mask))
        assert np.array_equal(tslots.numpy(), np.asarray(jslots))
        assert np.array_equal(tm2.xyz.numpy(), np.asarray(jm2.xyz))
        assert np.array_equal(tm2.alive.numpy(), np.asarray(jm2.alive))
        assert int(tm2.head) == int(jm2.head)
        jm3 = jm2.kill(J(lm), J(valid))
        tm3 = tm2.kill(T(lm), T(valid))
        assert np.array_equal(tm3.alive.numpy(), np.asarray(jm3.alive))
        # the input map is untouched (functional update)
        assert np.array_equal(tm.alive.numpy(), alive)

    def test_insert_more_than_capacity_later_write_wins(self):
        M = 4
        pts = np.arange(18, dtype=np.float32).reshape(6, 3)
        tm = state.MapState.empty(M)
        tm2, slots = tm.insert(T(pts), torch.ones(6, dtype=torch.bool))
        assert slots.tolist() == [0, 1, 2, 3, 0, 1]
        assert np.array_equal(tm2.xyz.numpy(), pts[[4, 5, 2, 3]])
        assert int(tm2.head) == 2

    def test_has_neighbor(self):
        rng = np.random.default_rng(11)
        new = rng.uniform(0, 50, (30, 2)).astype(np.float32)
        ex = rng.uniform(0, 50, (40, 2)).astype(np.float32)
        ev = rng.random(40) > 0.3
        got = state.has_neighbor(T(new), T(ex), T(ev), dist=5)
        ref = j_state.has_neighbor(J(new), J(ex), J(ev), dist=5)
        assert np.array_equal(got.numpy(), np.asarray(ref))


class TestCorners:
    def _img(self, seed=0, shape=(128, 192), density=60):
        seq = j_synthetic.make_sequence(n_frames=1, shape=shape, density=density, seed=seed)
        return np.asarray(seq["images"][0], np.float32)

    @pytest.mark.parametrize("tile", [(64, 64), (255, 255), (50, 70)])
    def test_grid_extract_same_set_and_order(self, tile):
        """Same valid mask, and the same xy in the same order for every real
        corner (score > 1 on a 0-255 image; the flat background's responses
        are ~1e-3 plateaus whose order is decided by the last float bit);
        scores 1e-5 relative (the response is the only float arithmetic)."""
        img = self._img()
        jxy, jsc, jv = j_corners.grid_extract(J(img), n_per_tile=12, tile_h=tile[0], tile_w=tile[1])
        xy, sc, v = corners.grid_extract(T(img), 12, tile_h=tile[0], tile_w=tile[1])
        jv = np.asarray(jv)
        assert np.array_equal(v.numpy(), jv)
        np.testing.assert_allclose(sc.numpy()[jv], np.asarray(jsc)[jv], rtol=1e-5, atol=1e-3)
        strong = jv & (np.asarray(jsc) > 1.0)
        assert strong.sum() >= 10
        assert np.array_equal(xy.numpy()[strong], np.asarray(jxy)[strong])

    def test_ties_go_to_the_lowest_index(self):
        """Equal responses (a blob pattern repeated exactly) rank by index,
        like lax.top_k."""
        tile = self._img(seed=1, shape=(48, 48), density=8)
        img = np.tile(tile, (1, 3))  # three identical copies side by side
        jxy, _, jv = j_corners.grid_extract(J(img), n_per_tile=20, tile_h=48, tile_w=144)
        xy, _, v = corners.grid_extract(T(img), 20, tile_h=48, tile_w=144)
        jv = np.asarray(jv)
        assert np.array_equal(v.numpy(), jv)
        assert np.array_equal(xy.numpy()[jv], np.asarray(jxy)[jv])

    @pytest.mark.parametrize("capacity", [16, 200])
    def test_select_top(self, capacity):
        img = self._img(seed=2)
        xy, sc, v = corners.grid_extract(T(img), 12, tile_h=64, tile_w=64)
        jt = j_corners.select_top(J(xy.numpy()), J(sc.numpy()), J(v.numpy()), capacity)
        tt = corners.select_top(xy, sc, v, capacity)
        tv = tt[2].numpy()
        assert np.array_equal(tv, np.asarray(jt[2]))
        assert np.array_equal(tt[0].numpy()[tv], np.asarray(jt[0])[tv])
        assert np.array_equal(tt[1].numpy()[tv], np.asarray(jt[1])[tv])
        assert tt[0].shape == (capacity, 2)

    def test_unported_response_raises(self):
        with pytest.raises(NotImplementedError):
            corners.grid_extract(torch.zeros(32, 32), 4, response="fast")
