"""The steady-state step of the port (``fused.frame_step`` / ``chunk_step``
with ``steady=True``) and the public functions the port had left out
(``MapState.update_points``, ``essential.triangulate_points``,
``lucas_kanade.bilinear_sample``, ``steps.lk_module``).

On a dense map a steady chunk equals the full chunk bit for bit, RANSAC draws
included (with the LK matcher, with continuous triangulation and with the
kNN matcher); a steady frame equals ``pmv_tpu``'s steady ``frame_step`` with
the same RANSAC samples to the bars of a PnP frame in test_torch_pipeline.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.core import geometry as j_geo
from pmv_tpu.core.state import FeatureTable as JFeatureTable
from pmv_tpu.core.state import MapState as JMapState
from pmv_tpu.frontend import lucas_kanade as j_lk
from pmv_tpu.pipeline import fused as j_fused
from pmv_tpu.pipeline import steps as j_steps
from pmv_tpu.solvers import essential as j_essential
from pmv_tpu.solvers import ransac as j_ransac
from pmv_tpu_torch import convert
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend import corners
from pmv_tpu_torch.frontend import lucas_kanade as lk
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.io import synthetic
from pmv_tpu_torch.pipeline import fused, steps
from pmv_tpu_torch.solvers import essential

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

H, W, N, M = 96, 160, 128, 512
CFG = dict(
    lk_levels=2, lk_window=15, lk_iters=6, tile_h=H, tile_w=W,
    n_per_tile=64, tracked_tol=48, reseed_tol=70, e_hypos=64, pnp_hypos=64,
    pnp_thresh=3.0, bundle_size=3, ba_iters=3, traj_cap=32,
)
# test_torch_knn.py's run with the default extractor (kNN tracks fewer
# features at this size: the map is dense at a lower tolerance). On the
# density-200 corridor its PnP frames kill most landmarks, and no three
# frames in a row are PnP frames; on the density-100 one they are.
KNN = dict(matcher="knn", n_per_tile=128, knn_cand_per_tile=200, reseed_tol=60, tracked_tol=12)
FRAMES = 24
STEADY = 3  # frames of the chunk run both ways


def T(a):
    return torch.from_numpy(np.array(a))


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


def clone(state):
    """A deep copy of a state (histories are written in place)."""
    return convert.state_from_reference(convert.state_to_numpy(state), "cpu")


def assert_equal_states(a, b):
    da, db = convert.state_to_numpy(a), convert.state_to_numpy(b)
    assert da.keys() == db.keys()
    for k in da:
        assert da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k]), k


def make_corridor(density: float):
    seq = synthetic.make_sequence(n_frames=FRAMES, shape=(H, W), density=density, seed=3)
    imgs = torch.from_numpy(seq["images"].astype(np.uint8))
    gts = np.linalg.norm(np.diff(seq["gt_t"], axis=0), axis=1).astype(np.float32).tolist()
    return dict(imgs=imgs, gts=gts, K=T(np.asarray(seq["K"], np.float32)))


@pytest.fixture(scope="module")
def corridor():
    return make_corridor(200)


def dense_state(corridor, cfg, gen):
    """Frames through the full step until the map is dense and the next
    STEADY frames stay PnP frames in the full step; returns (state at that
    frame, frame index, generator state there)."""
    img0 = corridor["imgs"][0].float()
    xy, sc, va = corners.grid_extract(img0, cfg.n_per_tile, tile_h=H, tile_w=W)
    txy, tsc, tva = corners.select_top(xy, sc, va, N)
    table = FeatureTable(xy=txy, valid=tva, landmark=torch.full((N,), -1, dtype=torch.int32), score=tsc)
    levels = 0 if cfg.matcher == "knn" else cfg.lk_levels
    state = fused.init_state(build_pyramid(img0, levels), table, MapState.empty(M), cfg)
    for i in range(1, FRAMES - STEADY):
        if state.table.count_3d(state.map.alive) >= cfg.tracked_tol:
            trial = clone(state)
            g = torch.Generator().set_state(gen.get_state())
            _, stats = fused.chunk_step(trial, corridor["imgs"][i: i + STEADY],
                                        corridor["gts"][i - 1: i - 1 + STEADY], g, corridor["K"], cfg)
            if all(s["used_pnp"] for s in stats):
                return state, i, gen.get_state()
        state, _ = fused.chunk_step(state, corridor["imgs"][i: i + 1], corridor["gts"][i - 1: i],
                                    gen, corridor["K"], cfg)
    raise AssertionError("the map never stayed dense for a chunk")


class TestSteadyEqualsFull:
    @pytest.mark.parametrize("extra,density", [({}, 200), ({"cont_tri": True}, 200), (KNN, 100)],
                             ids=["lk", "cont_tri", "knn"])
    def test_chunk_bit_for_bit(self, extra, density):
        """From one dense state and one generator state, a chunk through the
        full step and through the steady step: every tensor of the two
        states, every ``used_pnp`` (true) and the generators equal bit for
        bit; the steady step's ``n3d`` and ``used_pnp`` are device tensors."""
        cfg = fused.StepConfig(**{**CFG, **extra})
        corridor = make_corridor(density)
        gen = torch.Generator().manual_seed(0)
        state, i, gstate = dense_state(corridor, cfg, gen)
        imgs, gts = corridor["imgs"][i: i + STEADY], corridor["gts"][i - 1: i - 1 + STEADY]
        g_full = torch.Generator().set_state(gstate)
        g_steady = torch.Generator().set_state(gstate)
        full, st_full = fused.chunk_step(clone(state), imgs, gts, g_full, corridor["K"], cfg)
        steady, st_steady = fused.chunk_step(clone(state), imgs, gts, g_steady, corridor["K"], cfg,
                                             steady=True)
        assert all(s["used_pnp"] is True for s in st_full)
        assert all(torch.is_tensor(s["used_pnp"]) and bool(s["used_pnp"]) for s in st_steady)
        assert [int(s["n3d"]) for s in st_steady] == [s["n3d"] for s in st_full]
        assert [s["tracked"] for s in st_steady] == [s["tracked"] for s in st_full]
        assert_equal_states(steady, full)
        assert torch.equal(g_full.get_state(), g_steady.get_state())
        assert steady.k == state.k + STEADY


def to_jax(state):
    """The port's state as a JAX StepState (blocks feature-major, as the
    JAX package's tap tracker keeps them)."""
    d = convert.state_to_numpy(state)
    blocks = tuple((jnp.asarray(d[f"blocks.{l}.region"]), jnp.asarray(d[f"blocks.{l}.r0"]),
                    jnp.asarray(d[f"blocks.{l}.c0"])) for l in range(len(state.blocks)))
    return j_fused.StepState(
        blocks=blocks,
        table=JFeatureTable(*(jnp.asarray(d[f"table.{f}"]) for f in ("xy", "valid", "landmark", "score"))),
        map=JMapState(*(jnp.asarray(d[f"map.{f}"]) for f in ("xyz", "alive", "head"))),
        k=jnp.int32(d["k"]),
        **{f: jnp.asarray(d[f]) for f in convert.STATE_FIELDS},
    )


def test_steady_frame_matches_the_jax_package(corridor):
    """A steady frame on a dense map against ``pmv_tpu``'s steady
    ``frame_step`` with the same 6-point sets: the bars of a PnP frame in
    test_torch_pipeline.py (table 5e-3 px on slots valid on both sides,
    status equal on >= 99 %, pose 5e-3 rad / 5e-3 relative t: the JAX
    package's float32 PnP polish jitters by a few 1e-3 rad), landmark
    bookkeeping, and the history rows the steady step writes."""
    cfg = fused.StepConfig(**CFG)
    gen = torch.Generator().manual_seed(0)
    state, i, _ = dense_state(corridor, cfg, gen)
    img, gt = corridor["imgs"][i].float(), corridor["gts"][i - 1]
    js = to_jax(state)
    key = jax.random.PRNGKey(i)
    ref, ref_src, ref_stats = j_fused.frame_step(
        js, jnp.asarray(img.numpy()), jnp.float32(gt), key, jnp.asarray(corridor["K"].numpy()),
        j_fused.StepConfig(lk_impl="tap", **CFG), steady=True)
    assert bool(ref_stats["used_pnp"])
    key_pose, _ = jax.random.split(key)
    lm = np.asarray(js.table.landmark)
    alive = np.asarray(js.map.alive)[np.clip(lm, 0, None)] & (lm >= 0)
    mask = np.asarray(js.table.valid) & np.asarray(ref.table.valid) & alive
    samples = np.asarray(j_ransac.sample_minimal_sets(key_pose, jnp.asarray(mask), cfg.pnp_hypos, 6))

    k0 = state.k
    row_k = state.tbl_lm_hist[k0].clone()
    new, src, stats = fused.frame_step(state, img, gt, None, corridor["K"], cfg, steady=True,
                                       samples=T(samples))
    assert bool(stats["used_pnp"]) and int(stats["n3d"]) == int(ref_stats["n3d"])
    assert stats["tracked"] == int(ref_stats["tracked"])
    assert bool(stats["accepted"]) == bool(ref_stats["accepted"])
    v, rv = new.table.valid.numpy(), np.asarray(ref.table.valid)
    assert (v == rv).mean() >= 0.99
    both = v & rv
    np.testing.assert_allclose(new.table.xy.numpy()[both], np.asarray(ref.table.xy)[both], atol=5e-3)
    assert rot_angle(new.R.numpy(), ref.R) < 5e-3
    scale = max(1.0, float(np.linalg.norm(np.asarray(ref.t))))
    assert np.linalg.norm(new.t.numpy() - np.asarray(ref.t)) < 5e-3 * scale
    n_alive, r_alive = int(new.map.alive.sum()), int(np.asarray(ref.map.alive).sum())
    assert abs(n_alive - r_alive) <= max(2, 0.03 * r_alive)
    # the source table is the state's, unchanged; row k is left as it was,
    # row k+1 holds the new table
    assert src is state.table
    assert np.array_equal(np.asarray(ref_src.landmark), np.asarray(js.table.landmark))
    assert torch.equal(new.tbl_lm_hist[k0], row_k)
    assert torch.equal(new.tbl_valid_hist[k0 + 1], new.table.valid)
    np.testing.assert_allclose(new.R_hist[k0 + 1].numpy(), new.R.numpy())


class TestPublicFunctions:
    def test_update_points(self):
        """``MapState.update_points`` against the JAX package's: masked
        write-back, slots -1 ignored (tests/test_state.py's case, then a
        larger random one)."""
        m = MapState.empty(4)
        m, slots = m.insert(torch.zeros((2, 3)), torch.tensor([True, True]))
        m = m.update_points(slots, torch.tensor([[1.0, 2, 3], [4, 5, 6]]), torch.tensor([True, False]))
        assert m.xyz.tolist() == [[1, 2, 3], [0, 0, 0], [0, 0, 0], [0, 0, 0]]

        rng = np.random.default_rng(0)
        cap, n = 64, 40
        xyz = rng.normal(size=(cap, 3)).astype(np.float32)
        alive = rng.random(cap) > 0.3
        slots = rng.permutation(cap)[:n].astype(np.int32)
        slots[::7] = -1
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        mask = rng.random(n) > 0.4
        want = JMapState(jnp.asarray(xyz), jnp.asarray(alive), jnp.int32(5)).update_points(
            jnp.asarray(slots), jnp.asarray(pts), jnp.asarray(mask))
        got = MapState(T(xyz), T(alive), torch.tensor(5, dtype=torch.int32)).update_points(
            T(slots), T(pts), T(mask))
        assert np.array_equal(got.xyz.numpy(), np.asarray(want.xyz))
        assert np.array_equal(got.alive.numpy(), alive) and int(got.head) == 5

    def test_triangulate_points_f64(self):
        """The eigh DLT against the JAX package's in float64 to 1e-10, and
        against the true points of a noiseless two-view scene."""
        rng = np.random.default_rng(0)
        X1 = np.stack([rng.uniform(-10, 10, 200), rng.uniform(-5, 5, 200), rng.uniform(8, 40, 200)], -1)
        R = np.asarray(j_geo.rodrigues(jnp.asarray([0.01, -0.04, 0.005])))
        t = np.array([0.3, -0.05, -0.9]) / np.linalg.norm([0.3, -0.05, -0.9])
        X2 = X1 @ R.T + t
        x1 = X1[:, :2] / X1[:, 2:3] + rng.normal(0, 1e-3, (200, 2))
        x2 = X2[:, :2] / X2[:, 2:3] + rng.normal(0, 1e-3, (200, 2))
        want = np.asarray(j_essential.triangulate_points(*map(jnp.asarray, (R, t, x1, x2))))
        got = essential.triangulate_points(T(R), T(t), T(x1), T(x2))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
        clean = essential.triangulate_points(T(R), T(t), T(X1[:, :2] / X1[:, 2:3]), T(X2[:, :2] / X2[:, 2:3]))
        np.testing.assert_allclose(clean.numpy(), X1, atol=1e-8)

    def test_bilinear_sample(self):
        """Pointwise bilinear sampling against the JAX package's, inside and
        outside the image (clipped), in float32: 1e-4 on a 0-255 image."""
        rng = np.random.default_rng(1)
        img = (rng.random((H, W)) * 255).astype(np.float32)
        y = rng.uniform(-5, H + 5, 500).astype(np.float32)
        x = rng.uniform(-5, W + 5, 500).astype(np.float32)
        want = np.asarray(j_lk.bilinear_sample(jnp.asarray(img), jnp.asarray(y), jnp.asarray(x)))
        got = lk.bilinear_sample(T(img), T(y), T(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        # on integer positions it reads the pixel
        assert torch.equal(lk.bilinear_sample(T(img), torch.tensor([3.0]), torch.tensor([7.0])),
                           T(img[3:4, 7]))

    @pytest.mark.parametrize("impl", ["tap", "pallas", "auto", "anything"])
    def test_lk_module(self, impl):
        """Every name the JAX package accepts resolves to the port's one LK
        route, which has the functions the fused step takes from the JAX
        package's module."""
        mod = steps.lk_module(impl, 21, 10)
        assert mod is lk and steps.lk_module(impl) is lk
        ref = j_steps.lk_module(impl, 21, 10)
        assert callable(ref.capture_blocks) and callable(mod.capture_blocks)
