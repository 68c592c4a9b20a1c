"""Continuous triangulation and the landmark-snapshot history of the port
against the JAX package: ``camera_depth``, ``triangulate_midpoint`` and
``continuous_triangulate`` on the same seeded arrays, then a PnP
``frame_step`` with ``cont_tri`` and a ``chunk_step`` over two BA-cadence
groups with ``map_hist_rows > 0``, each from one ``StepState`` carried
across with ``pmv_tpu_torch.convert`` and with the RANSAC draws of the JAX
keys injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.core import geometry as j_geo
from pmv_tpu.core.state import FeatureTable as JFeatureTable
from pmv_tpu.core.state import MapState as JMapState
from pmv_tpu.frontend import corners as j_corners
from pmv_tpu.frontend.image import build_pyramid as j_build_pyramid
from pmv_tpu.io import synthetic as j_synthetic
from pmv_tpu.pipeline import fused as j_fused
from pmv_tpu.pipeline import steps as j_steps
from pmv_tpu.solvers import ransac as j_ransac
from pmv_tpu.solvers.five_point import ransac_budget
from pmv_tpu_torch import convert
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.pipeline import fused, steps

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

H, W, N, M = 96, 160, 128, 512
FRAMES = 6
# bundle_size 3: BA cadence 2, so BA runs after frames 3 and 5 and the
# snapshot rows k // 2 are 0, 1, 1, 2, 2, 3 over frames 1-6
CFG = dict(
    lk_levels=2, lk_window=15, lk_iters=6, tile_h=H, tile_w=W,
    n_per_tile=64, tracked_tol=48, reseed_tol=70, e_hypos=64, pnp_hypos=64,
    pnp_thresh=3.0, bundle_size=3, ba_iters=3, traj_cap=16,
    cont_tri=True, map_hist_rows=16 // 2 + 2,
)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


# --------------------------------------------------------------------------
# the geometry and the step on seeded arrays
# --------------------------------------------------------------------------


def two_views(seed: int, dtype):
    """Two camera poses of the pipeline's (z-flipped) world, a slot table of
    N features observed in both, and a map. Slots: noise-free observations
    (accepted), gross mis-tracks (rejected by reprojection), points beyond
    the depth band, slots already bound to a live landmark, slots bound to a
    dead one, invalid slots — none of them near a gate's threshold."""
    rng = np.random.default_rng(seed)
    aa = np.array([0.01, 0.05, -0.02])
    R1 = np.asarray(j_geo.rodrigues(J(aa)), np.float64)
    t1 = np.array([0.3, -0.1, -2.0])
    R2 = np.asarray(j_geo.rodrigues(J(aa + [0.0, 0.02, 0.01])), np.float64)
    t2 = t1 + R1 @ np.array([1.5, 0.05, -0.5])
    K = np.array([[96.0, 0, 80], [0, 96.0, 48], [0, 0, 1]])
    n = 60
    depth = rng.uniform(4.0, 20.0, n)
    depth[40:45] = rng.uniform(150.0, 300.0, 5)  # beyond max_depth
    uv = rng.uniform([10, 10], [150, 86], (n, 2))
    # camera-1 standard coords -> pipeline camera (z flipped) -> world
    X_std = np.c_[(uv - K[:2, 2]) / [K[0, 0], K[1, 1]] * depth[:, None], depth]
    X_world = (X_std * [1, 1, -1]) @ R1.T + t1
    uv1 = np.array(j_geo.project_points(J(X_world), J(R1), J(t1), J(K)))
    uv2 = np.array(j_geo.project_points(J(X_world), J(R2), J(t2), J(K)))
    uv2[30:36] += rng.choice([-1, 1], (6, 2)) * rng.uniform(8.0, 15.0, (6, 2))
    valid = np.ones(n, bool)
    valid[50:54] = False
    lm = np.full(n, -1, np.int32)
    lm[20:26] = np.arange(6)  # bound to live landmarks: skipped
    lm[26:29] = 100 + np.arange(3)  # bound to dead ones: triangulated again
    m = 128
    xyz = rng.normal(size=(m, 3)) * 5
    alive = np.zeros(m, bool)
    alive[:6] = True
    f = lambda a: np.asarray(a, dtype)  # noqa: E731
    return dict(
        R1=f(R1), t1=f(t1), R2=f(R2), t2=f(t2), K=f(K),
        src=(f(uv1), valid, lm, f(np.ones(n))), nxt=(f(uv2), valid.copy(), lm.copy(), f(np.ones(n))),
        xyz=f(xyz), alive=alive, head=np.int32(110),
    )


def both_steps(d, enable: bool):
    jsrc, jnxt = JFeatureTable(*map(J, d["src"])), JFeatureTable(*map(J, d["nxt"]))
    jmap = JMapState(J(d["xyz"]), J(d["alive"]), jnp.int32(d["head"]))
    src, nxt = FeatureTable(*map(T, d["src"])), FeatureTable(*map(T, d["nxt"]))
    mp = MapState(T(d["xyz"]), T(d["alive"]), torch.tensor(d["head"], dtype=torch.int32))
    pose = [d[k] for k in ("R1", "t1", "R2", "t2", "K")]
    ref = j_steps.continuous_triangulate(jsrc, jnxt, jmap, *map(J, pose), enable=jnp.bool_(enable))
    got = steps.continuous_triangulate(src, nxt, mp, *map(T, pose), enable=torch.tensor(enable))
    return got, ref


class TestGeometry:
    @pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-4)])
    def test_camera_depth_and_midpoint(self, dtype, rtol):
        """float64: 1e-10 relative; float32: 1e-4 relative (the same formulas,
        matrix products rounded in another order)."""
        d = two_views(0, dtype)
        X = d["xyz"]
        np.testing.assert_allclose(
            geo.camera_depth(T(X), T(d["R1"]), T(d["t1"])).numpy(),
            np.asarray(j_geo.camera_depth(J(X), J(d["R1"]), J(d["t1"]))), rtol=rtol, atol=rtol)
        # rays of points 4-40 m deep seen across a 1.6 m baseline, observed
        # with 1e-3 noise on the unit plane, and one pair of parallel rays
        rng = np.random.default_rng(1)
        R_rel = (d["R2"].T @ d["R1"]).astype(dtype)
        t_rel = np.asarray([0.5, -0.1, -1.5], dtype)
        X = np.c_[rng.uniform(-0.6, 0.6, (40, 2)), np.ones(40)] * rng.uniform(4.0, 40.0, (40, 1))
        x1 = (X[:, :2] / X[:, 2:]).astype(dtype)
        X2 = np.r_[X[:39], [[0.0, 0.0, 1.0]]] @ R_rel.T.astype(np.float64) + np.r_[[t_rel] * 39, [[0, 0, 0]]]
        x2 = (X2[:, :2] / X2[:, 2:] + np.r_[rng.normal(size=(39, 2)) * 1e-3, [[0, 0]]]).astype(dtype)
        x1[39] = 0.0  # with x2[39]: parallel rays, the sin2 floor
        gX, gs = geo.triangulate_midpoint(T(R_rel), T(t_rel), T(x1), T(x2))
        rX, rs = j_geo.triangulate_midpoint(J(R_rel), J(t_rel), J(x1), J(x2))
        tX, ts = (np.asarray(a) for a in j_geo.triangulate_midpoint(
            *(J(np.asarray(a, np.float64)) for a in (R_rel, t_rel, x1, x2))))
        assert gX.dtype == T(x1).dtype
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=rtol, atol=rtol)
        assert np.asarray(rs)[39] < 1e-12
        gated = ts > 1e-5  # the pipeline's parallax gate
        assert gated.sum() >= 30
        if dtype == np.float64:
            np.testing.assert_allclose(gX.numpy()[gated], np.asarray(rX)[gated], rtol=rtol, atol=rtol)
            return
        # float32: the midpoint of rays a few 1e-3 rad apart loses digits in
        # 1 - B^2 in both packages (errors of 1e-3 relative from the float64
        # solve at sin2 ~ 1e-4, the same in both); where sin2 > 2e-3 they
        # agree to 1e-4, and on every gated ray the port is at most twice as
        # far from the float64 solve as the JAX package
        sharp = ts > 2e-3
        assert sharp.sum() >= 5
        np.testing.assert_allclose(gX.numpy()[sharp], np.asarray(rX)[sharp], rtol=rtol, atol=rtol)
        scale = np.abs(tX).max(axis=1)
        e_port = np.abs(gX.numpy() - tX).max(axis=1) / scale
        e_ref = np.abs(np.asarray(rX) - tX).max(axis=1) / scale
        assert np.all(e_port[gated] <= 2 * e_ref[gated] + 1e-5)


class TestContinuousTriangulate:
    @pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-4)])
    def test_against_jax(self, dtype, rtol):
        """Bindings, ``valid`` and ``alive`` exact; positions 1e-10 relative
        in float64, 1e-4 in float32."""
        d = two_views(2, dtype)
        (gs, gn, gm), (rs, rn, rm) = both_steps(d, True)
        for g, r in ((gs, rs), (gn, rn)):
            assert np.array_equal(g.landmark.numpy(), np.asarray(r.landmark))
            assert np.array_equal(g.valid.numpy(), np.asarray(r.valid))
        assert np.array_equal(gm.alive.numpy(), np.asarray(rm.alive))
        assert int(gm.head) == int(rm.head)
        np.testing.assert_allclose(gm.xyz.numpy(), np.asarray(rm.xyz), rtol=rtol, atol=rtol)
        # what the gates did: 60 slots, 6 bound live, 4 invalid, 5 too deep,
        # 6 mis-tracked -> 39 inserted, the dead-bound ones among them
        new = gn.landmark.numpy() != d["nxt"][2]
        assert new.sum() == 39 and new[26:29].all()
        assert not new[20:26].any() and not new[30:36].any() and not new[40:45].any()
        assert np.array_equal(gs.landmark.numpy()[new], gn.landmark.numpy()[new])

    def test_disabled_is_a_no_op(self):
        d = two_views(3, np.float32)
        (gs, gn, gm), (rs, rn, rm) = both_steps(d, False)
        assert np.array_equal(gn.landmark.numpy(), d["nxt"][2])
        assert np.array_equal(gs.landmark.numpy(), np.asarray(rs.landmark))
        assert torch.equal(gm.xyz, T(d["xyz"])) and int(gm.head) == int(rm.head) == d["head"]


# --------------------------------------------------------------------------
# frame_step with cont_tri, chunk_step with map_hist
# --------------------------------------------------------------------------


def flatten(s) -> dict:
    """A JAX StepState as the flat numpy dict ``convert`` takes."""
    d = {}
    for lvl, (region, r0, c0) in enumerate(s.blocks):
        d[f"blocks.{lvl}.region"] = np.asarray(region)
        d[f"blocks.{lvl}.r0"] = np.asarray(r0)
        d[f"blocks.{lvl}.c0"] = np.asarray(c0)
    for f in ("xy", "valid", "landmark", "score"):
        d[f"table.{f}"] = np.asarray(getattr(s.table, f))
    for f in ("xyz", "alive", "head"):
        d[f"map.{f}"] = np.asarray(getattr(s.map, f))
    for f in ("R", "t", "R_s", "t_s", "scale", "k", "R_hist", "t_hist",
              "tbl_xy_hist", "tbl_valid_hist", "tbl_lm_hist", "map_hist", "ba_overflow"):
        d[f] = np.asarray(getattr(s, f))
    return d


def _f64_jax(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _cast_torch(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple):
        items = [_cast_torch(v, dtype) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def ba_in_f64_jax(ba_step):
    """``ba_step`` solved in float64, state handed back in float32: the
    monocular window's scale gauge makes the float32 solve wander (ROADMAP
    Queue 3), in float64 the two packages agree to rounding."""
    def wrapped(state, K, cfg):
        out = ba_step(_f64_jax(state), K.astype(jnp.float64), cfg)
        return jax.tree_util.tree_map(
            lambda a, b: a.astype(b.dtype), out, state)
    return wrapped


def ba_in_f64_torch(ba_step):
    def wrapped(state, K, cfg):
        out = ba_step(_cast_torch(state, torch.float64), K.double(), cfg)
        return _cast_torch(out, torch.float32)._replace(k=state.k)
    return wrapped


@pytest.fixture(scope="module")
def jax_run():
    """Six frames of a small corridor, each through the JAX package's
    ``chunk_step`` as a chunk of one (``cont_tri`` on, ``map_hist`` kept,
    BA in float64), every state recorded."""
    jcfg = j_fused.StepConfig(lk_impl="tap", **CFG)
    seq = j_synthetic.make_sequence(n_frames=FRAMES + 1, shape=(H, W), density=200, seed=3)
    img0 = J(seq["images"][0])
    xy, sc, va = j_corners.grid_extract(img0, 64, tile_h=H, tile_w=W)
    txy, tsc, tva = j_corners.select_top(xy, sc, va, N)
    table = JFeatureTable(xy=txy, valid=tva, landmark=jnp.full((N,), -1, jnp.int32), score=tsc)
    s = j_fused.init_state(
        pyr=tuple(j_build_pyramid(img0, jcfg.lk_levels)), table=table,
        map_state=JMapState.empty(M), cfg=jcfg,
    )
    K = J(np.asarray(seq["K"], np.float32))
    keys = jax.random.split(jax.random.PRNGKey(0), FRAMES)
    imgs = seq["images"][1:].astype(np.uint8)
    gts = np.linalg.norm(np.diff(seq["gt_t"], axis=0), axis=1).astype(np.float32)
    orig = j_fused.ba_step
    j_fused.ba_step = ba_in_f64_jax(orig)
    try:
        recs = []
        for i in range(FRAMES):
            before = s
            s, stats = j_fused.chunk_step(s, J(imgs[i : i + 1]), J(gts[i : i + 1]), keys[i : i + 1], K, jcfg)
            recs.append(dict(before=before, after=s, img=imgs[i], gt=gts[i], key=keys[i],
                             used_pnp=bool(stats["used_pnp"][0]), n3d=int(stats["n3d"][0]),
                             tracked=int(stats["tracked"][0])))
    finally:
        j_fused.ba_step = orig
    return dict(K=np.asarray(K), recs=recs)


def _samples_for(rec):
    """The minimal sets the JAX frame_step drew: same key derivation
    (fused.py: ``key_pose, _ = split(key)``), same validity mask."""
    key_pose, _ = jax.random.split(rec["key"])
    src, nxt, mp = rec["before"].table, rec["after"].table, rec["before"].map
    if rec["used_pnp"]:
        lm = np.asarray(src.landmark)
        alive = np.asarray(mp.alive)[np.clip(lm, 0, None)] & (lm >= 0)
        mask = np.asarray(src.valid) & np.asarray(nxt.valid) & alive
        return np.asarray(j_ransac.sample_minimal_sets(key_pose, J(mask), CFG["pnp_hypos"], 6))
    corr = np.asarray(src.valid) & np.asarray(nxt.valid)
    return np.asarray(
        j_ransac.sample_minimal_sets(key_pose, J(corr), ransac_budget(CFG["e_hypos"]), 5))


def _inserted(rec) -> int:
    """Landmarks the frame's continuous triangulation bound (PnP frames)."""
    return int(((np.asarray(rec["after"].table.landmark) != np.asarray(rec["before"].table.landmark))
                & (np.asarray(rec["after"].table.landmark) >= 0)).sum())


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


def _hold_tables(new_table, ref_table, bind_share=0.97):
    """Status equal on >= 99 % of slots, positions 5e-3 px on slots valid on
    both sides, bindings equal on >= ``bind_share`` of those."""
    v, rv = new_table.valid.numpy(), np.asarray(ref_table.valid)
    assert (v == rv).mean() >= 0.99
    both = v & rv
    np.testing.assert_allclose(new_table.xy.numpy()[both], np.asarray(ref_table.xy)[both], atol=5e-3)
    same = new_table.landmark.numpy()[both] == np.asarray(ref_table.landmark)[both]
    assert same.mean() >= bind_share
    return both


class TestPipeline:
    def test_run_has_what_the_checks_need(self, jax_run):
        recs = jax_run["recs"]
        assert not recs[0]["used_pnp"]
        pnp = [r for r in recs if r["used_pnp"]]
        assert pnp and max(_inserted(r) for r in pnp) >= 10

    def test_pnp_frame_step_with_cont_tri(self, jax_run):
        """The PnP frame whose continuous triangulation bound the most
        landmarks, through both packages' frame_step from the same state
        with the same 6-point sets: tables as in tests/test_torch_pipeline.py,
        the new bindings in both tables and in history row k (the source
        table back-bound). The pose is held to 5e-3 rad / 5e-3 relative t
        (the JAX package's float32 PnP polish jitters by a few 1e-3 rad,
        ROADMAP Queue 3), so the landmarks triangulated from it are held to
        1e-2 relative (measured: 2.7e-3 at most, 2.4e-4 median)."""
        recs = [r for r in jax_run["recs"] if r["used_pnp"]]
        rec = max(recs, key=_inserted)
        jcfg = j_fused.StepConfig(lk_impl="tap", **CFG)
        K = jax_run["K"]
        before = rec["before"]
        ref, ref_src, ref_stats = j_fused.frame_step(
            before, J(rec["img"].astype(np.float32)), J(rec["gt"]), rec["key"], J(K), jcfg)
        state = convert.state_from_reference(flatten(before), "cpu")
        new, src_table, stats = fused.frame_step(
            state, T(rec["img"].astype(np.float32)), float(rec["gt"]), None, T(K),
            fused.StepConfig(**CFG), samples=T(_samples_for(rec)))
        assert stats["used_pnp"] and bool(stats["accepted"]) == bool(ref_stats["accepted"])
        both = _hold_tables(new.table, ref.table)
        _hold_tables(src_table, ref_src)
        k = state.k
        assert torch.equal(new.tbl_lm_hist[k], src_table.landmark)
        assert torch.equal(new.tbl_lm_hist[k + 1], new.table.landmark)
        lm, rlm = new.table.landmark.numpy(), np.asarray(ref.table.landmark)
        born = both & (lm != state.table.landmark.numpy()) & (lm == rlm) & (lm >= 0)
        assert born.sum() >= 0.9 * _inserted(rec)
        assert np.array_equal(src_table.landmark.numpy()[born], lm[born])
        assert rot_angle(new.R.numpy(), ref.R) < 5e-3
        assert np.linalg.norm(new.t.numpy() - np.asarray(ref.t)) < 5e-3 * max(
            1.0, float(np.linalg.norm(np.asarray(ref.t))))
        X, rX = new.map.xyz.numpy()[lm[born]], np.asarray(ref.map.xyz)[rlm[born]]
        np.testing.assert_allclose(X, rX, rtol=1e-2, atol=1e-2)
        assert int(new.map.head) == int(ref.map.head)

    def test_chunk_step_keeps_the_snapshot_rows(self, jax_run, monkeypatch):
        """The six frames as one chunk through the port's chunk_step (the
        JAX draws injected frame by frame, BA in float64 on both sides)
        against the JAX package's chunk_step: the same rows of map_hist
        written (k // cadence, after the frame's BA), each holding the map
        of its group's last frame; on the landmarks alive in both, the rows
        agree to 1e-2 relative: they hold landmarks triangulated from PnP
        poses that are held to 5e-3 (see the test above)."""
        recs, K = jax_run["recs"], jax_run["K"]
        samples = [T(_samples_for(r)) for r in recs]
        step = fused.frame_step

        def injected(state, img, gt, gen, K, cfg, steady=False):
            return step(state, img, gt, gen, K, cfg, steady=steady, samples=samples[state.k])

        ba_f64, after_ba = ba_in_f64_torch(fused.ba_step), {}

        def recorded_ba(state, K, cfg):
            out = ba_f64(state, K, cfg)
            after_ba[state.k] = out.map.xyz.clone()
            return out

        monkeypatch.setattr(fused, "frame_step", injected)
        monkeypatch.setattr(fused, "ba_step", recorded_ba)
        cfg = fused.StepConfig(**CFG)
        state = convert.state_from_reference(flatten(recs[0]["before"]), "cpu")
        assert state.map_hist.shape == (CFG["map_hist_rows"], M, 3)
        imgs = T(np.stack([r["img"] for r in recs]))
        out, stats = fused.chunk_step(state, imgs, [float(r["gt"]) for r in recs], None, T(K), cfg)
        ref = recs[-1]["after"]
        assert out.k == int(ref.k) == FRAMES
        assert [s["used_pnp"] for s in stats] == [r["used_pnp"] for r in recs]
        hist, rhist = out.map_hist.numpy(), np.asarray(ref.map_hist)
        written = [r for r in range(hist.shape[0]) if np.any(rhist[r] != 0)]
        assert written == [0, 1, 2, 3]
        assert [r for r in range(hist.shape[0]) if np.any(hist[r] != 0)] == written
        # each row holds its group's last frame's map, BA included
        cad = fused.ba_cadence(cfg)
        for k in range(1, FRAMES + 1):
            row = k // cad
            last = min((row + 1) * cad - 1, FRAMES)
            if k == last:
                np.testing.assert_array_equal(rhist[row], np.asarray(recs[k - 1]["after"].map.xyz))
        np.testing.assert_array_equal(hist[FRAMES // cad], out.map.xyz.numpy())
        # the BA frames (3 and 5) end their groups: their rows hold the map
        # the BA wrote, and the BA moved it
        assert sorted(after_ba) == [3, 5]
        for k, xyz in after_ba.items():
            assert torch.equal(out.map_hist[k // cad], xyz)
            assert np.any(rhist[k // cad] != np.asarray(recs[k - 1]["before"].map.xyz))
        _hold_tables(out.table, ref.table)
        alive = out.map.alive.numpy() & np.asarray(ref.map.alive)
        assert alive.sum() >= 0.95 * np.asarray(ref.map.alive).sum()
        for row in written:
            np.testing.assert_allclose(hist[row][alive], rhist[row][alive], rtol=1e-2, atol=1e-2)
