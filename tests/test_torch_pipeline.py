"""pipeline/ of the port against the JAX package: the small steps, then the
slice as a whole — ``frame_step`` on a bootstrap frame, a PnP frame and a
reseed frame, and ``ba_step``, each from one ``StepState`` carried across
with ``pmv_tpu_torch.convert`` and with the RANSAC draws injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.core.state import FeatureTable as JFeatureTable
from pmv_tpu.core.state import MapState as JMapState
from pmv_tpu.frontend import corners as j_corners
from pmv_tpu.frontend.image import build_pyramid as j_build_pyramid
from pmv_tpu.io import synthetic as j_synthetic
from pmv_tpu.pipeline import fused as j_fused
from pmv_tpu.pipeline import heuristics as j_heur
from pmv_tpu.pipeline import steps as j_steps
from pmv_tpu.solvers import ransac as j_ransac
from pmv_tpu.solvers.five_point import ransac_budget
from pmv_tpu_torch import convert
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.pipeline import fused, heuristics, steps

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

H, W, N, M = 96, 160, 128, 512
CFG = dict(
    lk_levels=2, lk_window=15, lk_iters=6, tile_h=H, tile_w=W,
    n_per_tile=64, tracked_tol=48, reseed_tol=70, e_hypos=64, pnp_hypos=64,
    pnp_thresh=3.0, bundle_size=3, ba_iters=3, traj_cap=16,
)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


def flatten(s) -> dict:
    """A JAX StepState as the flat numpy dict ``convert`` takes."""
    d = {}
    for l, (region, r0, c0) in enumerate(s.blocks):
        d[f"blocks.{l}.region"] = np.asarray(region)
        d[f"blocks.{l}.r0"] = np.asarray(r0)
        d[f"blocks.{l}.c0"] = np.asarray(c0)
    for f in ("xy", "valid", "landmark", "score"):
        d[f"table.{f}"] = np.asarray(getattr(s.table, f))
    for f in ("xyz", "alive", "head"):
        d[f"map.{f}"] = np.asarray(getattr(s.map, f))
    for f in ("R", "t", "R_s", "t_s", "scale", "k", "R_hist", "t_hist",
              "tbl_xy_hist", "tbl_valid_hist", "tbl_lm_hist", "map_hist", "ba_overflow"):
        d[f] = np.asarray(getattr(s, f))
    return d


def _jax_run():
    """Seven frames of a small corridor through the JAX package's
    frame_step (+ ba_step at its cadence), every step recorded."""
    C = 7
    seq = j_synthetic.make_sequence(n_frames=C + 1, shape=(H, W), density=200, seed=3)
    cfg = j_fused.StepConfig(lk_impl="tap", **CFG)
    img0 = J(seq["images"][0])
    xy, sc, va = j_corners.grid_extract(img0, 64, tile_h=H, tile_w=W)
    txy, tsc, tva = j_corners.select_top(xy, sc, va, N)
    table = JFeatureTable(xy=txy, valid=tva, landmark=jnp.full((N,), -1, jnp.int32), score=tsc)
    s = j_fused.init_state(
        pyr=tuple(j_build_pyramid(img0, cfg.lk_levels)), table=table,
        map_state=JMapState.empty(M), cfg=cfg,
    )
    K = J(np.asarray(seq["K"], np.float32))
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    imgs = seq["images"][1:].astype(np.uint8).astype(np.float32)
    gts = np.linalg.norm(np.diff(seq["gt_t"], axis=0), axis=1).astype(np.float32)
    cadence = max(1, cfg.bundle_size // 3 * 2)
    steps_rec, ba_rec = [], []
    for i in range(C):
        before = s
        s, src_table, stats = j_fused.frame_step(s, J(imgs[i]), J(gts[i]), keys[i], K, cfg)
        steps_rec.append(dict(
            before=before, after=s, src=src_table, img=imgs[i], gt=gts[i], key=keys[i],
            tracked=int(stats["tracked"]), n3d=int(stats["n3d"]),
            used_pnp=bool(stats["used_pnp"]), accepted=bool(stats["accepted"]),
        ))
        j = int(s.k) - 1
        if j > 0 and j % cadence == 0:
            b = s
            s = j_fused.ba_step(s, K, cfg)
            ba_rec.append(dict(before=b, after=s))
    return dict(seq=seq, K=np.asarray(K), steps=steps_rec, ba=ba_rec, first_table=table)


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run()


def _samples_for(rec, cfg):
    """The minimal sets the JAX frame_step drew: same key derivation
    (fused.py: ``key_pose, _ = split(key)``), same validity mask."""
    key_pose, _ = jax.random.split(rec["key"])
    src, nxt, mp = rec["before"].table, rec["after"].table, rec["before"].map
    if rec["used_pnp"]:
        lm = np.asarray(src.landmark)
        alive = np.asarray(mp.alive)[np.clip(lm, 0, None)] & (lm >= 0)
        mask = np.asarray(src.valid) & np.asarray(nxt.valid) & alive
        return np.asarray(j_ransac.sample_minimal_sets(key_pose, J(mask), cfg.pnp_hypos, 6))
    corr = np.asarray(src.valid) & np.asarray(nxt.valid)
    return np.asarray(
        j_ransac.sample_minimal_sets(key_pose, J(corr), ransac_budget(cfg.e_hypos), 5)
    )


def _port_step(rec, K):
    cfg = fused.StepConfig(**CFG)
    state = convert.state_from_reference(flatten(rec["before"]), "cpu")
    samples = _samples_for(rec, cfg)
    return fused.frame_step(
        state, T(rec["img"]), float(rec["gt"]), None, T(K), cfg, samples=T(samples)
    )


def _check_step(rec, K, pose_rot=2e-3, pose_t=2e-3):
    """Table xy 5e-3 px on slots valid on both sides, status equal on >= 99
    %, same landmark bindings on those slots, pose as stated by the caller."""
    new, src_table, stats = _port_step(rec, K)
    ref = rec["after"]
    assert stats["used_pnp"] == rec["used_pnp"]
    assert stats["tracked"] == rec["tracked"] and stats["n3d"] == rec["n3d"]
    assert bool(stats["accepted"]) == rec["accepted"]
    assert new.k == int(ref.k)
    v, rv = new.table.valid.numpy(), np.asarray(ref.table.valid)
    assert (v == rv).mean() >= 0.99
    both = v & rv
    np.testing.assert_allclose(new.table.xy.numpy()[both], np.asarray(ref.table.xy)[both], atol=5e-3)
    assert rot_angle(new.R.numpy(), ref.R) < pose_rot
    scale = max(1.0, float(np.linalg.norm(np.asarray(ref.t))))
    assert np.linalg.norm(new.t.numpy() - np.asarray(ref.t)) < pose_t * scale
    # bookkeeping: history rows k and k+1, map occupancy
    k = new.k
    assert np.array_equal(new.tbl_valid_hist[k].numpy(), v)
    assert np.array_equal(new.tbl_lm_hist[k - 1].numpy(), src_table.landmark.numpy())
    np.testing.assert_allclose(new.R_hist[k].numpy(), new.R.numpy())
    n_alive, r_alive = int(new.map.alive.sum()), int(np.asarray(ref.map.alive).sum())
    assert abs(n_alive - r_alive) <= max(2, 0.03 * r_alive)
    bound = (new.table.landmark.numpy() >= 0) & both
    r_bound = (np.asarray(ref.table.landmark) >= 0) & both
    assert (bound == r_bound).mean() >= 0.97
    return new


class TestSmallSteps:
    def test_motion_gate(self):
        rng = np.random.default_rng(0)
        from pmv_tpu.core import geometry as j_geo

        for i in range(12):
            aa = (rng.normal(size=3) * [0.02, 0.3, 0.02]).astype(np.float32)
            Rd = np.asarray(j_geo.rodrigues(J(aa)), np.float32)
            td = (rng.normal(size=3) * [0.3, 0.3, 1.0]).astype(np.float32)
            Rp = np.asarray(j_geo.rodrigues(J((rng.normal(size=3) * 0.2).astype(np.float32))), np.float32)
            tp = rng.normal(size=3).astype(np.float32)
            Rs, ts = np.eye(3, dtype=np.float32), np.array([0, 0, -1], np.float32)
            ref = j_heur.motion_gate(J(Rd), J(td), J(Rp), J(tp), J(Rs), J(ts), jnp.float32(1.0))
            got = heuristics.motion_gate(T(Rd), T(td), T(Rp), T(tp), T(Rs), T(ts), torch.tensor(1.0))
            assert bool(got[4]) == bool(ref[4])
            for g, r in zip(got[:4], ref[:4]):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)

    def test_reseed_merge(self):
        rng = np.random.default_rng(1)
        n, c = 40, 90
        xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
        valid = rng.random(n) > 0.5
        lm = rng.integers(-1, 50, n).astype(np.int32)
        score = rng.random(n).astype(np.float32)
        cxy = np.round(rng.uniform(0, 200, (c, 2))).astype(np.float32)
        csc = np.round(rng.random(c) * 20).astype(np.float32)  # many equal scores
        cva = rng.random(c) > 0.2
        ref = j_steps.reseed_merge(JFeatureTable(J(xy), J(valid), J(lm), J(score)), J(cxy), J(csc), J(cva), 5)
        got = steps.reseed_merge(FeatureTable(T(xy), T(valid), T(lm), T(score)), T(cxy), T(csc), T(cva), 5)
        for f in ("xy", "valid", "landmark", "score"):
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f))), f
        # nothing to merge: the table comes back as it was
        same = steps.reseed_merge(FeatureTable(T(xy), T(valid), T(lm), T(score)), T(cxy), T(csc), torch.zeros(c, dtype=torch.bool), 5)
        assert np.array_equal(same.xy.numpy(), xy) and np.array_equal(same.valid.numpy(), valid)

    def test_pnp_inputs_register_kill_assemble(self):
        rng = np.random.default_rng(2)
        n, m = 30, 40
        mk = lambda: (  # noqa: E731
            rng.uniform(0, 100, (n, 2)).astype(np.float32), rng.random(n) > 0.3,
            rng.integers(-1, m, n).astype(np.int32), rng.random(n).astype(np.float32),
        )
        a, b = mk(), mk()
        xyz = rng.normal(size=(m, 3)).astype(np.float32) * 5
        alive = rng.random(m) > 0.3
        from pmv_tpu.core import geometry as j_geo

        R = np.asarray(j_geo.rodrigues(J(np.array([0.02, 0.1, -0.03], np.float32))), np.float32)
        t = np.array([0.5, -0.2, 3.0], np.float32)
        jsrc, jnxt = JFeatureTable(*map(J, a)), JFeatureTable(*map(J, b))
        jmap = JMapState(J(xyz), J(alive), jnp.int32(35))
        src, nxt = FeatureTable(*map(T, a)), FeatureTable(*map(T, b))
        mp = MapState(T(xyz), T(alive), torch.tensor(35, dtype=torch.int32))

        ref = j_steps.pnp_inputs(jsrc, jnxt, jmap, J(R), J(t))
        got = steps.pnp_inputs(src, nxt, mp, T(R), T(t))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
        for g, r in zip(got[1:], ref[1:]):
            assert np.array_equal(g.numpy(), np.asarray(r))

        X = (rng.normal(size=(n, 3)) + [0, 0, 6]).astype(np.float32)
        good = rng.random(n) > 0.4
        rs, rn, rm = j_steps.register_triangulated(jsrc, jnxt, jmap, J(X), J(good), jnp.float32(1.3), J(R), J(t))
        gs, gn, gm = steps.register_triangulated(src, nxt, mp, T(X), T(good), torch.tensor(1.3), T(R), T(t))
        assert np.array_equal(gs.landmark.numpy(), np.asarray(rs.landmark))
        assert np.array_equal(gn.landmark.numpy(), np.asarray(rn.landmark))
        assert np.array_equal(gm.alive.numpy(), np.asarray(rm.alive))
        assert int(gm.head) == int(rm.head)
        np.testing.assert_allclose(gm.xyz.numpy(), np.asarray(rm.xyz), rtol=1e-5, atol=1e-5)

        used, inl = rng.random(n) > 0.3, rng.random(n) > 0.5
        rk = j_steps.kill_outlier_landmarks(jmap, J(a[2]), J(used), J(inl))
        gk = steps.kill_outlier_landmarks(mp, T(a[2]), T(used), T(inl))
        assert np.array_equal(gk.alive.numpy(), np.asarray(rk.alive))

        wxy = rng.uniform(0, 100, (3, n, 2)).astype(np.float32)
        wv = rng.random((3, n)) > 0.3
        wl = rng.integers(-1, m, (3, n)).astype(np.int32)
        ref = j_steps.assemble_ba_window(J(wxy), J(wv), J(wl), jmap)
        got = steps.assemble_ba_window(T(wxy), T(wv), T(wl), mp)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r))


class TestFrameStep:
    def test_run_has_every_kind_of_frame(self, jax_run):
        recs = jax_run["steps"]
        assert not recs[0]["used_pnp"]
        assert any(r["used_pnp"] for r in recs)
        assert any(r["tracked"] < CFG["reseed_tol"] for r in recs)
        assert any(r["tracked"] >= CFG["reseed_tol"] for r in recs)
        assert len(jax_run["ba"]) >= 2

    def test_state_round_trip(self, jax_run):
        d = flatten(jax_run["steps"][3]["before"])
        back = convert.state_to_numpy(convert.state_from_reference(d, "cpu"))
        for k, v in d.items():
            assert np.array_equal(back[k], v), k
        # the feature-lanes layout of the Pallas tracker is accepted too
        d2 = dict(d)
        for l in range(CFG["lk_levels"] + 1):
            d2[f"blocks.{l}.region"] = np.transpose(d[f"blocks.{l}.region"], (1, 2, 0))
        s2 = convert.state_from_reference(d2, "cpu")
        assert np.array_equal(s2.blocks[1][0].numpy(), d["blocks.1.region"])

    def test_bootstrap_frame(self, jax_run):
        """Five-point bootstrap + triangulation with the same 5-point sets:
        pose within 2e-3 rad / 2e-3 (unit-baseline scale; eigh/svd factor
        choices and the f32 polish), new landmarks near the JAX ones."""
        rec = jax_run["steps"][0]
        assert not rec["used_pnp"] and rec["n3d"] == 0
        new = _check_step(rec, jax_run["K"])
        ref = rec["after"]
        lm, rlm = new.table.landmark.numpy(), np.asarray(ref.table.landmark)
        both = (lm >= 0) & (rlm >= 0)
        assert both.sum() >= 30
        X, rX = new.map.xyz.numpy()[lm[both]], np.asarray(ref.map.xyz)[rlm[both]]
        rel = np.linalg.norm(X - rX, axis=1) / np.linalg.norm(rX, axis=1)
        assert np.median(rel) < 5e-3

    def test_pnp_frame(self, jax_run):
        """PnP with the same 6-point sets. The pose is held to 5e-3 rad /
        5e-3 relative t, not 1e-3: the JAX package's float32 polish jitters
        by a few 1e-3 rad between iterations (see the solver tests)."""
        recs = [r for r in jax_run["steps"] if r["used_pnp"]]
        assert recs
        for rec in recs[:2]:
            _check_step(rec, jax_run["K"], pose_rot=5e-3, pose_t=5e-3)

    def test_reseed_frame(self, jax_run):
        """A frame whose tracked count fell under reseed_tol: the merged
        table (new corners in the free slots, best first) and the recaptured
        blocks agree."""
        recs = [r for r in jax_run["steps"] if r["tracked"] < CFG["reseed_tol"]]
        assert recs
        rec = recs[-1]
        new, _, stats = _port_step(rec, jax_run["K"])
        assert stats["reseed"]
        ref = rec["after"]
        v, rv = new.table.valid.numpy(), np.asarray(ref.table.valid)
        assert v.sum() > rec["tracked"]  # slots were filled
        assert (v == rv).mean() >= 0.99
        both = v & rv
        np.testing.assert_allclose(new.table.xy.numpy()[both], np.asarray(ref.table.xy)[both], atol=5e-3)
        for (blk, r0, c0), (rblk, rr0, rc0) in zip(new.blocks, ref.blocks):
            same = both & (r0.numpy() == np.asarray(rr0)) & (c0.numpy() == np.asarray(rc0))
            assert same.mean() >= 0.95 * both.mean()
            np.testing.assert_allclose(blk.numpy()[same], np.asarray(rblk)[same], rtol=1e-5, atol=1e-3)

    def test_unported_modes_raise(self, jax_run):
        """No mode of the step is left unported: steady=True runs (held
        against the full step and the JAX package in
        tests/test_torch_steady.py) and reports the branch the full step
        would take as a device bool; cont_tri runs (held against the JAX
        package in tests/test_torch_cont_tri.py)."""
        rec = jax_run["steps"][1]
        state = convert.state_from_reference(flatten(rec["before"]), "cpu")
        K = T(jax_run["K"])
        new, _, stats = fused.frame_step(
            convert.state_from_reference(flatten(rec["before"]), "cpu"), T(rec["img"]), 1.0,
            torch.Generator().manual_seed(0), K, fused.StepConfig(**CFG), steady=True)
        assert new.k == state.k + 1 and torch.is_tensor(stats["used_pnp"])
        assert bool(stats["used_pnp"]) == rec["used_pnp"]
        new, _, _ = fused.frame_step(
            state, T(rec["img"]), 1.0, torch.Generator().manual_seed(0), K,
            fused.StepConfig(**{**CFG, "cont_tri": True}))
        assert new.k == state.k + 1


def _to_f64_jax(state):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, state
    )


def _to_f64_torch(x):
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple):
        items = [_to_f64_torch(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def jax_f32_ba_costs(state, K, jcfg, monkeypatch, n: int = 16) -> list[float]:
    """The JAX package's float32 ``ba_step`` under ``jit`` from ``state``
    and from ``state`` with its map scaled by 1 + e, e = +-1e-6, +-2e-6, ...
    (``n`` of them): the solver's final robust cost of each, read by a
    callback that leaves the computation as it is (the state it returns is
    ``ba_step``'s bit for bit)."""
    costs = []
    solve = j_fused.schur_lm.ba_solve_grid

    def recording(*args, **kw):
        out = solve(*args, **kw)
        jax.debug.callback(lambda c: costs.append(float(c)), out[2]["cost"])
        return out

    monkeypatch.setattr(j_fused.schur_lm, "ba_solve_grid", recording)
    step = jax.jit(lambda s, K: j_fused.ba_step.__wrapped__(s, K, jcfg))
    for j in range(n + 1):
        e = 0.0 if j == 0 else (-1) ** j * ((j + 1) // 2) * 1e-6
        jax.block_until_ready(step(state._replace(map=state.map._replace(xyz=state.map.xyz * (1 + e))), K))
    jax.effects_barrier()
    monkeypatch.setattr(j_fused.schur_lm, "ba_solve_grid", solve)
    assert len(costs) == n + 1
    return costs


class TestBAStep:
    def test_ba_step_on_the_same_state(self, jax_run, monkeypatch):
        """Window poses and landmarks after ba_step from the same state.

        The window's monocular scale gauge makes the reduced system
        near-singular, and the robust cost is flat along it: float32 LM
        steps, in either package, wander along the gauge (the JAX package's
        own float32 result moves by 1e-2 when its input map is scaled by
        1 + 1e-6) while reaching the same cost. The step as a whole — window
        assembly, unique-landmark compaction, solve, scatter back — is
        therefore held in float64, where the two agree to rounding (1e-7).
        In float32 the bar is the cost: the same initial robust cost as the
        float64 solve (1e-4), the cost after the three iterations within 2 %
        of the float64 solve's (they are not converged, and the paths
        differ) or within the range of the JAX package's own float32 step
        where that is wider (:func:`jax_f32_ba_costs`), poses only within
        0.25. The reduced system keeps the pivot row's residual as XLA
        computes it (tests/test_torch_contraction.py), so the float32 loop's
        cost hangs on its inputs' last bits: on the last window the JAX
        package's lands 4.86 to 7.98 for a map scaled by 1 + e, |e| <= 8e-6,
        against the float64 loop's 4.94, and the port's 6.00."""
        K = T(jax_run["K"])
        cfg = fused.StepConfig(**CFG)
        jcfg = j_fused.StepConfig(lk_impl="tap", **CFG)
        solver_stats = []
        solve = fused.schur_lm.ba_solve_grid

        def recording_solve(*args, **kw):
            out = solve(*args, **kw)
            solver_stats.append(out[2])
            return out

        monkeypatch.setattr(fused.schur_lm, "ba_solve_grid", recording_solve)
        for rec in jax_run["ba"][-2:]:
            before = convert.state_from_reference(flatten(rec["before"]), "cpu")
            k = before.k

            ref = j_fused.ba_step(_to_f64_jax(rec["before"]), J(jax_run["K"].astype(np.float64)), jcfg)
            out = fused.ba_step(_to_f64_torch(before), K.double(), cfg)
            assert out.t_hist.dtype == torch.float64 and ref.t_hist.dtype == jnp.float64
            alive = np.asarray(ref.map.alive)
            np.testing.assert_allclose(out.t_hist[: k + 1].numpy(), np.asarray(ref.t_hist)[: k + 1], atol=1e-7)
            np.testing.assert_allclose(out.R_hist[: k + 1].numpy(), np.asarray(ref.R_hist)[: k + 1], atol=1e-7)
            np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-7)
            np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-7)
            np.testing.assert_allclose(out.map.xyz.numpy()[alive], np.asarray(ref.map.xyz)[alive], atol=1e-6)
            assert int(out.ba_overflow) == int(ref.ba_overflow)

            out, ref = fused.ba_step(before, K, cfg), rec["after"]
            assert out.t_hist.dtype == torch.float32
            st64, st32 = solver_stats[-2:]
            np.testing.assert_allclose(float(st32["cost0"]), float(st64["cost0"]), rtol=1e-4)
            jax_costs = jax_f32_ba_costs(rec["before"], J(jax_run["K"]), jcfg, monkeypatch)
            lo = min(jax_costs + [float(st64["cost"]) * (1 - 2e-2)])
            hi = max(jax_costs + [float(st64["cost"]) * (1 + 2e-2)])
            assert lo <= float(st32["cost"]) <= hi, (float(st32["cost"]), lo, hi)
            assert float(st32["cost"]) < float(st32["cost0"])
            np.testing.assert_allclose(out.t_hist[: k + 1].numpy(), np.asarray(ref.t_hist)[: k + 1], atol=0.25)
            np.testing.assert_allclose(out.R_hist[: k + 1].numpy(), np.asarray(ref.R_hist)[: k + 1], atol=5e-2)
            np.testing.assert_allclose(out.R.numpy(), out.R_hist[k].numpy())
            np.testing.assert_allclose(out.t.numpy(), out.t_hist[k].numpy())
            assert int(out.ba_overflow) == int(ref.ba_overflow)
            # it moved something
            assert np.abs(out.map.xyz.numpy() - np.asarray(rec["before"].map.xyz)).max() > 1e-6

    def test_chunk_step_equals_frame_by_frame(self, jax_run):
        """The port's chunk loop is frame_step + ba_step at the cadence of
        the JAX package's chunk_step, bit for bit."""
        seq = jax_run["seq"]
        cfg = fused.StepConfig(**CFG)
        K = T(jax_run["K"])
        imgs_u8 = T(seq["images"][1:6].astype(np.uint8))
        gts = [1.0] * 5

        def fresh():
            return convert.state_from_reference(flatten(jax_run["steps"][0]["before"]), "cpu")

        s = fresh()
        gen = torch.Generator().manual_seed(5)
        for i in range(5):
            s, _, _ = fused.frame_step(s, imgs_u8[i].float(), gts[i], gen, K, cfg)
            j = s.k - 1
            if j > 0 and j % fused.ba_cadence(cfg) == 0:
                s = fused.ba_step(s, K, cfg)
        s2, stats = fused.chunk_step(fresh(), imgs_u8, gts, torch.Generator().manual_seed(5), K, cfg)
        assert len(stats) == 5 and s2.k == s.k == 5
        assert torch.equal(s.t_hist, s2.t_hist) and torch.equal(s.R, s2.R)
        assert torch.equal(s.map.xyz, s2.map.xyz) and torch.equal(s.table.valid, s2.table.valid)
