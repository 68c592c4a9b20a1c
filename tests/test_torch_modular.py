"""The modular loop of the port against the JAX package: the uncached LK
tracker, the per-stage steps it calls, the flat bundle adjustment, and
``OdometryPipeline.run_modular`` end to end (with the LK and the kNN
matcher) on a short corridor.

The RANSAC draws of the two packages differ (``jax.random`` cannot be
reproduced in torch) and the tracker is chaotic, so the end-to-end runs are
held to the same accuracy class, not to each other's poses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu import config as j_config
from pmv_tpu.ba import schur_lm as j_ba
from pmv_tpu.core import geometry as j_geo
from pmv_tpu.core.state import FeatureTable as JFeatureTable
from pmv_tpu.core.state import MapState as JMapState
from pmv_tpu.frontend import corners as j_corners
from pmv_tpu.frontend import lucas_kanade as j_lk
from pmv_tpu.frontend.image import build_pyramid as j_build_pyramid
from pmv_tpu.io import synthetic as j_synthetic
from pmv_tpu.pipeline import steps as j_steps
from pmv_tpu.pipeline.odometry import OdometryPipeline as JOdometryPipeline
from pmv_tpu_torch import config
from pmv_tpu_torch.ba import schur_lm as ba
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend import corners, lk_kernels, min_eig
from pmv_tpu_torch.frontend import lucas_kanade as lk
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.pipeline import steps
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

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


@pytest.fixture(scope="module")
def pair():
    """Two frames of a small corridor, their pyramids on both sides, and
    grid corners of the first (plus slots near the border and off the
    image)."""
    seq = j_synthetic.make_sequence(n_frames=3, shape=(128, 192), density=30, seed=2)
    imgs = [np.asarray(f, np.float32) for f in seq["images"]]
    xy, _, valid = j_corners.grid_extract(J(imgs[0]), 48, tile_h=128, tile_w=192)
    xy, valid = np.asarray(xy).copy(), np.asarray(valid).copy()
    xy[-8:] = [[1.0, 1.0], [190.5, 3.2], [0.0, 127.0], [100.0, 126.6], [191.0, 64.0], [2.3, 60.0],
               [260.0, 60.0], [-40.0, -30.0]]  # the last two lie off the image
    valid[-8:] = True
    return imgs, xy, valid


class TestUncachedTracker:
    @pytest.mark.parametrize("win,levels", [(15, 3), (21, 2), (9, 1)])
    def test_track_against_jax(self, pair, win, levels):
        """Positions within 1e-4 px on slots both keep, status equal: the
        same template window, clipped to the padded image, and region per
        level (bilinear taps in another order of additions)."""
        imgs, xy, valid = pair
        jp0, jp1 = (j_build_pyramid(J(im), levels) for im in imgs[:2])
        p0, p1 = (build_pyramid(T(im), levels) for im in imgs[:2])
        jxy, jst = j_lk.track(jp0, jp1, J(xy), J(valid), win=win, iters=8)
        got, st = lk.track(p0, p1, T(xy), T(valid), win=win, iters=8)
        jst = np.asarray(jst)
        assert np.array_equal(st.numpy(), jst)
        assert jst.sum() > 20 and (valid & ~jst).any()
        np.testing.assert_allclose(got.numpy()[jst], np.asarray(jxy)[jst], atol=1e-4)

    def test_launches_no_kernel(self, pair):
        imgs, xy, valid = pair
        before = (lk_kernels.lk_track_level.launches, min_eig.min_eig_response.launches)
        p0, p1 = (build_pyramid(T(im), 2) for im in imgs[:2])
        lk.track(p0, p1, T(xy), T(valid), win=15, iters=4)
        assert (lk_kernels.lk_track_level.launches, min_eig.min_eig_response.launches) == before

    def test_track_against_track_cached(self, pair):
        """The port's own fresh-template tracker against its cached one on
        two hops (tests/test_frontend.py holds the JAX package's pair so)."""
        imgs, xy, valid = pair
        pyrs = [build_pyramid(T(im), 3) for im in imgs]
        blocks = lk.capture_blocks(tuple(pyrs[0]), T(xy), win=15)
        fresh_xy, fresh_st = lk.track(pyrs[0], pyrs[1], T(xy), T(valid), win=15)
        cach_xy, cach_st, blocks = lk.track_cached(blocks, pyrs[1], T(xy), T(valid), win=15)
        both = (fresh_st & cach_st).numpy()
        assert both.sum() >= int(fresh_st.sum()) * 0.9
        np.testing.assert_allclose(cach_xy.numpy()[both], fresh_xy.numpy()[both], atol=0.05)
        fresh2_xy, fresh2_st = lk.track(pyrs[1], pyrs[2], cach_xy, cach_st, win=15)
        cach2_xy, cach2_st, _ = lk.track_cached(blocks, pyrs[2], cach_xy, cach_st, win=15)
        both2 = (fresh2_st & cach2_st).numpy()
        assert both2.sum() >= int(fresh2_st.sum()) * 0.85
        np.testing.assert_allclose(cach2_xy.numpy()[both2], fresh2_xy.numpy()[both2], atol=0.25)


class TestSteps:
    def test_track_step(self, pair):
        imgs, xy, valid = pair
        n = len(xy)
        lm = np.random.default_rng(0).integers(-1, 40, n).astype(np.int32)
        score = np.linspace(1, 2, n).astype(np.float32)
        jp0, jp1 = (j_build_pyramid(J(im), 2) for im in imgs[:2])
        p0, p1 = (build_pyramid(T(im), 2) for im in imgs[:2])
        ref = j_steps.track_step(jp0, jp1, JFeatureTable(J(xy), J(valid), J(lm), J(score)),
                                 win=15, iters=6, search=5)
        got = steps.track_step(p0, p1, FeatureTable(T(xy), T(valid), T(lm), T(score)),
                               win=15, iters=6, search=5)
        for f in ("valid", "landmark", "score"):
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f))), f
        v = got.valid.numpy()
        np.testing.assert_allclose(got.xy.numpy()[v], np.asarray(ref.xy)[v], atol=1e-4)

    @pytest.mark.parametrize("response,quality,min_distance", [
        ("min_eig", 0.01, 5), ("fast", 0.0, 1), ("min_eig", 0.4, 1),
    ])
    def test_reseed_step(self, pair, response, quality, min_distance):
        """Extraction + merge into the free slots: equal tables."""
        imgs, xy, valid = pair
        n = len(xy)
        rng = np.random.default_rng(1)
        v = valid & (rng.random(n) > 0.5)
        lm = rng.integers(-1, 40, n).astype(np.int32)
        sc = rng.random(n).astype(np.float32)
        kw = dict(tile_h=64, tile_w=96, quality=quality, min_distance=min_distance, response=response)
        img = np.round(imgs[1])
        ref = j_steps.reseed_step(JFeatureTable(J(xy), J(v), J(lm), J(sc)), J(img), 20, **kw)
        got = steps.reseed_step(FeatureTable(T(xy), T(v), T(lm), T(sc)), T(img), 20, **kw)
        assert int(got.valid.sum()) > int(v.sum())
        for f in ("xy", "valid", "landmark"):
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f))), f
        np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), rtol=1e-5)

    def test_grid_cand_count_and_count_3d(self):
        for shape, n, th, tw in (((370, 1226), 101, 255, 255), ((96, 160), 7, 50, 64)):
            assert steps.grid_cand_count(shape, n, th, tw) == j_steps.grid_cand_count(shape, n, th, tw)
            xy, _, _ = corners.grid_extract(torch.zeros(shape), n, tile_h=th, tile_w=tw)
            assert xy.shape[0] == steps.grid_cand_count(shape, n, th, tw)
        rng = np.random.default_rng(2)
        n, m = 60, 30
        table = (rng.uniform(0, 50, (n, 2)).astype(np.float32), rng.random(n) > 0.3,
                 rng.integers(-1, m, n).astype(np.int32), np.ones(n, np.float32))
        xyz, alive = np.zeros((m, 3), np.float32), rng.random(m) > 0.4
        ref = j_steps.count_3d(JFeatureTable(*map(J, table)), JMapState(J(xyz), J(alive), jnp.int32(0)))
        got = steps.count_3d(FeatureTable(*map(T, table)), MapState(T(xyz), T(alive), torch.tensor(0)))
        assert int(got) == int(ref) > 0


def make_problem(seed=0, P=4, N=40, L=70, dup=0, noise=0.3):
    """A flat window problem in the pipeline's conventions (z-flipped
    world, pose blocks [angle_axis(R^T), -t]): P x N slot observations, about
    15 % masked, landmarks drawn from L of which some are never observed.
    ``dup`` extra observations repeat (landmark, pose) pairs already seen."""
    rng = np.random.default_rng(seed)
    lm = np.stack([rng.uniform(-8, 8, L), rng.uniform(-4, 4, L), rng.uniform(-40, -10, L)], -1)
    tr = np.zeros((P, 6))
    tr[:, :3] = rng.normal(size=(P, 3)) * 0.01
    tr[:, 5] = np.arange(P) * 1.0
    obs_pose = np.repeat(np.arange(P), N).astype(np.int32)
    obs_lm = np.concatenate([rng.permutation(L - 5)[:N] for _ in range(P)]).astype(np.int32)
    if dup:
        pick = rng.choice(P * N, dup, replace=False)
        obs_pose = np.concatenate([obs_pose, obs_pose[pick]])
        obs_lm = np.concatenate([obs_lm, obs_lm[pick]])
    uv = np.asarray(j_geo.ba_project(J(tr)[obs_pose], J(lm)[obs_lm], J(K.astype(np.float64))))
    uv = uv + rng.normal(size=uv.shape) * noise
    mask = rng.random(len(obs_pose)) > 0.15
    pose_free = np.arange(P) >= 1
    tr0 = tr + rng.normal(size=tr.shape) * 0.01 * pose_free[:, None]
    lm0 = lm + rng.normal(size=lm.shape) * 0.05
    return tr0, lm0, uv, obs_pose, obs_lm, mask, pose_free


def problems(args, dtype):
    tr, lm, uv, pose, lmi, mask, pf = args
    c = lambda a: np.asarray(a, dtype)  # noqa: E731
    jp = j_ba.BAProblem(J(c(tr)), J(c(lm)), J(c(uv)), J(pose), J(lmi), J(mask), J(pf), J(c(K)))
    tp = ba.BAProblem(T(c(tr)), T(c(lm)), T(c(uv)), T(pose), T(lmi), T(mask), T(pf), T(c(K)))
    return jp, tp


class TestFlatBA:
    @pytest.mark.parametrize("dup", [0, 25])
    def test_assemble_blocks_f64(self, dup):
        """Blocks in float64 within 1e-10 relative to each block's scale,
        repeated (landmark, pose) pairs included (both sides sum them)."""
        jp, tp = problems(make_problem(0, dup=dup), np.float64)
        ref = j_ba.assemble_blocks(jp.tr, jp.lm, jp.obs_uv, jp.obs_pose, jp.obs_lm, jp.obs_mask,
                                   jp.pose_free, jp.K, 1.0)
        got = ba.assemble_blocks(tp.tr, tp.lm, tp.obs_uv, tp.obs_pose, tp.obs_lm, tp.obs_mask,
                                 tp.pose_free, tp.K, 1.0)
        for name, g, r in zip(("U", "V", "Wc", "b_pose", "b_lm"), got[:5], ref[:5]):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-10, atol=1e-10 * np.abs(r).max(), err_msg=name)
        assert np.array_equal(got[5].numpy(), np.asarray(ref[5]))
        assert not got[5].numpy()[-5:].any()  # never-observed landmarks

    @pytest.mark.parametrize("seed,gate", [(0, 0.0), (1, 0.0), (2, 6.0)])
    def test_ba_solve_f64(self, seed, gate):
        """Five LM iterations from the same start in float64: poses,
        landmarks and cost history within 1e-10 (both sides do the same
        arithmetic up to the order of sums)."""
        jp, tp = problems(make_problem(seed), np.float64)
        jtr, jlm, jst = j_ba.ba_solve(jp, iters=5, obs_gate_px=gate)
        ttr, tlm, tst = ba.ba_solve(tp, iters=5, obs_gate_px=gate)
        assert ttr.dtype == torch.float64
        np.testing.assert_allclose(tst["history"].numpy(), np.asarray(jst["history"]), rtol=1e-10)
        np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), rtol=1e-10, atol=1e-10)
        assert float(tst["cost"]) < 0.5 * float(tst["cost0"])

    def test_ba_solve_f32_to_the_cost(self):
        """In float32 each loop drifts along the window's scale gauge
        (ROADMAP Queue 3): the same initial cost (1e-4), the same final cost
        (1e-3), poses within 5e-2 of the float64 result."""
        args = make_problem(3)
        ref64 = np.asarray(j_ba.ba_solve(problems(args, np.float64)[0], iters=5)[0])
        jp, tp = problems(args, np.float32)
        jtr, _, jst = j_ba.ba_solve(jp, iters=5)
        ttr, _, tst = ba.ba_solve(tp, iters=5)
        np.testing.assert_allclose(float(tst["cost0"]), float(jst["cost0"]), rtol=1e-4)
        np.testing.assert_allclose(float(tst["cost"]), float(jst["cost"]), rtol=1e-3)
        for got in (ttr.numpy(), np.asarray(jtr)):
            assert np.abs(got - ref64).max() < 5e-2

    def test_flat_equals_grid_on_a_slot_window(self):
        """A pose-major slot window solved flat and as a (P, N) grid: the
        same problem, so in float64 the same result within 1e-10."""
        tr, lm, uv, pose, lmi, mask, pf = make_problem(4)
        P, N = 4, 40
        _, tp = problems((tr, lm, uv, pose, lmi, mask, pf), np.float64)
        ftr, flm, fst = ba.ba_solve(tp, iters=4)
        gtr, glm, gst = ba.ba_solve_grid(
            tp.tr, tp.lm, tp.obs_uv.reshape(P, N, 2), tp.obs_lm.reshape(P, N),
            tp.obs_mask.reshape(P, N), tp.pose_free, tp.K, iters=4,
        )
        np.testing.assert_allclose(ftr.numpy(), gtr.numpy(), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(flm.numpy(), glm.numpy(), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(fst["history"].numpy(), gst["history"].numpy(), rtol=1e-10)

    def test_repeated_pairs_sum_in_a_fixed_order(self):
        """The rows of repeated (landmark, pose) pairs sum in an order the
        inputs fix: the values [x0, x1, x2] of one key as ((0 + x0) + x1) +
        x2, whatever lies between them (the values are chosen so that other
        orders give other bits), and moving other keys' values around them
        changes no bit of any row. (On the CPU ``index_add_`` adds in this
        order too; on the card it does not, and chip_smoke.py's ``modular``
        phase holds the card's row sums to the CPU's bits.)"""
        x = np.float32([1e8, -1e8, 1.0])
        want = ((np.float32(0) + x[0]) + x[1]) + x[2]
        assert want != (x[2] + x[1]) + x[0] and want != (x[0] + x[2]) + x[1]
        key = torch.tensor([3, 0, 3, 5, 3, 0])
        vals = torch.tensor([[x[0]], [2.0], [x[1]], [7.0], [x[2]], [0.5]])
        rows = ba._sum_rows(key, vals, 6)
        assert rows[3].numpy().tobytes() == np.float32([want]).tobytes()
        assert rows[:, 0].tolist() == [2.5, 0.0, 0.0, 1.0, 0.0, 7.0]

        rng = np.random.default_rng(6)
        key = torch.from_numpy(rng.integers(0, 40, 500))
        vals = torch.from_numpy(
            (rng.normal(size=(500, 3)) * 10.0 ** rng.integers(-4, 8, (500, 1))).astype(np.float32))
        rows = ba._sum_rows(key, vals, 40)
        grouped = torch.argsort(key, stable=True)
        assert torch.equal(ba._sum_rows(key[grouped], vals[grouped], 40), rows)
        np.testing.assert_allclose(
            ba._sum_rows(key, vals.double(), 40).numpy(),
            torch.zeros(40, 3, dtype=torch.float64).index_add_(0, key, vals.double()).numpy(),
            rtol=1e-12, atol=1e-12 * float(vals.abs().max()))

    def test_robust_cost_and_repeatable(self):
        jp, tp = problems(make_problem(5, dup=10), np.float32)
        np.testing.assert_allclose(float(ba.robust_cost(tp.tr, tp.lm, tp)),
                                   float(j_ba.robust_cost(jp.tr, jp.lm, jp)), rtol=1e-5)
        a = ba.ba_solve(tp, iters=3)
        b = ba.ba_solve(tp, iters=3)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# --------------------------------------------------------------------------
# run_modular end to end
# --------------------------------------------------------------------------

SHAPE = (96, 160)
FRAMES = 16
RUN_CFG = dict(
    frames=FRAMES, init_frames=2, min_tracked_features=100, tracked_features_tol=48,
    bundle_size=4, max_iterations=3, feature_capacity=128, map_capacity=512,
    grid_rows=96, grid_cols=160, lk_window=15, lk_levels=2, traj_cap=32, seed=0,
)
# kNN at this size matches 20-60 features a frame: a lower PnP threshold
# lets the loop reach PnP frames, as with the LK matcher
MATCHERS = {"lk": {}, "knn": dict(matcher="knn", tracked_features_tol=20)}
# Rebased ATE bar as a share of the 14 m path. Over RANSAC seeds 0-3 the
# LK loop measures 0.82-0.98 m here and 0.78-0.94 m in the JAX package; kNN
# (integer-pixel association) 1.14-2.05 m and 1.04-1.74 m.
ATE_BAR = {"lk": 0.10, "knn": 0.20}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    seq = j_synthetic.make_sequence(n_frames=FRAMES, shape=SHAPE, density=200, seed=3)
    return j_synthetic.write_kitti_layout(seq, tmp_path_factory.mktemp("kitti"))


def _cfg(module, paths, **kw):
    return module.VOConfig(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], **{**RUN_CFG, **kw},
    )


def _rebased_ate(pipe):
    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
    path = np.sum(np.linalg.norm(np.diff(gt[off : off + n], axis=0), axis=1))
    return float(np.sqrt(np.mean(np.sum(rel**2, axis=1)))), float(path)


@pytest.fixture(scope="module", params=sorted(MATCHERS))
def runs(request, dataset):
    """The port's run_modular with RANSAC seeds 0 and 1, the JAX package's
    with seed 0, each counting the kernel launches of the port's runs."""
    kw = MATCHERS[request.param]
    ours = []
    for seed in (0, 1):
        before = (lk_kernels.lk_track_level.launches, min_eig.min_eig_response.launches)
        pipe = OdometryPipeline(_cfg(config, dataset, seed=seed, **kw), device="cpu")
        result = pipe.run_modular()
        after = (lk_kernels.lk_track_level.launches, min_eig.min_eig_response.launches)
        ours.append((pipe, result, after != before))
    theirs = JOdometryPipeline(_cfg(j_config, dataset, **kw))
    return request.param, ours, theirs, theirs.run_modular()


class TestRunModular:
    def test_same_initialisation_and_bookkeeping(self, runs):
        name, ours, theirs, r_theirs = runs
        pipe, result, _ = ours[0]
        assert pipe.init_offset == theirs.init_offset
        assert np.array_equal(pipe.tables[0].xy.numpy(), np.asarray(theirs.tables[0].xy))
        assert result["frames"] == r_theirs["frames"] == len(pipe.tables)
        assert result["ba_calls"] == r_theirs["ba_calls"] >= 1
        stats = pipe.frame_stats
        assert len(stats) == result["frames"] - 1
        assert not stats[0]["used_pnp"] and any(s["used_pnp"] for s in stats)
        assert all(isinstance(s["inliers"], int) and isinstance(s["accepted"], bool) for s in stats)

    def test_same_accuracy_class(self, runs):
        """Every run ends with a rebased ATE under its matcher's bar
        (``ATE_BAR``: with LK the 10 % that tests/test_torch_odometry.py holds
        ``run`` to); draws differ, so the poses themselves are not
        compared."""
        name, ours, theirs, _ = runs
        for pipe in [p for p, _, _ in ours] + [theirs]:
            ate, path = _rebased_ate(pipe)
            assert np.isfinite(np.stack(pipe.t)).all()
            assert ate < ATE_BAR[name] * path, (name, type(pipe).__module__, ate, path)

    def test_repeatable_and_seeded(self, runs, dataset):
        name, ours, _, _ = runs
        again = OdometryPipeline(_cfg(config, dataset, **MATCHERS[name]), device="cpu")
        again.run_modular()
        assert np.array_equal(np.stack(again.t), np.stack(ours[0][0].t))
        assert not np.array_equal(np.stack(ours[1][0].t), np.stack(ours[0][0].t))

    def test_no_kernel_wrapper_is_called_on_the_cpu(self, runs):
        """On the CPU the wrappers take the plain versions and count nothing."""
        assert not any(changed for _, _, changed in runs[1])


def test_run_falls_back_to_modular_for_other_matchers(dataset, capsys, tmp_path):
    pipe = OdometryPipeline(_cfg(config, dataset, matcher="sift", frames=6), device="cpu")
    result = pipe.run()
    assert "falling back to the modular per-stage loop" in capsys.readouterr().out
    assert result["frames"] == len(pipe.t) == len(pipe.frame_stats) + 1
    # checkpoint_path belongs to run()'s fused loop: the modular loop, as the
    # JAX package's, takes no snapshot (utils.checkpoint.save(pipe) does)
    ck = tmp_path / "x.npz"
    OdometryPipeline(_cfg(config, dataset, frames=4, checkpoint_path=str(ck)), device="cpu").run_modular()
    assert not ck.exists()


def test_verbose_prints_the_stage_times(dataset, capsys):
    """Under verbose the modular loop prints the reference's per-stage lines
    (OdometryPipeline.cpp:334-340, :369-370, :394-395, :404-405) and the BA
    progress."""
    OdometryPipeline(_cfg(config, dataset, frames=7, verbose=1), device="cpu").run_modular()
    out = capsys.readouterr().out
    for line in ("seconds for feature matching in frame #1", "Trying to find 100 new features",
                 "Feature extraction took", "seconds for triangulating points.",
                 "seconds for pose estimation in frame #0", "BA iter 0: cost", "BA window [0,"):
        assert line in out, line
