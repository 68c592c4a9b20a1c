"""parallel/ of the port against the JAX package, on one device:
``dist_ba`` (the observation layout and the multi-window LM loop in both
modes), ``pose_graph`` (the dense Gauss-Newton, the exact chain stitch, the
window edges) and ``global_refine`` (the window problems of a finished run,
and the refinement's two properties: a drifted trajectory is pulled back, a
clean one is kept). The finished run is the port's, on the CPU; the JAX
package reads it through ``pmv_tpu_torch.convert``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.core import geometry as j_geo
from pmv_tpu.core.state import FeatureTable as JFeatureTable
from pmv_tpu.core.state import MapState as JMapState
from pmv_tpu.parallel import dist_ba as j_dist_ba
from pmv_tpu.parallel import global_refine as j_global_refine
from pmv_tpu.parallel import mesh as j_mesh
from pmv_tpu.parallel import pose_graph as j_pose_graph
from pmv_tpu_torch import convert
from pmv_tpu_torch.ba.schur_lm import BAProblem, ba_solve
from pmv_tpu_torch.config import VOConfig
from pmv_tpu_torch.io import synthetic
from pmv_tpu_torch.parallel import dist_ba, global_refine, pose_graph
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline
import test_parallel_flow
from test_ba import make_window

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)


def T(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def one_device_mesh():
    return j_mesh.make_mesh(dp=1, lm=1, devices=jax.devices()[:1])


def windows(seed: int, D: int = 2):
    """D BA windows of tests/test_ba.py (5 poses, 64 landmarks, two pinned
    poses) as float64 numpy, laid out by ``partition_obs_by_landmark`` with
    one shard and a few padded observations (mask clear, landmark 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(D):
        p = make_window(rng, P=5, L=64, noise=0.3)[0]
        uv, pose, lml, mask, O, _ = j_dist_ba.partition_obs_by_landmark(
            np.asarray(p.obs_uv), np.asarray(p.obs_pose), np.asarray(p.obs_lm),
            np.asarray(p.obs_mask), n_landmarks=64, n_shards=1,
        )
        pad = 7
        out.append(dict(
            tr=np.asarray(p.tr, np.float64), lm=np.asarray(p.lm, np.float64),
            uv=np.pad(uv, ((0, pad), (0, 0))), pose=np.pad(pose, (0, pad)).astype(np.int32),
            lml=np.pad(lml, (0, pad)).astype(np.int32), mask=np.pad(mask, (0, pad)),
            free=np.asarray(p.pose_free), K=np.asarray(p.K, np.float64),
        ))
    return out


def stack(ws, key):
    return np.stack([w[key] for w in ws])


class TestDistBA:
    @pytest.mark.parametrize("n_shards", [1, 3, 4])
    def test_partition_obs_by_landmark_exact(self, n_shards):
        rng = np.random.default_rng(n_shards)
        O, L = 300, 50
        args = (rng.normal(size=(O, 2)).astype(np.float32), rng.integers(0, 5, O).astype(np.int32),
                rng.integers(0, L, O).astype(np.int32), rng.random(O) > 0.2)
        want = j_dist_ba.partition_obs_by_landmark(*args, L, n_shards)
        got = dist_ba.partition_obs_by_landmark(*args, L, n_shards)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w)

    @pytest.mark.parametrize("mode", ["schur", "alternate"])
    def test_windows_match_the_jax_package_f64(self, mode):
        """``make_distributed_ba(None)`` against ``pmv_tpu``'s on a one-device
        mesh, two windows in float64: poses, landmarks and costs to 1e-10
        (the same arithmetic; only the order of sums differs)."""
        ws = windows(0)
        args = [stack(ws, k) for k in ("tr", "lm", "uv", "pose", "lml", "mask", "free")]
        K = ws[0]["K"]
        want = j_dist_ba.make_distributed_ba(one_device_mesh(), iters=6, mode=mode)(
            *map(jnp.asarray, args), jnp.asarray(K))
        got = dist_ba.make_distributed_ba(None, iters=6, mode=mode)(*map(T, args), T(K))
        assert got[0].dtype == torch.float64
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)
        assert (got[3] < got[2]).all()

    def test_schur_windows_match_ba_solve(self):
        """Each window of the multi-window solver against the port's
        single-window ``ba_solve``, as tests/test_dist_ba.py holds the JAX
        package's (in float64 there too, under the tests' x64): poses to
        1e-5, landmarks rtol 1e-3 / atol 5e-4, costs rtol 1e-6. (The two
        loops floor the damping differently, 1e-9 and 1e-6; in float32 the
        landmarks then part by up to 2e-3 relative after six iterations.)"""
        ws = windows(0)  # tests/test_dist_ba.py's two windows
        args = [T(stack(ws, k)) for k in ("tr", "lm", "uv", "pose", "lml", "mask", "free")]
        K = T(ws[0]["K"])
        tr_out, lm_out, cost0, cost = dist_ba.make_distributed_ba(None, iters=6)(*args, K)
        for d in range(len(ws)):
            prob = BAProblem(tr=args[0][d], lm=args[1][d], obs_uv=args[2][d], obs_pose=args[3][d],
                             obs_lm=args[4][d], obs_mask=args[5][d], pose_free=args[6][d], K=K)
            tr_ref, lm_ref, stats = ba_solve(prob, iters=6)
            np.testing.assert_allclose(tr_out[d].numpy(), tr_ref.numpy(), atol=1e-5)
            np.testing.assert_allclose(lm_out[d].numpy(), lm_ref.numpy(), rtol=1e-3, atol=5e-4)
            np.testing.assert_allclose(float(cost[d]), float(stats["cost"]), rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(float(cost0[d]), float(stats["cost0"]), rtol=1e-6)

    def test_padded_observations_add_nothing(self):
        """Observations with the mask clear (landmark 0, any pixel) change no
        bit of the result."""
        ws = windows(2, D=1)
        args = [T(stack(ws, k)) for k in ("tr", "lm", "uv", "pose", "lml", "mask", "free")]
        solve = dist_ba.make_distributed_ba(None, iters=4, mode="alternate")
        base = solve(*args, T(ws[0]["K"]))
        junk = [a.clone() for a in args]
        pad = ~junk[5][0]
        junk[2][0][pad] = 1e6
        junk[3][0][pad] = 3
        out = solve(*junk, T(ws[0]["K"]))
        for a, b in zip(base, out):
            assert torch.equal(a, b)


class TestPoseGraph:
    def test_optimize_matches_the_jax_package_f64(self):
        """A chain with skip edges (not a pure chain, so the dense solve is
        the one that runs), noisy measurements and drifted start: 1e-10."""
        rng = np.random.default_rng(0)
        N = 12
        R = np.asarray(jax.vmap(j_geo.rodrigues)(jnp.asarray(rng.normal(0, 0.2, (N, 3)))))
        t = rng.normal(0, 2, (N, 3))
        edges = np.array([(i, i + 1) for i in range(N - 1)] + [(i, i + 3) for i in range(N - 3)],
                         np.int32)
        mR, mt = [], []
        for i, j in edges:
            dR = np.asarray(j_geo.rodrigues(jnp.asarray(rng.normal(0, 0.01, 3))))
            mR.append(dR @ R[j] @ R[i].T)
            mt.append(R[i].T @ (t[j] - t[i]) + rng.normal(0, 0.01, 3))
        mR, mt = np.stack(mR), np.stack(mt)
        t0 = t + rng.normal(0, 0.3, t.shape)
        w = rng.uniform(0.5, 1.5, len(edges))
        anchored = np.zeros(N, bool)
        anchored[0] = True
        want = j_pose_graph.optimize(*map(jnp.asarray, (R, t0, edges, mR, mt, w, anchored)), iters=10)
        got = pose_graph.optimize(*map(T, (R, t0, edges, mR, mt, w, anchored)), iters=10)
        for g, wnt in zip(got, want):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0, atol=1e-10)
        # it moved the drifted translations toward the truth
        assert np.abs(got[1].numpy() - t).max() < np.abs(t0 - t).max()

    def test_stitch_chain_on_600_nodes(self):
        """tests/test_parallel_flow.py's 600-node chain with three noisy
        parallel edges per pair: equal to the JAX package's stitch to
        1e-12, and within its bars of the true chain."""
        rng = np.random.default_rng(0)
        N = 600
        R, t = [np.eye(3)], [np.zeros(3)]
        for k in range(N - 1):
            yaw = 0.004 + 0.001 * np.sin(k * 0.1)
            c, s = np.cos(yaw), np.sin(yaw)
            R.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ R[-1])
            t.append(R[-2] @ np.array([0.01, 0.0, -1.0]) + t[-1])
        R, t = np.stack(R), np.stack(t)
        E_idx, E_R, E_t = [], [], []
        for i in range(N - 1):
            for _ in range(3):
                dR = np.asarray(j_geo.rodrigues(jnp.asarray(rng.normal(0, 1e-4, 3))))
                E_idx.append((i, i + 1))
                E_R.append(dR @ R[i + 1] @ R[i].T)
                E_t.append(R[i].T @ (t[i + 1] - t[i]) + rng.normal(0, 1e-4, 3))
        args = (N, np.asarray(E_idx), np.stack(E_R), np.stack(E_t), R[0], t[0])
        R_out, t_out = pose_graph.stitch_chain(*args)
        R_ref, t_ref = j_pose_graph.stitch_chain(*args)
        np.testing.assert_allclose(R_out, R_ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(t_out, t_ref, rtol=0, atol=1e-12)
        assert np.abs(t_out - t).max() < 2.0 and np.abs(R_out - R).max() < 1e-2
        with pytest.raises(ValueError, match="chain"):
            pose_graph.stitch_chain(N, np.array([[0, 2]]), E_R[:1], E_t[:1], R[0], t[0])

    def test_window_edges_exact(self):
        rng = np.random.default_rng(3)
        frames = [[0, 1, 2, 3], [2, 3, 4, 5]]
        Rs = [np.asarray(jax.vmap(j_geo.rodrigues)(jnp.asarray(rng.normal(0, 0.1, (4, 3)))))
              for _ in frames]
        ts = [rng.normal(size=(4, 3)) for _ in frames]
        for g, w in zip(pose_graph.window_edges(frames, Rs, ts),
                        j_pose_graph.window_edges(frames, Rs, ts)):
            assert g.dtype == w.dtype and np.array_equal(g, w)


# --------------------------------------------------------------------------
# global_refine on a finished run of the port
# --------------------------------------------------------------------------


def finished_run(tmp, seed: int) -> dict:
    """The port's run() on the CPU, as numpy: 20 frames at 96x160 of the
    scene tests/test_parallel_flow.py refines (density 60, data seed
    ``seed``; that test's is 5)."""
    seq = synthetic.make_sequence(n_frames=20, shape=(96, 160), density=60, seed=seed)
    paths = synthetic.write_kitti_layout(seq, tmp)
    cfg = VOConfig(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], frames=20, init_frames=2, min_tracked_features=150,
        tracked_features_tol=60, bundle_size=5, max_iterations=3, feature_capacity=256,
        map_capacity=1024, grid_rows=96, grid_cols=160, lk_window=15, traj_cap=64,
    )
    pipe = OdometryPipeline(cfg, device="cpu")
    pipe.run()
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    return dict(run=convert.run_to_numpy(pipe),
                gt=[gt[i + pipe.init_offset] for i in range(len(pipe.t))])


@pytest.fixture(scope="module")
def finished(tmp_path_factory):
    return finished_run(tmp_path_factory.mktemp("kitti"), 5)


@pytest.fixture(scope="module")
def finished9(tmp_path_factory):
    """Seed 9's run: its map holds landmarks about 1e26 away, whose pose
    derivatives overflow to NaN in the JAX package (see
    ``test_refine_matches_the_jax_package``)."""
    return finished_run(tmp_path_factory.mktemp("kitti9"), 9)


def jax_run(d):
    """The JAX package's view of a finished run, from the flat dict."""
    n = d["t"].shape[0]
    tables = [JFeatureTable(*(jnp.asarray(d[f"tables.{f}"][i]) for f in ("xy", "valid", "landmark", "score")))
              for i in range(n)]
    return SimpleNamespace(
        R=list(d["R"]), t=list(d["t"]), K=jnp.asarray(d["K"]),
        map=JMapState(*(jnp.asarray(d[f"map.{f}"]) for f in ("xyz", "alive", "head"))),
        tables=tables,
    )


def mean_err(ts, ref):
    return float(np.mean([np.linalg.norm(np.asarray(ts[i]) - ref[i]) for i in range(1, len(ts))]))


inject_drift = test_parallel_flow.TestGlobalRefine._inject_drift


def jax_refine_spread(d, m, n: int = 8):
    """``pmv_tpu``'s refinement (window 8, overlap 4, 8 iterations) of the
    finished run ``d`` with tests/test_parallel_flow.py's drift, on its mesh
    ``m``: ((R, t) stacked, and how far it moves when the drifted poses are
    scaled by 1 + e, e = +-1e-6, +-2e-6, ... (``n`` of them): the largest
    max abs difference of R or t). In float32 windows the LM loop's accept
    decisions amplify its inputs' last bits: on the scene of ``finished``
    the JAX package's refinement moves 4.0e-3 to 2.0e-2 so on one device and
    2.2e-3 to 1.6e-2 on its (2, 2) mesh, where the port lands 6.0e-3 and
    2.1e-3 from it. A port with one LM iteration fewer lands 2.0e-2 from it,
    with two fewer 3.7e-2 (PERF.md, section 6)."""
    def refine(scale):
        ref = jax_run(d)
        inject_drift(ref)
        ref.t = [np.asarray(x) * (1 + scale) for x in ref.t]
        R, t = j_global_refine.global_bundle_adjust(ref, m, window=8, overlap=4, iters=8)
        return np.stack(R), np.stack(t)

    base = refine(0.0)
    spread = 0.0
    for j in range(n):
        R, t = refine((-1) ** j * (j // 2 + 1) * 1e-6)
        spread = max(spread, float(np.abs(R - base[0]).max()), float(np.abs(t - base[1]).max()))
    return base, spread


class TestGlobalRefine:
    def test_run_round_trip(self, finished):
        back = convert.run_to_numpy(convert.run_from_reference(finished["run"], "cpu"))
        for k, v in finished["run"].items():
            assert np.array_equal(back[k], v), k

    @pytest.mark.parametrize("pin", [0, 2])
    def test_build_window_problems_exact(self, finished, pin):
        """The windows of a finished run (stale-binding gate, freezing of
        poses with too few observations, pins) equal the JAX package's on
        the same converted inputs: frame ranges, free poses and every
        observation array bit for bit; the pose blocks to 1e-6 (float32
        angle-axis: the two libraries' acos may differ by an ulp)."""
        run = convert.run_from_reference(finished["run"], "cpu")
        got = global_refine.build_window_problems(run, window=8, overlap=4, pin=pin)
        want = j_global_refine.build_window_problems(jax_run(finished["run"]), window=8, overlap=4,
                                                     pin=pin)
        ranges, tr, free, obs, xyz, L = got
        assert ranges == want[0] and L == want[5] and np.array_equal(xyz, want[4])
        assert len(ranges) >= 3
        for a, b in zip(free, want[2]):
            assert np.array_equal(a, b)
        assert not all(f.all() for f in free)  # frame 0 at least is held
        for a, b in zip(obs, want[3]):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        assert sum(len(o[0]) for o in obs) > 0
        for a, b in zip(tr, want[1]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)

    def test_refine_improves_drifted_trajectory(self, finished):
        """Noise injected into a finished run is pulled back: strictly lower
        error against ground truth and the injected noise at least halved
        (tests/test_parallel_flow.py's bars)."""
        run = convert.run_from_reference(finished["run"], "cpu")
        clean = [x.copy() for x in run.t]
        inject_drift(run)
        noise_before = mean_err(run.t, clean)
        gt_before = mean_err(run.t, finished["gt"])
        R_out, t_out = global_refine.global_bundle_adjust(run, None, window=8, overlap=4, iters=8,
                                                          device="cpu")
        assert len(R_out) == len(t_out) == len(clean)
        assert np.isfinite(np.stack(t_out)).all()
        assert mean_err(run.t, finished["gt"]) < gt_before
        assert mean_err(run.t, clean) < noise_before / 2

    def test_refine_preserves_clean_trajectory(self, finished):
        run = convert.run_from_reference(finished["run"], "cpu")
        before = mean_err(run.t, finished["gt"])
        global_refine.global_bundle_adjust(run, None, window=8, overlap=4, iters=8, device="cpu")
        assert mean_err(run.t, finished["gt"]) < before * 1.1 + 0.02

    @pytest.mark.parametrize("seed", [5, 9])
    def test_refine_matches_the_jax_package(self, request, seed):
        """The whole refinement of a drifted run against ``pmv_tpu``'s on a
        one-device mesh, both in float32 windows: poses within 1e-3 of each
        other, or within the refinement's own sensitivity where that is
        larger (:func:`jax_refine_spread`; the chain stitch is exact f64).
        On seed 9 the JAX package's pose derivative of a point about 1e26
        away is NaN (its forward-mode quotient rule overflows), so every
        pose step of windows 1-2 fails its cost test; the port's derivative
        is NaN there too (``schur_lm._residual_jacobians``)."""
        finished = request.getfixturevalue("finished" if seed == 5 else "finished9")
        run = convert.run_from_reference(finished["run"], "cpu")
        inject_drift(run)
        R_out, t_out = global_refine.global_bundle_adjust(run, None, window=8, overlap=4, iters=8,
                                                          device="cpu")
        (R_ref, t_ref), spread = jax_refine_spread(finished["run"], one_device_mesh())
        bar = max(1e-3, spread)
        np.testing.assert_allclose(np.stack(t_out), t_ref, rtol=0, atol=bar)
        np.testing.assert_allclose(np.stack(R_out), R_ref, rtol=0, atol=bar)


def test_no_device_means_gpu(finished):
    """``global_bundle_adjust`` with no device runs on the GPU and raises
    without one."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        global_refine.global_bundle_adjust(convert.run_from_reference(finished["run"], "cpu"))
