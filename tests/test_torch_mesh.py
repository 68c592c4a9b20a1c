"""parallel/mesh.py and the mesh forms of the port on the CPU: ranks of the
``gloo`` backend started by ``mesh.launch`` (one launch of 4 ranks for the
whole file; each rank runs every check and hands its results back).

- ``make_distributed_ba`` on a (2, 2) mesh against ``pmv_tpu``'s on its
  virtual CPU mesh in float64 (1e-9), and against the port's ``mesh=None``
  in float32 (tests/test_dist_ba.py's bars); every rank's output equal bit
  for bit; the communication per LM iteration constant in the landmark
  count, one all-reduce per ``schur_solve``; 4 landmark shards of one
  window lower the cost and recover the poses;
- ``global_bundle_adjust`` on a (2, 2) mesh against ``pmv_tpu``'s (1e-3);
- the dp form of the batched chunk step: each rank's rows equal to the
  one-process ``mesh=None`` loop bit for bit, and no collective in the step;
- ``make_mesh``'s and ``initialize_multihost``'s outcomes, and the probe.

JAX is imported inside functions only: every rank imports this module to
find its function, and no rank may import ``jax`` or ``pmv_tpu``.
"""

import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pmv_tpu_torch import convert
from pmv_tpu_torch.ba import schur_lm
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend import corners
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.io import synthetic
from pmv_tpu_torch.parallel import dist_ba, global_refine, mesh, multi_seq, probe
from pmv_tpu_torch.pipeline import fused
from pmv_tpu_torch.pipeline.segmented import segment_generators
from pmv_tpu_torch.utils import checkpoint

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor. (Every rank sets it too.)
torch.set_num_threads(1)

RANKS = 4
MODES = ("schur", "alternate")
ITERS = 6
KEYS = ("tr", "lm", "uv", "pose", "lml", "mask", "free")
REFINE = dict(window=8, overlap=4, iters=8)
# the batched step: 4 small states, 2 chunks of C frames
H, W, B, C, N, M = 96, 160, 4, 4, 128, 512
STEP = dict(
    lk_levels=2, lk_window=15, lk_iters=6, tile_h=H, tile_w=W, n_per_tile=64, tracked_tol=48,
    reseed_tol=70, e_hypos=64, pnp_hypos=64, pnp_thresh=3.0, bundle_size=3, ba_iters=3, traj_cap=16,
)


def tensors(arrays, dtype=None):
    """numpy -> torch, floats to ``dtype`` where given."""
    out = [torch.from_numpy(np.array(a)) for a in arrays]
    return [t.to(dtype) if dtype is not None and t.is_floating_point() else t for t in out]


def layout(prob, n_shards: int, dtype=np.float64) -> dict:
    """One BA window (tests/test_ba.py's BAProblem) laid out for
    ``n_shards`` landmark shards, the map padded to a multiple of them."""
    uv, pose, lml, mask, _, Ls = dist_ba.partition_obs_by_landmark(
        np.asarray(prob.obs_uv), np.asarray(prob.obs_pose), np.asarray(prob.obs_lm),
        np.asarray(prob.obs_mask), n_landmarks=prob.lm.shape[0], n_shards=n_shards)
    lm = np.zeros((Ls * n_shards, 3))
    lm[: prob.lm.shape[0]] = np.asarray(prob.lm)
    return dict(tr=np.asarray(prob.tr, dtype), lm=lm.astype(dtype), uv=uv.astype(dtype),
                pose=pose.astype(np.int32), lml=lml.astype(np.int32), mask=mask,
                free=np.asarray(prob.pose_free), K=np.asarray(prob.K, dtype))


def stacked(ws: list[dict]) -> list[np.ndarray]:
    """The solver's eight arguments for windows ``ws``."""
    return [np.stack([w[k] for w in ws]) for k in KEYS] + [ws[0]["K"]]


# --------------------------------------------------------------------------
# what every rank runs
# --------------------------------------------------------------------------


def rank_checks(rank: int, inp: dict) -> dict:
    """Every check's work on one rank of a 4-rank gloo group."""
    out = {"jax_free": not any(m.split(".")[0] in ("jax", "jaxlib", "pmv_tpu") for m in sys.modules),
           "reinit": mesh.initialize_multihost()}
    try:
        mesh.make_mesh(dp=3, device_type="cpu")
    except ValueError as e:
        out["value_error"] = str(e)
    m = mesh.make_mesh(dp=2, lm=2, device_type="cpu")
    out["coord"] = (m.coord["dp"], m.coord["lm"])

    for mode in MODES:
        solve = dist_ba.make_distributed_ba(m, iters=ITERS, mode=mode)
        out[f"f64.{mode}"] = [x.numpy() for x in solve(*tensors(inp["f64"]))]
        out[f"f32.{mode}"] = [x.numpy() for x in solve(*tensors(inp["f64"], torch.float32))]
    try:
        dist_ba.make_distributed_ba(m)(*tensors([a[:1] for a in inp["f64"][:7]] + [inp["f64"][7]]))
    except ValueError as e:
        out["split_error"] = str(e)
    for L, args in inp["comm"].items():
        out[f"comm.{L}"] = probe.comm_profile(m, tensors(args), iters=2)
    # one schur_solve on this rank's shard of the first window
    args = tensors(inp["f64"])
    Ls, Os = args[1].shape[1] // 2, args[2].shape[1] // 2
    s = m.coord["lm"]
    lms, obs = slice(s * Ls, (s + 1) * Ls), slice(s * Os, (s + 1) * Os)
    blocks = schur_lm.assemble_blocks(args[0][0], args[1][0, lms], args[2][0, obs], args[3][0, obs],
                                      args[4][0, obs], args[5][0, obs], args[6][0], args[7], 1.0)
    with probe.count_collectives() as calls:
        schur_lm.schur_solve(*blocks, args[6][0], torch.tensor(1e-4, dtype=torch.float64),
                             group=m.group("lm"))
    out["schur_calls"] = calls

    m14 = mesh.make_mesh(dp=1, lm=4, device_type="cpu")
    out["one_window"] = [x.numpy() for x in
                         dist_ba.make_distributed_ba(m14, iters=5)(*tensors(inp["one_window"]))]

    for form, run in inp["runs"].items():
        pipe = convert.run_from_reference(run, m.device)
        R, t = global_refine.global_bundle_adjust(pipe, m, **REFINE)
        out[f"refine.{form}"] = (np.stack(R), np.stack(t))

    rows = multi_seq.local_rows(m, B)
    gens = [torch.Generator() for _ in rows]
    state = multi_seq.batch_states([checkpoint.load_fused_state(inp["states"][b], m.device, g)[0]
                                    for b, g in zip(rows, gens)])
    step = multi_seq.make_batched_chunk_step(m, fused.StepConfig(**STEP))
    imgs = torch.from_numpy(inp["imgs"][rows.start: rows.stop])
    gts = inp["gts"][rows.start: rows.stop]
    K = torch.from_numpy(inp["K"])
    stats = [[] for _ in rows]
    with probe.count_collectives() as calls:
        for c0 in (0, C):
            state, st = step(state, imgs[:, c0: c0 + C], gts[:, c0: c0 + C].tolist(), gens, K)
            for i, s_ in enumerate(st):
                stats[i] += [(int(x["tracked"]), int(x["n3d"]), bool(x["reseed"])) for x in s_]
    out["step"] = dict(rows=list(rows), calls=calls, stats=stats,
                       states=[convert.state_to_numpy(multi_seq.state_at(state, i))
                               for i in range(len(rows))],
                       gens=[g.get_state().numpy() for g in gens])
    return out


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------


def make_windows() -> dict:
    """tests/test_ba.py's windows: two at L=64 (2 shards and 1), one at L=64
    for 4 shards, and the communication windows at L=64 and L=256.
    (scripts/torch_mesh_gap.py measures its gaps on these too.)"""
    from test_ba import make_window

    rng = np.random.default_rng(0)
    probs = [make_window(rng, P=5, L=64, noise=0.3)[0] for _ in range(2)]
    one, tr_gt, _ = make_window(np.random.default_rng(1), P=5, L=64, noise=0.1)
    rng = np.random.default_rng(2)
    comm = {L: stacked([layout(make_window(rng, P=5, L=L, noise=0.2)[0], 2, np.float32)] * 2)
            for L in (64, 256)}
    return dict(f64=stacked([layout(p, 2) for p in probs]),
                f64_one_shard=stacked([layout(p, 1) for p in probs]),
                one_window=stacked([layout(one, 4, np.float32)]), one_window_gt=tr_gt, comm=comm)


@pytest.fixture(scope="module")
def windows():
    return make_windows()


def make_finished(tmp, seed: int = 5) -> dict:
    """The port's run() on the CPU as numpy (tests/test_torch_parallel.py's
    20 frames at 96x160, data seed ``seed``, written under ``tmp``), clean
    and with tests/test_parallel_flow.py's drift injected, and the ground
    truth of its poses. (scripts/torch_mesh_gap.py measures its gaps on this
    scene too.)"""
    from test_torch_parallel import inject_drift

    from pmv_tpu_torch.config import VOConfig
    from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

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
    clean = convert.run_to_numpy(pipe)
    drifted = dict(clean)
    holder = type("Run", (), {})()
    holder.R, holder.t = list(clean["R"]), list(clean["t"])
    inject_drift(holder)
    drifted["R"], drifted["t"] = np.stack(holder.R), np.stack(holder.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    gt = np.stack([gt[i + pipe.init_offset] for i in range(len(pipe.t))])
    return dict(clean=clean, drifted=drifted, gt=gt)


@pytest.fixture(scope="module")
def finished(tmp_path_factory):
    return make_finished(tmp_path_factory.mktemp("kitti"))


@pytest.fixture(scope="module")
def finished9(tmp_path_factory):
    """Seed 9's run (tests/test_torch_parallel.py's ``finished9``)."""
    return make_finished(tmp_path_factory.mktemp("kitti9"), seed=9)


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    """B seeded states (one corridor per data seed) saved with their RANSAC
    generators, and the next 2C frames of each."""
    d = tmp_path_factory.mktemp("states")
    cfg = fused.StepConfig(**STEP)
    seqs = [synthetic.make_sequence(n_frames=2 * C + 1, shape=(H, W), density=200, seed=s) for s in range(B)]
    paths = []
    for b, (seq, gen) in enumerate(zip(seqs, segment_generators(0, B, "cpu"))):
        img = torch.from_numpy(seq["images"][0]).float()
        xy, sc, va = corners.grid_extract(img, cfg.n_per_tile, tile_h=H, tile_w=W)
        txy, tsc, tva = corners.select_top(xy, sc, va, N)
        table = FeatureTable(xy=txy, valid=tva, landmark=torch.full((N,), -1, dtype=torch.int32), score=tsc)
        state = fused.init_state(build_pyramid(img, cfg.lk_levels), table, MapState.empty(M), cfg)
        paths.append(str(d / f"state{b}.npz"))
        checkpoint.save_fused_state(state, paths[-1], generator=gen)
    return dict(states=paths, imgs=np.stack([s["images"][1:] for s in seqs]).astype(np.uint8),
                gts=np.stack([np.linalg.norm(np.diff(s["gt_t"], axis=0), axis=1) for s in seqs]),
                K=np.asarray(seqs[0]["K"], np.float32))


@pytest.fixture(scope="module")
def ranks(windows, finished, finished9, step_inputs):
    """One launch of 4 gloo ranks; every rank's results, in rank order."""
    inp = dict(f64=windows["f64"], one_window=windows["one_window"], comm=windows["comm"],
               runs={"clean": finished["clean"], "drifted": finished["drifted"],
                     "drifted9": finished9["drifted"]}, **step_inputs)
    return mesh.launch(rank_checks, RANKS, device_type="cpu", args=(inp,), timeout=600)


def jax_mesh(dp, lm):
    import jax

    from pmv_tpu.parallel import mesh as j_mesh

    return j_mesh.make_mesh(dp=dp, lm=lm, devices=jax.devices()[: dp * lm])


def equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


# --------------------------------------------------------------------------
# dist_ba
# --------------------------------------------------------------------------


class TestDistBA:
    @pytest.mark.parametrize("mode", MODES)
    def test_matches_the_jax_package_f64(self, ranks, windows, mode):
        """(2, 2) against ``pmv_tpu``'s ``make_distributed_ba`` on a (2, 2)
        virtual CPU mesh, the same global inputs in float64: poses,
        landmarks and costs to 1e-9 (only the order of the sums differs)."""
        import jax.numpy as jnp

        from pmv_tpu.parallel import dist_ba as j_dist_ba

        want = j_dist_ba.make_distributed_ba(jax_mesh(2, 2), iters=ITERS, mode=mode)(
            *map(jnp.asarray, windows["f64"]))
        got = ranks[0][f"f64.{mode}"]
        assert got[0].dtype == np.float64
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-9)
        assert (got[3] < got[2]).all()

    @pytest.mark.parametrize("mode", MODES)
    def test_f32_matches_one_device(self, ranks, windows, mode):
        """(2, 2) in float32 against the port's ``mesh=None`` on the
        one-shard layout of the same windows. The landmark sums are taken in
        another order, and six f32 LM iterations amplify it: the JAX
        package's own (2, 2) solve lands up to 2.5e-5 from its one-device
        solve in the poses, 3.0e-3 relative in the landmarks and 2.7e-4
        relative in the cost (schur mode; scripts/torch_mesh_gap.py), beyond
        tests/test_dist_ba.py's bars, which that test applies to float64
        windows. Both packages are held to the same bars here: poses 1e-4,
        landmarks 1e-2 relative, costs 1e-3 relative, each widened to the
        JAX package's own sensitivity where that is larger: how far its
        one-device solve moves when the landmarks are scaled by 1 + e, e =
        +-1e-6, ..., +-4e-6. The pivot row's residual, which the port
        carries as XLA computes it, makes that sensitivity large in schur
        mode (landmarks 3.8e-2 and cost 7.6e-2 relative, where the port's
        mesh lands 1.03e-2 and 5.6e-5 from its one device)."""
        import jax.numpy as jnp

        from pmv_tpu.parallel import dist_ba as j_dist_ba

        def f32(arrays):
            return [a.astype(np.float32) if a.dtype == np.float64 else a for a in arrays]

        one_in = f32(windows["f64_one_shard"])
        one = [x.numpy() for x in dist_ba.make_distributed_ba(None, iters=ITERS, mode=mode)(*tensors(one_in))]
        j_solve = j_dist_ba.make_distributed_ba(jax_mesh(1, 1), iters=ITERS, mode=mode)
        j_one = [np.asarray(x) for x in j_solve(*map(jnp.asarray, one_in))]
        j_mesh = j_dist_ba.make_distributed_ba(jax_mesh(2, 2), iters=ITERS, mode=mode)(
            *map(jnp.asarray, f32(windows["f64"])))
        L = one[1].shape[1]

        def gaps(sharded, single):
            return (float(np.abs(sharded[0] - single[0]).max()),
                    float((np.abs(sharded[1][:, :L] - single[1]) / np.abs(single[1])).max()),
                    float((np.abs(sharded[2] - single[2]) / np.abs(single[2])).max()),
                    float((np.abs(sharded[3] - single[3]) / np.abs(single[3])).max()))

        bars = [1e-4, 1e-2, 1e-3, 1e-3]
        for j in range(8):
            moved = list(one_in)
            moved[1] = (moved[1] * (1 + (-1) ** j * (j // 2 + 1) * 1e-6)).astype(np.float32)
            got = gaps([np.asarray(x) for x in j_solve(*map(jnp.asarray, moved))], j_one)
            bars = [max(b, g) for b, g in zip(bars, got)]
        for sharded, single in ((ranks[0][f"f32.{mode}"], one), ([np.asarray(x) for x in j_mesh], j_one)):
            assert sharded[0].dtype == np.float32
            got = gaps(sharded, single)
            assert all(g <= b for g, b in zip(got, bars)), (got, bars)

    @pytest.mark.parametrize("part", ["f64.schur", "f64.alternate", "f32.schur", "f32.alternate",
                                      "one_window", "refine.clean", "refine.drifted",
                                      "refine.drifted9"])
    def test_every_rank_returns_the_same_bits(self, ranks, part):
        assert [r["coord"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
        for r in ranks[1:]:
            assert equal(r[part], ranks[0][part]), part

    def test_communication_is_constant_in_landmark_count(self, ranks):
        """The lm axis's scaling contract, as tests/test_dist_ba.py holds it
        on the compiled program: the all-reduces of an LM iteration, and
        their elements, are the same at L=64 and L=256 (and not none), and
        so are the initial cost's and the final gather's calls."""
        for r in ranks:
            a, b = r["comm.64"], r["comm.256"]
            assert a["per_iteration"] == b["per_iteration"], (a, b)
            assert a["per_iteration"]["all_reduce"]["calls"] > 0
            assert a["per_iteration"]["all_reduce"]["elements"] > 0
            assert a["once"] == b["once"] and a["once"]["all_reduce"]["calls"] == 1
            assert a["final_gather"]["calls"] == b["final_gather"]["calls"] == 5

    def test_one_all_reduce_per_schur_solve(self, ranks):
        """U (P, 6, 6), b_pose (P, 6), the reduced system's partials (6P x 6P
        and 6P) go in ONE all-reduce, at P=5."""
        for r in ranks:
            assert r["schur_calls"] == [("all_reduce", 5 * 36 + 30 + 30 * 30 + 30)]

    def test_four_lm_shards_of_one_window(self, ranks, windows):
        """A (1, 4) mesh on one window lowers the cost and recovers the
        poses (tests/test_dist_ba.py's 8-shard check)."""
        tr, _, cost0, cost = ranks[0]["one_window"]
        assert float(cost[0]) < float(cost0[0])
        assert np.abs(tr[0] - windows["one_window_gt"]).max() < 0.02

    def test_a_split_that_does_not_divide_is_refused(self, ranks):
        assert "do not split over a 2x2 mesh" in ranks[0]["split_error"]


# --------------------------------------------------------------------------
# global refinement, the batched step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [5, 9])
def test_refine_matches_the_jax_package(ranks, request, seed):
    """``global_bundle_adjust`` on a (2, 2) mesh against ``pmv_tpu``'s on
    its (2, 2) virtual CPU mesh, drifted run: poses within 1e-3, or within
    that refinement's own sensitivity where it is larger
    (test_torch_parallel.jax_refine_spread; the chain stitch is exact f64);
    the drift pulled back as tests/test_parallel_flow.py requires. Seed 9's
    run holds points whose pose derivative is NaN in both packages
    (tests/test_torch_parallel.py's ``test_refine_matches_the_jax_package``)."""
    from test_torch_parallel import jax_refine_spread

    finished = request.getfixturevalue("finished" if seed == 5 else "finished9")
    (R_ref, t_ref), spread = jax_refine_spread(finished["clean"], jax_mesh(2, 2))
    bar = max(1e-3, spread)
    R, t = ranks[0]["refine.drifted" if seed == 5 else "refine.drifted9"]
    np.testing.assert_allclose(t, t_ref, rtol=0, atol=bar)
    np.testing.assert_allclose(R, R_ref, rtol=0, atol=bar)

    def err(ts):
        return float(np.mean(np.linalg.norm(ts[1:] - finished["gt"][1:], axis=1)))

    def noise(ts):
        return float(np.mean(np.linalg.norm(ts[1:] - finished["clean"]["t"][1:], axis=1)))

    assert err(t) < err(finished["drifted"]["t"])
    if seed == 9:
        # The pose steps that fail leave more than half of the drift, in
        # the JAX package as in the port: a fact of the reference.
        assert noise(t_ref) > noise(finished["drifted"]["t"]) / 2
        return
    assert noise(t) < noise(finished["drifted"]["t"]) / 2
    R_c, t_c = ranks[0]["refine.clean"]
    assert err(t_c) < err(finished["clean"]["t"]) * 1.1 + 0.02


class TestBatchedStep:
    def test_rows_equal_the_one_process_loop(self, ranks, step_inputs):
        """Each rank steps rows [d*B/dp, (d+1)*B/dp) of the batch; every
        row equals the ``mesh=None`` loop over all B states in this process
        bit for bit: every tensor, the statistics and the generators. Ranks
        of one dp row hold the same rows."""
        gens = [torch.Generator() for _ in range(B)]
        state = multi_seq.batch_states([checkpoint.load_fused_state(p, "cpu", g)[0]
                                        for p, g in zip(step_inputs["states"], gens)])
        step = multi_seq.make_batched_chunk_step(None, fused.StepConfig(**STEP), device="cpu")
        imgs = torch.from_numpy(step_inputs["imgs"])
        K = torch.from_numpy(step_inputs["K"])
        stats = [[] for _ in range(B)]
        for c0 in (0, C):
            state, st = step(state, imgs[:, c0: c0 + C], step_inputs["gts"][:, c0: c0 + C].tolist(), gens, K)
            for b, s in enumerate(st):
                stats[b] += [(int(x["tracked"]), int(x["n3d"]), bool(x["reseed"])) for x in s]
        assert [r["step"]["rows"] for r in ranks] == [[0, 1], [0, 1], [2, 3], [2, 3]]
        for r in ranks:
            got = r["step"]
            for i, b in enumerate(got["rows"]):
                want = convert.state_to_numpy(multi_seq.state_at(state, b))
                assert equal(got["states"][i], want), b
                assert got["stats"][i] == stats[b]
                assert np.array_equal(got["gens"][i], gens[b].get_state().numpy())
        # the rows did different work (other data, other draws)
        assert not np.array_equal(ranks[0]["step"]["states"][0]["t_hist"],
                                  ranks[2]["step"]["states"][0]["t_hist"])

    def test_the_step_issues_no_collective(self, ranks):
        assert all(r["step"]["calls"] == [] for r in ranks)

    def test_local_rows_must_divide(self):
        fake = type("M", (), {"shape": {"dp": 2, "lm": 1}, "coord": {"dp": 1, "lm": 0}})()
        assert multi_seq.local_rows(fake, 6) == range(3, 6)
        with pytest.raises(ValueError, match="dp=2"):
            multi_seq.local_rows(fake, 5)


# --------------------------------------------------------------------------
# mesh.py, probe.py
# --------------------------------------------------------------------------


def test_ranks_stay_jax_free(ranks):
    assert all(r["jax_free"] for r in ranks)


def test_make_mesh_refuses_a_shape_that_is_not_the_world(ranks):
    assert all(r["value_error"] == "mesh 3x1 != 4 devices" for r in ranks)


@pytest.mark.parametrize("outcome", ["already_initialised", "no_launcher", "explicit_failure"])
def test_initialize_multihost(outcome, ranks, monkeypatch):
    """True where the group is up; False for the argument-free call outside
    a launcher; explicit arguments that fail raise (nothing degrades to one
    process)."""
    if outcome == "already_initialised":
        assert all(r["reinit"] is True for r in ranks)
        return
    assert not dist.is_initialized()
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    if outcome == "no_launcher":
        assert mesh.initialize_multihost() is False
    else:
        with pytest.raises(ValueError, match="go together"):
            mesh.initialize_multihost("127.0.0.1:1", 2)
        # rank 1 of 2, and no rank 0 serves the coordinator's port
        with pytest.raises(Exception):
            mesh.initialize_multihost(f"127.0.0.1:{mesh.free_port()}", 2, 1, "gloo", timeout=3)
    assert not dist.is_initialized()


def test_launch_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 .gloo. failed:.*ZeroDivisionError"):
        mesh.launch(divide_by_rank_minus_one, 2, device_type="cpu", timeout=120)


def divide_by_rank_minus_one(rank):
    return 1 / (rank - 1) if rank == 1 else 0


def test_run_probe_measures_only():
    """The measured legs give finite seconds; no analytic (TPU) leg."""
    out = probe.run_probe(2, Ls=64, iters=2, device_type="cpu")
    assert out["mesh_devices"] == min(2, len(__import__("os").sched_getaffinity(0)))
    secs = [v for k, v in out.items() if k.startswith("sec_")]
    assert secs and all(np.isfinite(s) and s > 0 for s in secs)
    assert not any("analytic" in k for k in out)


@pytest.mark.parametrize("call, args", [("run_probe", (2, 64, 2)), ("time_sharded_solve", (1, 64, 2)),
                                        ("pinned_one_shard_seconds", (64, 2))])
def test_probe_runs_on_the_card_unless_asked(call, args, monkeypatch):
    """``device_type=None`` means the card: without one the probe raises
    before it starts a rank or a subprocess; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        getattr(probe, call)(*args)
