"""pipeline/segmented.py and parallel/multi_seq.py of the port against the
JAX package, on the CPU: the stitch of segment trajectories against the JAX
package's arithmetic on the same histories, ``SegmentedPipeline`` end to end
(same bookkeeping, the same class of rebased ATE across RANSAC seeds: the
draws differ between the packages), and the batched chunk step against B
solo chunk steps, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.config import VOConfig as JVOConfig
from pmv_tpu.core.state import FeatureTable as JFeatureTable
from pmv_tpu.core.state import MapState as JMapState
from pmv_tpu.frontend import corners as j_corners
from pmv_tpu.frontend.image import build_pyramid as j_build_pyramid
from pmv_tpu.parallel import multi_seq as j_multi_seq
from pmv_tpu.pipeline import fused as j_fused
from pmv_tpu.pipeline.segmented import SegmentedPipeline as JSegmentedPipeline
from pmv_tpu_torch import convert
from pmv_tpu_torch.config import VOConfig
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend import corners
from pmv_tpu_torch.frontend.image import build_pyramid
from pmv_tpu_torch.io import synthetic
from pmv_tpu_torch.parallel import multi_seq
from pmv_tpu_torch.pipeline import fused
from pmv_tpu_torch.pipeline.segmented import SegmentedPipeline, segment_generators, stitch_segments

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

H, W = 96, 160
FRAMES = 16
SEGMENTS = 3
SEEDS = (0, 1, 2)


def settings(paths, **kw):
    return dict(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], frames=FRAMES, init_frames=2, min_tracked_features=150,
        tracked_features_tol=60, bundle_size=4, max_iterations=3, feature_capacity=128,
        map_capacity=512, grid_rows=H, grid_cols=W, lk_window=15, lk_levels=2, traj_cap=16,
        chunk_frames=4, **kw,
    )


def rebased_ate(pipe):
    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1: off + n] - gt[off])
    path = np.sum(np.linalg.norm(np.diff(gt[off: off + n], axis=0), axis=1))
    return float(np.sqrt(np.mean(np.sum(rel**2, axis=1)))), float(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' SegmentedPipeline on one corridor with each RANSAC
    seed; the JAX runs also hand out the segment histories they stitch."""
    seq = synthetic.make_sequence(n_frames=FRAMES, shape=(H, W), density=200, seed=3)
    paths = synthetic.write_kitti_layout(seq, tmp_path_factory.mktemp("kitti"))
    out = {"ours": [], "theirs": [], "hist": []}
    got = []
    device_get = jax.device_get

    def recording(x):
        v = device_get(x)
        got.append(np.asarray(v))
        return v

    for seed in SEEDS:
        pipe = SegmentedPipeline(VOConfig(**settings(paths, seed=seed)), segments=SEGMENTS, device="cpu")
        pipe.run()
        out["ours"].append(pipe)
        ref = JSegmentedPipeline(JVOConfig(**settings(paths, seed=seed)), segments=SEGMENTS)
        got.clear()
        jax.device_get = recording
        try:
            ref.run()
        finally:
            jax.device_get = device_get
        out["theirs"].append(ref)
        out["hist"].append(tuple(got[:2]))  # R_hist, t_hist of every segment
    return out


class TestSegmentedPipeline:
    def test_stitch_matches_the_jax_package(self, runs):
        """``stitch_segments`` on the JAX run's own segment histories gives
        the trajectory the JAX package stitched from them, to 1e-12."""
        for ref, (R_hist, t_hist) in zip(runs["theirs"], runs["hist"]):
            assert R_hist.shape[:2] == t_hist.shape[:2] and R_hist.shape[0] == SEGMENTS
            L = (len(ref.t) - 1) // SEGMENTS
            R, t = stitch_segments(R_hist, t_hist, L)
            assert len(R) == len(t) == len(ref.t)
            np.testing.assert_allclose(np.stack(R), np.stack(ref.R), rtol=0, atol=1e-12)
            np.testing.assert_allclose(np.stack(t), np.stack(ref.t), rtol=0, atol=1e-12)

    def test_same_bookkeeping(self, runs):
        """Same init frame, segment length, poses, BA calls; only segment
        0's table and map are kept; per-segment statistics."""
        for ours, ref in zip(runs["ours"], runs["theirs"]):
            assert ours.init_offset == ref.init_offset
            assert len(ours.t) == len(ref.t) == 1 + SEGMENTS * ours.segment_length
            assert ours._ba_calls == ref._ba_calls >= SEGMENTS
            assert len(ours.tables) == len(ref.tables) == 2
            assert len(ours.segment_stats) == SEGMENTS
            assert all(len(s) == ours.segment_length for s in ours.segment_stats)
            assert ours.frame_stats == [s for seg in ours.segment_stats for s in seg]
            # each segment bootstraps its own map first
            assert all(not seg[0]["used_pnp"] for seg in ours.segment_stats)
            assert int(ours.map.alive.sum()) > 0
            assert np.isfinite(np.stack(ours.t)).all() and np.isfinite(np.stack(ours.R)).all()

    def test_same_accuracy_class(self, runs):
        """Over the RANSAC seeds, every run of both packages ends with a
        rebased ATE under 10 % of the path (the LK bar of this size)."""
        for ours, ref in zip(runs["ours"], runs["theirs"]):
            for pipe in (ours, ref):
                ate, path = rebased_ate(pipe)
                assert ate < 0.10 * path, (type(pipe).__module__, ate, path)

    def test_seeds_give_their_own_draws(self, runs):
        """Segment generators come from (seed, segment): two seeds draw
        differently, one seed the same twice."""
        a = [g.get_state() for g in segment_generators(0, SEGMENTS, "cpu")]
        b = [g.get_state() for g in segment_generators(0, SEGMENTS, "cpu")]
        c = [g.get_state() for g in segment_generators(1, SEGMENTS, "cpu")]
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not any(torch.equal(x, y) for x, y in zip(a, c))
        assert not torch.equal(a[0], a[1])


# --------------------------------------------------------------------------
# multi_seq: the batched chunk step
# --------------------------------------------------------------------------

CFG = dict(
    lk_levels=2, lk_window=15, lk_iters=6, tile_h=H, tile_w=W, n_per_tile=64, tracked_tol=48,
    reseed_tol=70, e_hypos=64, pnp_hypos=64, pnp_thresh=3.0, bundle_size=3, ba_iters=3, traj_cap=16,
)
B, C, N, M = 3, 4, 128, 512


@pytest.fixture(scope="module")
def sequences():
    """B corridors (one per data seed): first frame and the next 2C."""
    return [synthetic.make_sequence(n_frames=2 * C + 1, shape=(H, W), density=200, seed=s)
            for s in range(B)]


def port_state(img0, cfg):
    img = torch.from_numpy(img0).float()
    xy, sc, va = corners.grid_extract(img, cfg.n_per_tile, tile_h=H, tile_w=W)
    txy, tsc, tva = corners.select_top(xy, sc, va, N)
    table = FeatureTable(xy=txy, valid=tva, landmark=torch.full((N,), -1, dtype=torch.int32), score=tsc)
    return fused.init_state(build_pyramid(img, cfg.lk_levels), table, MapState.empty(M), cfg)


def clone(state):
    return convert.state_from_reference(convert.state_to_numpy(state), "cpu")


class TestMultiSeq:
    def test_batched_equals_solo(self, sequences):
        """Two chunks of the batched step on B states equal B solo
        ``chunk_step`` runs bit for bit: every tensor of every state, the
        statistics and the generators."""
        cfg = fused.StepConfig(**CFG)
        states = [port_state(s["images"][0], cfg) for s in sequences]
        K = torch.from_numpy(np.asarray(sequences[0]["K"], np.float32))
        imgs = torch.from_numpy(np.stack([s["images"][1:] for s in sequences]).astype(np.uint8))
        gts = np.stack([np.linalg.norm(np.diff(s["gt_t"], axis=0), axis=1) for s in sequences])
        gens = segment_generators(0, B, "cpu")
        solo_gens = [torch.Generator().set_state(g.get_state()) for g in gens]

        batched = multi_seq.batch_states([clone(s) for s in states])
        step = multi_seq.make_batched_chunk_step(None, cfg, device="cpu")
        stats = [[] for _ in range(B)]
        for c0 in (0, C):
            batched, st = step(batched, imgs[:, c0: c0 + C], gts[:, c0: c0 + C].tolist(), gens, K)
            for b in range(B):
                stats[b] += st[b]
        assert batched.k == 2 * C
        for b in range(B):
            solo, solo_stats = states[b], []
            for c0 in (0, C):
                solo, st = fused.chunk_step(solo, imgs[b, c0: c0 + C], gts[b, c0: c0 + C].tolist(),
                                            solo_gens[b], K, cfg)
                solo_stats += st
            got = convert.state_to_numpy(multi_seq.state_at(batched, b))
            want = convert.state_to_numpy(solo)
            for k in want:
                assert np.array_equal(got[k], want[k]), (b, k)
            assert [(s["tracked"], s["n3d"], s["reseed"]) for s in stats[b]] == \
                [(s["tracked"], s["n3d"], s["reseed"]) for s in solo_stats]
            assert torch.equal(gens[b].get_state(), solo_gens[b].get_state())
        # the segments did different work (other data, other draws)
        assert not np.array_equal(batched.t_hist[0].numpy(), batched.t_hist[1].numpy())

    def test_batch_of_jax_states_converts(self, sequences):
        """A batch of JAX states (``pmv_tpu``'s ``batch_states``) carried
        across state by state with ``convert.batch_item`` and batched again
        by the port holds every array bit for bit."""
        jcfg = j_fused.StepConfig(lk_impl="tap", **CFG)
        jstates = []
        for s in sequences:
            img0 = jnp.asarray(s["images"][0])
            xy, sc, va = j_corners.grid_extract(img0, CFG["n_per_tile"], tile_h=H, tile_w=W)
            txy, tsc, tva = j_corners.select_top(xy, sc, va, N)
            table = JFeatureTable(xy=txy, valid=tva, landmark=jnp.full((N,), -1, jnp.int32), score=tsc)
            jstates.append(j_fused.init_state(tuple(j_build_pyramid(img0, CFG["lk_levels"])), table,
                                              JMapState.empty(M), jcfg))
        jb = j_multi_seq.batch_states(jstates)
        flat = {}
        for lvl, (region, r0, c0) in enumerate(jb.blocks):
            flat.update({f"blocks.{lvl}.region": np.asarray(region),
                         f"blocks.{lvl}.r0": np.asarray(r0), f"blocks.{lvl}.c0": np.asarray(c0)})
        for f in ("xy", "valid", "landmark", "score"):
            flat[f"table.{f}"] = np.asarray(getattr(jb.table, f))
        for f in ("xyz", "alive", "head"):
            flat[f"map.{f}"] = np.asarray(getattr(jb.map, f))
        for f in convert.STATE_FIELDS + ("k",):
            flat[f] = np.asarray(getattr(jb, f))
        ours = multi_seq.batch_states(
            [convert.state_from_reference(convert.batch_item(flat, b), "cpu") for b in range(B)])
        back = convert.state_to_numpy(ours)
        for k, v in flat.items():
            if k == "k":
                assert back[k] == 0 and (v == 0).all()
            else:
                assert back[k].shape == v.shape and np.array_equal(back[k], v), k


@pytest.mark.parametrize("call", ["make_batched_chunk_step", "SegmentedPipeline"])
def test_gpu_by_default_and_no_mesh(call, tmp_path):
    """A mesh argument that is not a ``parallel.mesh.Mesh`` is refused; no
    device means the GPU, an error without one."""
    cfg = fused.StepConfig(**CFG)
    if call == "make_batched_chunk_step":
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            multi_seq.make_batched_chunk_step(object(), cfg, device="cpu")
        make = lambda: multi_seq.make_batched_chunk_step(None, cfg)  # noqa: E731
    else:
        seq = synthetic.make_sequence(n_frames=3, shape=(48, 64), density=5)
        paths = synthetic.write_kitti_layout(seq, tmp_path)
        make = lambda: SegmentedPipeline(VOConfig(**settings(paths)), segments=2)  # noqa: E731
    if torch.cuda.is_available():
        pytest.skip("the no-GPU check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
