"""utils/checkpoint.py of the port against the JAX package's format, and
checkpoint/resume of ``OdometryPipeline.run()`` on the CPU: a run interrupted
and resumed from its snapshot equals the uninterrupted run bit for bit
(mirroring tests/test_checkpoint.py)."""

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
from pmv_tpu.utils import checkpoint as j_checkpoint
from pmv_tpu_torch import convert
from pmv_tpu_torch.config import VOConfig
from pmv_tpu_torch.io import synthetic
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline
from pmv_tpu_torch.utils import checkpoint

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

FRAMES = 14


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    seq = synthetic.make_sequence(n_frames=FRAMES, shape=(96, 160), density=40, seed=3)
    return synthetic.write_kitti_layout(seq, tmp_path_factory.mktemp("kitti"))


def make_pipe(paths, frames=10, **overrides):
    """tests/test_checkpoint.py's configuration."""
    cfg = VOConfig(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], frames=frames, init_frames=2, min_tracked_features=150,
        tracked_features_tol=60, bundle_size=4, max_iterations=3,
        feature_capacity=256, map_capacity=1024, grid_rows=96, grid_cols=160,
        lk_window=15, traj_cap=64, **overrides,
    )
    return OdometryPipeline(cfg, device="cpu")


def leaves(state) -> dict:
    """Every tensor of a StepState by a flat name, and ``k``."""
    out = {"k": state.k}
    for lvl, parts in enumerate(state.blocks):
        for j, part in enumerate(parts):
            out[f"blocks.{lvl}.{j}"] = part
    for f in state.table._fields:
        out[f"table.{f}"] = getattr(state.table, f)
    for f in state.map._fields:
        out[f"map.{f}"] = getattr(state.map, f)
    for f in convert.STATE_FIELDS:
        out[f] = getattr(state, f)
    return out


def assert_same_state(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for name, x in la.items():
        y = lb[name]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x, y), name
        else:
            assert x == y, name


class TestFusedSnapshot:
    def test_step_state_round_trip_bitwise(self, paths, tmp_path):
        """save_fused_state/load_fused_state keep every StepState tensor and
        its dtype bit for bit, the block tuples' structure, k, map_hist, and
        the generator's state."""
        ck = tmp_path / "fused.npz"
        pipe = make_pipe(paths, frames=6, checkpoint_path=str(ck))
        pipe.run()  # the final snapshot
        gen = torch.Generator()
        state, meta = checkpoint.load_fused_state(ck, "cpu", generator=gen)
        assert meta == {}
        assert torch.equal(gen.get_state(), pipe._gen.get_state())
        assert state.k == len(pipe.t) - 1
        assert state.map_hist.shape == (64 // 2 + 2, 1024, 3) and bool(state.map_hist.any())
        ck2 = tmp_path / "fused2.npz"
        checkpoint.save_fused_state(state, ck2, generator=gen, note="x")
        gen2 = torch.Generator().manual_seed(99)
        state2, meta2 = checkpoint.load_fused_state(ck2, "cpu", generator=gen2)
        assert str(meta2["note"]) == "x"
        assert torch.equal(gen2.get_state(), gen.get_state())
        assert_same_state(state, state2)
        assert torch.equal(state.tbl_xy_hist[state.k], pipe.tables[-1].xy)

    def test_jax_package_reads_the_snapshot(self, paths, tmp_path):
        """Same keys and version: ``pmv_tpu.utils.checkpoint`` loads the
        port's snapshot to the same arrays."""
        ck = tmp_path / "fused.npz"
        make_pipe(paths, frames=5, checkpoint_path=str(ck)).run()
        state, _ = checkpoint.load_fused_state(ck, "cpu")
        jstate, _ = j_checkpoint.load_fused_state(ck)
        ours = convert.state_to_numpy(state)
        for lvl, (region, r0, c0) in enumerate(jstate.blocks):
            assert np.array_equal(ours[f"blocks.{lvl}.region"], np.asarray(region))
            assert np.array_equal(ours[f"blocks.{lvl}.r0"], np.asarray(r0))
        for f in ("xy", "valid", "landmark", "score"):
            assert np.array_equal(ours[f"table.{f}"], np.asarray(getattr(jstate.table, f)))
        for f in convert.STATE_FIELDS:
            assert np.array_equal(ours[f], np.asarray(getattr(jstate, f))), f
        assert int(jstate.k) == state.k

    @pytest.mark.parametrize("matcher", ["lk", "knn"])
    def test_jax_snapshot_loads_as_convert_gives_it(self, tmp_path, matcher):
        """An npz written by ``pmv_tpu.utils.checkpoint.save_fused_state``
        loads into the state ``convert.state_from_reference`` gives for the
        same JAX state (LK blocks feature-major; kNN's previous image), bit
        for bit; it carries no generator state, so a generator passed in is
        left as it was."""
        H, W, N, M = 64, 96, 64, 256
        seq = j_synthetic.make_sequence(n_frames=2, shape=(H, W), density=60, seed=1)
        cfg = j_fused.StepConfig(lk_impl="tap", lk_levels=1, lk_window=9, tile_h=H, tile_w=W,
                                 traj_cap=8, map_hist_rows=6, matcher=matcher)
        img0 = jnp.asarray(seq["images"][0])
        xy, sc, va = j_corners.grid_extract(img0, 40, tile_h=H, tile_w=W)
        txy, tsc, tva = j_corners.select_top(xy, sc, va, N)
        table = JFeatureTable(xy=txy, valid=tva, landmark=jnp.full((N,), -1, jnp.int32), score=tsc)
        s = j_fused.init_state(tuple(j_build_pyramid(img0, cfg.lk_levels)), table,
                               JMapState.empty(M), cfg)
        # make every field carry values of its own
        rng = np.random.default_rng(0)
        s = s._replace(
            map=JMapState(jnp.asarray(rng.normal(size=(M, 3)).astype(np.float32)),
                          jnp.asarray(rng.random(M) > 0.5), jnp.int32(17)),
            R_hist=jnp.asarray(rng.normal(size=(8, 3, 3)).astype(np.float32)),
            map_hist=jnp.asarray(rng.normal(size=(6, M, 3)).astype(np.float32)),
            tbl_lm_hist=jnp.asarray(rng.integers(-1, M, (8, N)).astype(np.int32)),
            k=jnp.int32(3), scale=jnp.float32(1.7), ba_overflow=jnp.int32(2),
        )
        ck = tmp_path / "jax.npz"
        j_checkpoint.save_fused_state(s, ck)
        gen = torch.Generator().manual_seed(5)
        before = gen.get_state()
        got, _ = checkpoint.load_fused_state(ck, "cpu", generator=gen)
        assert torch.equal(gen.get_state(), before)
        flat = {}
        if matcher == "knn":
            flat["blocks.0.image"] = np.asarray(s.blocks[0][0])
        else:
            for lvl, (region, r0, c0) in enumerate(s.blocks):
                flat.update({f"blocks.{lvl}.region": np.asarray(region),
                             f"blocks.{lvl}.r0": np.asarray(r0), f"blocks.{lvl}.c0": np.asarray(c0)})
        for f in ("xy", "valid", "landmark", "score"):
            flat[f"table.{f}"] = np.asarray(getattr(s.table, f))
        for f in ("xyz", "alive", "head"):
            flat[f"map.{f}"] = np.asarray(getattr(s.map, f))
        for f in convert.STATE_FIELDS + ("k",):
            flat[f] = np.asarray(getattr(s, f))
        assert_same_state(got, convert.state_from_reference(flat, "cpu"))
        assert got.k == 3 and got.map_hist.shape == (6, M, 3)

    def test_wrong_version_is_refused(self, tmp_path):
        ck = tmp_path / "old.npz"
        np.savez(ck, fused_version=2)
        with pytest.raises(ValueError, match="version"):
            checkpoint.load_fused_state(ck, "cpu")


class TestModularSnapshot:
    def test_roundtrip(self, paths, tmp_path):
        """save(pipe)/load(pipe) of the modular loop: trajectory, map, tables,
        error metrics and the generator come back (tests/test_checkpoint.py
        holds the JAX package's to the same)."""
        pipe = make_pipe(paths, frames=6)
        pipe.run_modular()
        ck = tmp_path / "state.npz"
        checkpoint.save(pipe, ck)
        pipe2 = make_pipe(paths, frames=6)
        checkpoint.load(pipe2, ck)
        assert pipe2.init_offset == pipe.init_offset
        assert len(pipe2.t) == len(pipe.t) and len(pipe2.tables) == len(pipe.tables)
        assert np.array_equal(np.stack(pipe2.t), np.stack(pipe.t))
        assert np.array_equal(np.stack(pipe2.R_s), np.stack(pipe.R_s))
        assert torch.equal(pipe2.map.xyz, pipe.map.xyz) and torch.equal(pipe2.map.alive, pipe.map.alive)
        assert int(pipe2.map.head) == int(pipe.map.head)
        for a, b in zip(pipe2.tables, pipe.tables):
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(pipe2._gen.get_state(), pipe._gen.get_state())
        assert pipe2.scale == pipe.scale and pipe2.runtime == pipe.runtime
        pipe2._compute_errors()
        pipe._compute_errors()
        assert pipe2.errors_t == pipe.errors_t


class TestResume:
    def test_resume_bit_identical_to_uninterrupted(self, paths, tmp_path):
        """A run interrupted at frame 8 (a snapshot every frame, chunks of 2)
        and resumed to 14 equals the uninterrupted run bit for bit: the
        trajectory, the map, the last table, t_total, and where the RANSAC
        generator ends."""
        full = make_pipe(paths, frames=FRAMES, chunk_frames=2)
        res_full = full.run()

        ck = tmp_path / "mid.npz"
        part = make_pipe(paths, frames=8, chunk_frames=2, checkpoint_path=str(ck),
                         checkpoint_every=1)
        part.run()
        assert ck.exists() and not (tmp_path / "mid.npz.tmp.npz").exists()
        k_mid = checkpoint.load_fused_state(ck, "cpu")[0].k
        assert 0 < k_mid < len(full.t) - 1

        resumed = make_pipe(paths, frames=FRAMES, chunk_frames=2, checkpoint_path=str(ck),
                            resume=1)
        res_resumed = resumed.run()
        assert len(resumed.frame_stats) == len(full.t) - 1 - k_mid  # only the frames left
        assert res_resumed["frames"] == res_full["frames"]
        assert np.array_equal(np.stack(resumed.t), np.stack(full.t))
        assert np.array_equal(np.stack(resumed.R), np.stack(full.R))
        assert torch.equal(resumed.map.xyz, full.map.xyz)
        assert torch.equal(resumed.tables[-1].xy, full.tables[-1].xy)
        assert res_resumed["t_total"] == res_full["t_total"]
        assert torch.equal(resumed._gen.get_state(), full._gen.get_state())
        # the resumed run wrote its own final snapshot
        assert checkpoint.load_fused_state(ck, "cpu")[0].k == len(full.t) - 1

    def test_resume_without_a_snapshot_starts_fresh(self, paths, tmp_path):
        ck = tmp_path / "none.npz"
        a = make_pipe(paths, frames=6, checkpoint_path=str(ck), resume=1)
        a.run()
        b = make_pipe(paths, frames=6)
        b.run()
        assert np.array_equal(np.stack(a.t), np.stack(b.t))
        assert ck.exists()



def _with_card_generator_state(src, dst):
    """A copy of the snapshot ``src`` whose ``rng_state`` is 16 bytes, the
    size of a CUDA generator's state (seed and offset)."""
    z = dict(np.load(src))
    z["rng_state"] = np.arange(16, dtype=np.uint8)
    np.savez_compressed(dst, **z)


class TestCardSnapshotOnTheCpu:
    def test_fused_snapshot_resumes(self, paths, tmp_path, capsys):
        """A run's snapshot with a card's 16-byte generator state resumes on
        the CPU: the state loads, the generator is left where the caller's
        seed put it (and the message says so), and the run goes on to the
        end with finite poses and the frames the uninterrupted run tracks."""
        ck, card = tmp_path / "mid.npz", tmp_path / "card.npz"
        make_pipe(paths, frames=8, chunk_frames=2, checkpoint_path=str(ck)).run()
        _with_card_generator_state(ck, card)
        gen = torch.Generator().manual_seed(3)
        before = gen.get_state()
        state, _ = checkpoint.load_fused_state(card, "cpu", generator=gen)
        assert torch.equal(gen.get_state(), before)
        assert "does not fit" in capsys.readouterr().out
        assert_same_state(state, checkpoint.load_fused_state(ck, "cpu")[0])

        full = make_pipe(paths, frames=FRAMES, chunk_frames=2)
        full.run()
        resumed = make_pipe(paths, frames=FRAMES, chunk_frames=2, checkpoint_path=str(card),
                            resume=1)
        resumed.run()
        assert len(resumed.t) == len(full.t)
        assert len(resumed.frame_stats) == len(full.t) - 1 - state.k
        assert np.isfinite(np.stack(resumed.t)).all() and np.isfinite(np.stack(resumed.R)).all()
        assert np.array_equal(np.stack(resumed.t)[: state.k + 1], np.stack(full.t)[: state.k + 1])

    def test_modular_snapshot_loads(self, paths, tmp_path):
        """``checkpoint.load`` of a modular snapshot with a 16-byte generator
        state: everything else comes back, the generator stays as it was."""
        pipe = make_pipe(paths, frames=6)
        pipe.run_modular()
        ck, card = tmp_path / "state.npz", tmp_path / "card.npz"
        checkpoint.save(pipe, ck)
        _with_card_generator_state(ck, card)
        pipe2 = make_pipe(paths, frames=6)
        before = pipe2._gen.get_state()
        checkpoint.load(pipe2, card)
        assert torch.equal(pipe2._gen.get_state(), before)
        assert np.array_equal(np.stack(pipe2.t), np.stack(pipe.t))
        assert torch.equal(pipe2.map.xyz, pipe.map.xyz)
        assert len(pipe2.tables) == len(pipe.tables)
