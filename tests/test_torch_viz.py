"""The run's visuals, tracing and ingest in the port against the JAX
package: viz/ (maps, annotations, the live replay, point cloud, AVI) bit for
bit on the same numpy inputs, ``save_run_visuals`` and the landmark-snapshot
history of a run (as tests/test_pipeline.py holds the JAX package's), the
live map, utils/profiling.py, and the native frame decoder."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pmv_tpu.core.state import FeatureTable as JFeatureTable
from pmv_tpu.core.state import MapState as JMapState
from pmv_tpu.io import native as j_native
from pmv_tpu.io import png as j_png
from pmv_tpu.viz import pointcloud as j_pointcloud
from pmv_tpu.viz import render as j_render
from pmv_tpu.viz import video as j_video
from pmv_tpu_torch import cli
from pmv_tpu_torch.config import VOConfig
from pmv_tpu_torch.io import kitti, native, png, prefetch, synthetic
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline
from pmv_tpu_torch.utils import profiling
from pmv_tpu_torch.viz import pointcloud, render, video

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

SHAPE = (96, 160)
FRAMES = 16


def trajectory(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(size=(n, 3)) * [0.3, 0.05, 2.0], axis=0)
    yaw = np.cumsum(rng.normal(size=n) * 0.05)
    R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]] for a in yaw])
    return t, R


class TestDrawing:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_draw_map_and_live_replay_bit_for_bit(self, seed):
        t, R = trajectory(seed)
        gt_t, gt_R = trajectory(seed + 10, 16)
        rng = np.random.default_rng(seed)
        lms = rng.normal(size=(300, 3)) * [30, 2, 30]
        cols = rng.uniform(0, 1226, 300)
        for kw in ({}, {"landmarks": lms, "landmark_cols": cols, "R_est": list(R), "gt_R": gt_R}):
            a = render.draw_map(list(t), gt_t, 2, 2.5, **kw)
            b = j_render.draw_map(list(t), gt_t, 2, 2.5, **kw)
            assert a.dtype == np.uint8 and np.array_equal(a, b)
        pipe = SimpleNamespace(t=list(t), R=list(R), gt_t=gt_t, gt_R=gt_R, init_offset=2,
                               cfg=SimpleNamespace(map_scale=2.5))
        ours, theirs = render.LiveMapRenderer(pipe), j_render.LiveMapRenderer(pipe)
        for k in (0, 3, 4, 11, 30):
            sel = slice(k * 20, k * 20 + 40)
            a = ours.render(k, landmarks=lms[sel], landmark_cols=cols[sel])
            b = theirs.render(k, landmarks=lms[sel], landmark_cols=cols[sel])
            assert np.array_equal(a, b)

    def test_annotate_frame_and_skim(self):
        rng = np.random.default_rng(3)
        img = rng.uniform(-20, 280, SHAPE).astype(np.float32)
        xy = rng.uniform(-5, 165, (80, 2)).astype(np.float32)
        valid = rng.random(80) > 0.3
        assert np.array_equal(render.annotate_frame(img, xy, valid),
                              j_render.annotate_frame(img, xy, valid))
        pts = rng.standard_cauchy((500, 3)).astype(np.float32)
        assert np.array_equal(pointcloud.median_skim(pts), j_pointcloud.median_skim(pts))
        assert pointcloud.median_skim(pts[:0]).shape == (0, 3)

    def test_avi_and_ply_byte_equal(self, tmp_path):
        rng = np.random.default_rng(4)
        frames = [rng.integers(0, 256, (37, 53, 3), np.uint8) for _ in range(3)]
        frames.append(rng.uniform(0, 300, (37, 53)))  # grayscale float, clipped
        for mod, name in ((video, "a.avi"), (j_video, "b.avi")):
            w = mod.AVIWriter(tmp_path / name, fps=10)
            for f in frames:
                w.add(f)
            w.close()
        assert (tmp_path / "a.avi").read_bytes() == (tmp_path / "b.avi").read_bytes()
        w = video.AVIWriter(tmp_path / "c.avi")
        w.add(frames[0])
        with pytest.raises(ValueError):
            w.add(frames[0][:, :10])
        pts = rng.normal(size=(50, 3)) * 10
        colors = rng.integers(0, 256, (50, 3))
        for c in (None, colors):
            pointcloud.write_ply(tmp_path / "a.ply", pts, c)
            j_pointcloud.write_ply(tmp_path / "b.ply", pts, c)
            assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()


# --------------------------------------------------------------------------
# a run's visuals
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    seq = synthetic.make_sequence(n_frames=FRAMES, shape=SHAPE, density=200, seed=3)
    return synthetic.write_kitti_layout(seq, tmp_path_factory.mktemp("kitti"))


def make_cfg(paths, **kw):
    """A 96x160 corridor run (tests/test_torch_odometry.py's settings)."""
    return VOConfig(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], frames=FRAMES, init_frames=2, min_tracked_features=100,
        tracked_features_tol=48, bundle_size=4, max_iterations=3, feature_capacity=128,
        map_capacity=512, grid_rows=96, grid_cols=160, lk_window=15, lk_levels=2,
        traj_cap=32, chunk_frames=4, seed=0, **kw,
    )


@pytest.fixture(scope="module")
def video_run(paths, tmp_path_factory):
    out = tmp_path_factory.mktemp("video")
    cfg = make_cfg(paths, video_path=str(out / "ours.avi"), fancy_video=1,
                   error_path=str(out / "err.txt"))
    pipe = OdometryPipeline(cfg, device="cpu")
    pipe.run()
    return pipe, out


def as_jax_pipe(pipe, avi):
    """The port's finished run as the JAX package's ``save_run_visuals``
    reads it: the same trajectory, tables, map and snapshots as numpy."""
    tables = [JFeatureTable(*(getattr(tb, f).cpu().numpy() for f in tb._fields)) for tb in pipe.tables]
    cfg = SimpleNamespace(**{**vars(pipe.cfg), "video_path": str(avi)})
    return SimpleNamespace(
        cfg=cfg, t=pipe.t, R=pipe.R, gt_t=pipe.gt_t, gt_R=pipe.gt_R,
        init_offset=pipe.init_offset, file_names=pipe.file_names, tables=tables,
        map=JMapState(*(x.cpu().numpy() for x in pipe.map)),
        map_hist=pipe.map_hist, map_hist_cadence=pipe.map_hist_cadence,
    )


class TestRunVisuals:
    def test_save_run_visuals_equals_the_jax_package(self, video_run, tmp_path):
        """map.png, pointcloud.ply and the AVI of a port run, rendered by
        both packages' ``save_run_visuals`` from the same run: byte-equal.
        The AVI holds one frame per trajectory pose."""
        pipe, out = video_run
        ours = render.save_run_visuals(pipe, out)
        theirs = j_render.save_run_visuals(as_jax_pipe(pipe, tmp_path / "theirs.avi"), tmp_path)
        assert ours["pointcloud_points"] == theirs["pointcloud_points"] > 0
        for name in ("map.png", "pointcloud.ply"):
            assert (out / name).read_bytes() == (tmp_path / name).read_bytes(), name
        avi = (out / "ours.avi").read_bytes()
        assert avi == (tmp_path / "theirs.avi").read_bytes()
        n_frames = int.from_bytes(avi[48:52], "little")  # avih dwTotalFrames
        assert n_frames == len(pipe.t)
        assert png.load_grayscale(out / "map.png").shape == (511, 511)

    def test_mid_run_snapshot_differs_from_final(self, video_run):
        """The landmark snapshots (tests/test_pipeline.py holds the JAX
        package's to the same): the last written row is the final map
        exactly, and a mid-run frame's then-current positions differ from
        the final ones for some of its live landmarks."""
        pipe, _ = video_run
        hist, cad = pipe.map_hist, pipe.map_hist_cadence
        assert hist is not None and hist.shape == (32 // cad + 2, 512, 3)
        final = pipe.map.xyz.cpu().numpy()
        alive = pipe.map.alive.cpu().numpy()
        k_last = len(pipe.t) - 1
        np.testing.assert_array_equal(hist[min(k_last // cad, len(hist) - 1)], final)
        k_mid = k_last // 2
        tbl = pipe.tables[k_mid]
        lm = tbl.landmark.numpy()
        bound = tbl.valid.numpy() & (lm >= 0)
        bound[bound] &= alive[lm[bound]]
        ids = lm[bound]
        assert ids.size > 0
        then = hist[min(k_mid // cad, len(hist) - 1)][ids]
        assert np.abs(then - final[ids]).max() > 1e-6

    def test_live_map_written(self, paths, tmp_path):
        cfg = make_cfg(paths, live_every=5, error_path=str(tmp_path / "err.txt"))
        pipe = OdometryPipeline(cfg, device="cpu")
        pipe.run()
        assert png.load_grayscale(tmp_path / "map_live.png").shape == (511, 511)
        assert pipe.map_hist is None  # no video asked for: no read-back

    def test_map_hist_off(self, paths, tmp_path):
        cfg = make_cfg(paths, map_hist=0, video_path=str(tmp_path / "o.avi"))
        pipe = OdometryPipeline(cfg, device="cpu")
        pipe.run()
        assert pipe.map_hist is None  # disabled: no history, replay falls back
        render.save_run_visuals(pipe, tmp_path)
        assert (tmp_path / "o.avi").exists()

    def test_cli_trace_live_and_visuals(self, paths, tmp_path, capsys):
        """``run --trace DIR --live N`` with a video: a Chrome trace, the live
        map, the map, the point cloud and the AVI, exit code 0."""
        ini = tmp_path / "cfg.ini"
        settings = dict(
            map_scale=1, frames=8, init_frames=2, min_tracked_features=100,
            tracked_features_tol=48, bundle_size=4, max_iterations=3,
            feature_capacity=128, map_capacity=512, grid_rows=96, grid_cols=160,
            lk_window=15, lk_levels=2, traj_cap=32, chunk_frames=2,
            error_path=tmp_path / "err.txt", video_path=tmp_path / "run.avi",
            fancy_video=1, **paths,
        )
        ini.write_text("".join(f"{k} = {v}\n" for k, v in settings.items()))
        rc = cli.main(["run", str(ini), "--device", "cpu", "--trace", str(tmp_path / "tr"),
                       "--live", "2"])
        assert rc == 0 and "poses" in capsys.readouterr().out
        for name in ("map_live.png", "map.png", "pointcloud.ply", "run.avi", "tr/trace.json"):
            assert (tmp_path / name).stat().st_size > 0, name


# --------------------------------------------------------------------------
# profiling, ingest
# --------------------------------------------------------------------------


class TestProfiling:
    def test_stopwatch_stack_order(self, monkeypatch):
        clock = iter([1.0, 2.0, 7.0, 10.0])
        monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
        w = profiling.Stopwatch("cpu")
        w.tick()  # 1
        w.tick()  # 2
        assert w.tock() == 5.0  # inner: 7 - 2
        assert w.tock() == 9.0  # outer: 10 - 1
        assert w.tock() == 0.0  # empty stack, as the reference's

    def test_trace(self, tmp_path):
        with profiling.trace(None):
            pass
        assert list(tmp_path.iterdir()) == []
        with profiling.trace(tmp_path / "t", "cpu"):
            torch.ones(64).cumsum(0)
        text = (tmp_path / "t" / profiling.TRACE_FILE).read_text()
        assert "traceEvents" in text and "cumsum" in text


@pytest.fixture(scope="module")
def native_lib():
    if not native.available():
        pytest.skip("native frame loader does not load here (native/libframe_loader.so)")


class TestNativeDecoder:
    def test_matches_python_codec(self, native_lib, tmp_path):
        rng = np.random.default_rng(0)
        gray = rng.integers(0, 256, (37, 53), np.uint8)
        rgb = rng.integers(0, 256, (21, 33, 3), np.uint8)
        png.write_png(tmp_path / "g.png", gray)
        j_png.write_png(tmp_path / "c.png", rgb)
        np.testing.assert_allclose(native.load_grayscale(tmp_path / "g.png"),
                                   png.load_grayscale(tmp_path / "g.png"), atol=1e-4)
        # RGB -> gray: float against float rounding, as tests/test_native.py
        np.testing.assert_allclose(native.load_grayscale(tmp_path / "c.png"),
                                   png.load_grayscale(tmp_path / "c.png"), atol=0.51)
        assert np.array_equal(native.load_grayscale(tmp_path / "g.png"),
                              j_native.load_grayscale(tmp_path / "g.png"))
        (tmp_path / "bad.png").write_bytes(b"not a png")
        with pytest.raises(ValueError):
            native.load_grayscale(tmp_path / "bad.png")

    def test_prefetcher_takes_it(self, native_lib, paths):
        assert prefetch.decoder() == "native"
        files = kitti.list_images(paths["image_dir"])[:4]
        for (_, a), f in zip(prefetch.FramePrefetcher(files), files):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, png.load_grayscale(f), atol=1e-4)
