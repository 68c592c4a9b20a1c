"""The port's entry points against the JAX package: the copied config and io
modules, the error file, and a short corridor through both
``OdometryPipeline.run()``s.

The tracker is chaotic and the two packages draw different RANSAC samples
(``jax.random`` cannot be reproduced in torch), so the end-to-end runs are
held to the same accuracy class, not to each other's poses; the frame-level
parity with injected draws is in tests/test_torch_pipeline.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pmv_tpu import config as j_config
from pmv_tpu.io import kitti as j_kitti
from pmv_tpu.io import png as j_png
from pmv_tpu.io import synthetic as j_synthetic
from pmv_tpu.pipeline.odometry import OdometryPipeline as JOdometryPipeline
from pmv_tpu_torch import cli, config
from pmv_tpu_torch.io import kitti, png, synthetic
from pmv_tpu_torch.io.prefetch import FramePrefetcher
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

SHAPE = (96, 160)
FRAMES = 16
RUN_CFG = dict(
    frames=FRAMES, init_frames=2, min_tracked_features=100, tracked_features_tol=48,
    bundle_size=4, max_iterations=3, feature_capacity=128, map_capacity=512,
    grid_rows=96, grid_cols=160, lk_window=15, lk_levels=2, traj_cap=32,
    chunk_frames=4, seed=0,
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    seq = j_synthetic.make_sequence(n_frames=FRAMES, shape=SHAPE, density=200, seed=3)
    paths = j_synthetic.write_kitti_layout(seq, tmp_path_factory.mktemp("kitti"))
    return seq, paths


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


class TestCopiedModules:
    def test_config_fields_and_defaults(self):
        ours = {f.name: f.default for f in dataclasses.fields(config.VOConfig)}
        theirs = {f.name: f.default for f in dataclasses.fields(j_config.VOConfig)}
        assert ours == theirs

    def test_from_ini(self, tmp_path, dataset):
        _, paths = dataset
        ini = tmp_path / "cfg.ini"
        ini.write_text(
            "map_scale = 1\nframes = 12\nbundle_size = 7\nlk_window = 15\n"
            "ransac_pnp_thresh = 4.5\n# a comment\n"
            + "".join(f"{k} = {v}\n" for k, v in paths.items())
        )
        ours = dataclasses.asdict(config.VOConfig.from_ini(ini))
        theirs = dataclasses.asdict(j_config.VOConfig.from_ini(ini))
        assert ours == theirs
        assert config.VOConfig.from_ini(ini).extractor_preset() == \
            j_config.VOConfig.from_ini(ini).extractor_preset()
        with pytest.raises(config.OdometryPipelineException):
            config.VOConfig.from_ini(tmp_path / "missing.ini")

    def test_synthetic_sequence_is_the_same_data(self):
        kw = dict(n_frames=3, shape=(64, 96), density=30, speed=0.8, yaw_rate=0.003, seed=5)
        ours, theirs = synthetic.make_sequence(**kw), j_synthetic.make_sequence(**kw)
        assert ours.keys() == theirs.keys()
        for k in theirs:
            assert np.array_equal(np.asarray(ours[k]), np.asarray(theirs[k])), k
        assert np.array_equal(synthetic.KITTI_K, j_synthetic.KITTI_K)

    def test_png_and_kitti_readers(self, tmp_path, dataset):
        seq, paths = dataset
        img = seq["images"][0].astype(np.uint8)
        png.write_png(tmp_path / "a.png", img)
        j_png.write_png(tmp_path / "b.png", img)
        assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
        assert np.array_equal(png.load_grayscale(tmp_path / "b.png"), img)
        assert kitti.list_images(paths["image_dir"]) == j_kitti.list_images(paths["image_dir"])
        assert np.array_equal(
            kitti.parse_calibration(paths["camera_calibration"], 0),
            j_kitti.parse_calibration(paths["camera_calibration"], 0),
        )
        for a, b in zip(kitti.parse_poses(paths["poses"], stop=9), j_kitti.parse_poses(paths["poses"], stop=9)):
            assert np.array_equal(a, b)

    def test_prefetcher_yields_frames_in_order(self, dataset):
        seq, paths = dataset
        files = kitti.list_images(paths["image_dir"])[:5]
        got = list(FramePrefetcher(files))
        assert len(got) == 5
        for (_, img), want in zip(got, seq["images"]):
            assert np.array_equal(img, want.astype(np.uint8))


class TestErrorFile:
    def test_byte_identical_for_the_same_trajectory(self, tmp_path, dataset):
        """The same trajectory, init offset and runtime through both
        packages' ``_compute_errors`` / ``write_error_file`` (bug-compatible
        with the reference: R is compared with gt_R[i], not
        gt_R[i + init_offset])."""
        _, paths = dataset
        ours = OdometryPipeline(_cfg(config, paths), device="cpu")
        theirs = JOdometryPipeline(_cfg(j_config, paths))
        rng = np.random.default_rng(0)
        n = 9
        t = np.cumsum(rng.normal(size=(n, 3)) * [0.05, 0.05, 1.0], axis=0)
        R = np.stack([np.eye(3) + rng.normal(size=(3, 3)) * 0.01 for _ in range(n)])
        for pipe in (ours, theirs):
            pipe.t, pipe.R = list(t), list(R)
            pipe.init_offset = 1
            pipe.runtime = 1.2345678
            pipe._compute_errors()
        assert ours.errors_t == theirs.errors_t and ours.errors_R == theirs.errors_R
        ours.write_error_file(tmp_path / "ours.txt")
        theirs.write_error_file(tmp_path / "theirs.txt")
        text = (tmp_path / "ours.txt").read_bytes()
        assert text == (tmp_path / "theirs.txt").read_bytes()
        assert text.startswith(b"Runtime: 1.23457\nR total: ")
        assert OdometryPipeline._std([1.0]) == 0.0
        assert OdometryPipeline._std([1.0, 3.0]) == JOdometryPipeline._std([1.0, 3.0])


class TestRun:
    @pytest.fixture(scope="class")
    def runs(self, dataset, tmp_path_factory):
        _, paths = dataset
        out = tmp_path_factory.mktemp("run")
        ours = OdometryPipeline(_cfg(config, paths, error_path=str(out / "ours.txt")), device="cpu")
        r_ours = ours.run()
        theirs = JOdometryPipeline(_cfg(j_config, paths, lk_impl="tap"))
        r_theirs = theirs.run()
        return ours, r_ours, theirs, r_theirs, out

    def test_same_initialisation(self, runs):
        """Frame selection and the seeded feature table are deterministic:
        same init frame, same corners in the same slots."""
        ours, _, theirs, _, _ = runs
        assert ours.init_offset == theirs.init_offset
        v, rv = ours.tables[0].valid.numpy(), np.asarray(theirs.tables[0].valid)
        assert np.array_equal(v, rv)
        assert np.array_equal(ours.tables[0].xy.numpy()[v], np.asarray(theirs.tables[0].xy)[rv])

    def test_same_bookkeeping(self, runs):
        ours, r_ours, theirs, r_theirs, _ = runs
        assert r_ours["frames"] == r_theirs["frames"] == len(ours.t) == len(ours.tables)
        assert r_ours["ba_calls"] == r_theirs["ba_calls"] >= 1
        stats = ours.frame_stats
        assert len(stats) == r_ours["frames"] - 1
        assert not stats[0]["used_pnp"] and any(s["used_pnp"] for s in stats)
        assert all(isinstance(s["inliers"], int) and isinstance(s["accepted"], bool) for s in stats)

    def test_same_accuracy_class(self, runs):
        """Both runs end with a rebased ATE under 10 % of the 14 m path
        (draws differ, so the poses themselves are not compared). At this toy
        size (96x160, focal length 96 px) both packages measure 0.75-1.13 m
        over RANSAC seeds 0-3; the full-size run on a GPU is held to 5 % by
        chip_smoke.py."""
        ours, _, theirs, _, _ = runs
        for pipe in (ours, theirs):
            ate, path = _rebased_ate(pipe)
            assert np.isfinite(np.stack(pipe.t)).all()
            assert ate < 0.10 * path, (type(pipe).__module__, ate, path)

    def test_error_file_written(self, runs):
        ours, r_ours, _, _, out = runs
        lines = (out / "ours.txt").read_text().splitlines()
        assert [l.split(":")[0] for l in lines] == [
            "Runtime", "R total", "R min", "R max", "R std",
            "t total", "t min", "t max", "t std",
        ]
        assert float(lines[5].split(":")[1]) == pytest.approx(r_ours["t_total"], rel=1e-5)

    def test_run_is_repeatable_from_the_seed(self, dataset, runs):
        _, paths = dataset
        ours = runs[0]
        again = OdometryPipeline(_cfg(config, paths), device="cpu")
        again.run()
        assert np.array_equal(np.stack(again.t), np.stack(ours.t))

    def test_traj_cap_overflow_fails_loudly(self, dataset):
        _, paths = dataset
        pipe = OdometryPipeline(_cfg(config, paths, traj_cap=FRAMES), device="cpu")
        with pytest.raises(config.OdometryPipelineException, match="traj_cap"):
            pipe.run()


class TestCli:
    def test_synth_then_run_on_the_cpu(self, tmp_path, capsys):
        assert cli.main(["synth", str(tmp_path / "d"), "--frames", "6", "--height", "64",
                         "--width", "96", "--density", "60"]) == 0
        paths = dict(
            line.split(" = ") for line in capsys.readouterr().out.strip().splitlines()
        )
        assert len(kitti.list_images(paths["image_dir"])) == 6
        ini = tmp_path / "cfg.ini"
        err = tmp_path / "errors.txt"
        ini.write_text(
            "map_scale = 1\nframes = 6\ninit_frames = 2\nfeature_capacity = 64\n"
            "map_capacity = 256\nlk_window = 9\nlk_levels = 1\nmin_tracked_features = 40\n"
            "tracked_features_tol = 20\nbundle_size = 3\nmax_iterations = 2\n"
            f"error_path = {err}\n" + "".join(f"{k} = {v}\n" for k, v in paths.items())
        )
        assert cli.main(["run", str(ini), "--device", "cpu"]) == 0
        assert "poses" in capsys.readouterr().out
        assert err.read_text().startswith("Runtime: ")

    def test_missing_config_is_an_error_exit(self, tmp_path, capsys):
        assert cli.main(["run", str(tmp_path / "nope.ini"), "--device", "cpu"]) == 1
        assert "error:" in capsys.readouterr().err
