"""``schur_lm.ba_solve_grid``'s dispatch: on the CPU it runs its eager body
(``_ba_solve_grid_eager``) as it is and captures no CUDA graph; the graph
cache's key separates every field a captured solve is fixed to; the initial
damping is filled on the device with the same bits as the upload it
replaced; and the loop's BA reaches the solver through the module
attribute, where the benchmark's recorder wraps it. The replay on a card is
held to the eager body bit for bit by ``chip_smoke.py``'s ``ba_graph``
phase."""

import numpy as np
import pytest
import torch

from pmv_tpu_torch.ba import schur_lm
from pmv_tpu_torch.config import VOConfig
from pmv_tpu_torch.io import synthetic
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline
from pmv_tpu_torch.pipeline.segmented import SegmentedPipeline
from pmv_tpu_torch.utils import profiling

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])


def make_window(seed=0, P=4, N=48, L=60, dtype=torch.float32):
    """A (P, N)-grid window: landmarks in front of cameras advancing along
    -z, pose blocks [angle_axis(R^T), -t], noisy observations, some slots
    masked, pose 0 pinned."""
    rng = np.random.default_rng(seed)
    lm = np.stack([rng.uniform(-8, 8, L), rng.uniform(-4, 4, L), rng.uniform(-40, -10, L)], -1)
    tr = np.zeros((P, 6))
    tr[:, :3] = rng.normal(size=(P, 3)) * 0.01
    tr[:, 5] = np.arange(P) * 1.0
    local = np.stack([rng.permutation(L)[:N] for _ in range(P)]).astype(np.int32)
    Kt = torch.from_numpy(K)
    uv = schur_lm.geo.ba_project(torch.from_numpy(tr)[:, None, :].expand(P, N, 6),
                                 torch.from_numpy(lm)[torch.from_numpy(local).long()], Kt).numpy()
    uv = uv + rng.normal(size=uv.shape) * 0.3
    uv[rng.random((P, N)) < 0.1] += 25.0  # outliers for the gate and the Huber loss
    mask = rng.random((P, N)) < 0.9
    tr_start = tr.copy()
    tr_start[1:, 3:] += rng.normal(size=(P - 1, 3)) * 0.01
    lm_start = lm + rng.normal(size=lm.shape) * 0.05
    pose_free = np.arange(P) > 0
    return (torch.from_numpy(tr_start).to(dtype), torch.from_numpy(lm_start).to(dtype),
            torch.from_numpy(uv).to(dtype), torch.from_numpy(local), torch.from_numpy(mask),
            torch.from_numpy(pose_free), Kt.to(dtype))


def bits(out):
    tr, lm, st = out
    return [tr, lm, st["cost0"], st["cost"], st["history"]]


@pytest.mark.parametrize("seed,iters,gate", [(0, 5, 0.0), (1, 50, 0.0), (2, 5, 2.0), (3, 0, 0.0)])
def test_the_cpu_runs_the_eager_body(seed, iters, gate):
    """On the CPU the solve is its eager body, bit for bit, and neither
    graph counter moves nor is a graph cached."""
    w = make_window(seed)
    kw = dict(iters=iters, obs_gate_px=gate)
    cached = len(schur_lm._GRAPHS)
    tracer = profiling.Tracer()
    with profiling.tracing(tracer):
        got = bits(schur_lm.ba_solve_grid(*w, **kw))
    want = bits(schur_lm._ba_solve_grid_eager(*w, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[4].shape == (iters,)
    assert not any(k.startswith("ba.graph.") for k in tracer.counters)
    assert len(schur_lm._GRAPHS) == cached
    if iters:
        assert float(got[3]) < float(got[2])  # the solve did its work


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lam0", [1e-4, 1e-3, 1.0 / 3.0, 1e6])
def test_lam0_filled_on_the_device_has_the_uploads_bits(dtype, lam0):
    """``_lm_loop`` fills the initial damping with ``torch.full`` (a kernel
    a graph can hold) where it uploaded it with ``torch.as_tensor`` (a
    blocking copy): the same value in either precision. 1e-4 is the
    default every configuration uses."""
    filled = torch.full((), lam0, dtype=dtype)
    uploaded = torch.as_tensor(lam0, dtype=dtype)
    assert filled.dtype == uploaded.dtype and filled.shape == uploaded.shape
    assert torch.equal(filled, uploaded)
    assert filled.view(torch.int32 if dtype == torch.float32 else torch.int64).item() == \
        uploaded.view(torch.int32 if dtype == torch.float32 else torch.int64).item()


def test_the_graph_key_separates_every_field():
    """Each field a captured solve is fixed to gives a key of its own:
    device, dtype, P, N, L_win, iterations, delta, lam0, the gate and the
    dtype of an index input."""
    base_kw = dict(iters=5, delta=1.0, lam0=1e-4, obs_gate_px=0.0)

    def key(P=4, N=48, L=60, dtype=torch.float32, device="cpu", local_dtype=torch.int32, **kw):
        w = [x.to(device) for x in make_window(0, P=P, N=N, L=L, dtype=dtype)]
        w[3] = w[3].to(local_dtype)
        return schur_lm._graph_key(*w, **{**base_kw, **kw})

    variants = {
        "base": key(), "device": key(device="meta"), "dtype": key(dtype=torch.float64),
        "P": key(P=5), "N": key(N=40), "L_win": key(L=64), "iters": key(iters=50),
        "delta": key(delta=2.0), "lam0": key(lam0=1e-3), "obs_gate_px": key(obs_gate_px=2.0),
        "local_dtype": key(local_dtype=torch.int64),
    }
    assert len(set(variants.values())) == len(variants), variants
    assert key() == variants["base"]  # and a repeated call finds its graph


SHAPE = (96, 160)
FRAMES = 16
RUN_CFG = dict(
    frames=FRAMES, init_frames=2, min_tracked_features=100, tracked_features_tol=48,
    bundle_size=4, max_iterations=3, feature_capacity=128, map_capacity=512,
    grid_rows=96, grid_cols=160, lk_window=15, lk_levels=2, traj_cap=32,
    chunk_frames=4, seed=0, verbose=0,
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    seq = synthetic.make_sequence(n_frames=FRAMES, shape=SHAPE, density=200, seed=3)
    return synthetic.write_kitti_layout(seq, tmp_path_factory.mktemp("kitti"))


@pytest.mark.parametrize("segments", [1, 2])
def test_the_loops_ba_calls_the_module_attribute(dataset, monkeypatch, segments):
    """``fused.ba_step`` looks ``schur_lm.ba_solve_grid`` up at call time,
    in ``OdometryPipeline.run`` and in the segmented loop: a wrapper set on
    the attribute sees every BA call of the run."""
    calls = []
    solve = schur_lm.ba_solve_grid

    def recording(*args, **kw):
        out = solve(*args, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(schur_lm, "ba_solve_grid", recording)
    cfg = VOConfig(image_dir=dataset["image_dir"], camera_calibration=dataset["camera_calibration"],
                   poses=dataset["poses"], **RUN_CFG)
    if segments > 1:
        pipe = SegmentedPipeline(cfg, segments=segments, device="cpu")
        pipe.run()
        assert len(calls) > 0
    else:
        pipe = OdometryPipeline(cfg, device="cpu")
        result = pipe.run()
        assert len(calls) == result["ba_calls"] > 0
    assert all(out[0].shape == (cfg.bundle_size, 6) for out in calls)
