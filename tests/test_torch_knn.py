"""The kNN front end of the port against the JAX package: FAST, the corner
responses of ``grid_extract``, the patch-SSD matcher, the eight-point
RANSAC, and the kNN branch of the per-frame step (with the eight-point and
the five-point bootstrap) from one ``StepState`` carried across with
``pmv_tpu_torch.convert``, the RANSAC draws injected.

Images here are integer-valued, as decoded frames are: FAST scores are then
integers and tie often, kNN candidates sit on integer pixels, and Chebyshev
distances and SSD errors tie. The port must break every tie as the JAX
package does, so FAST, ``grid_extract`` and ``knn_match`` are held bit for
bit.
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
from pmv_tpu.frontend import fast as j_fast
from pmv_tpu.frontend import knn_matcher as j_knn
from pmv_tpu.frontend.image import build_pyramid as j_build_pyramid
from pmv_tpu.frontend.image import harris_response as j_harris
from pmv_tpu.io import synthetic as j_synthetic
from pmv_tpu.pipeline import fused as j_fused
from pmv_tpu.solvers import essential as j_ess
from pmv_tpu.solvers import five_point as j_fp
from pmv_tpu.solvers import ransac as j_ransac
from pmv_tpu.solvers.five_point import ransac_budget
from pmv_tpu_torch import convert
from pmv_tpu_torch.core.state import FeatureTable, MapState
from pmv_tpu_torch.frontend import corners, fast, image, knn_matcher
from pmv_tpu_torch.pipeline import fused
from pmv_tpu_torch.solvers import essential as ess
from pmv_tpu_torch.solvers import five_point as fp
from tests_helpers_blob import blob_image

# One thread: the shapes here are small, several test processes share the
# machine, and the first multi-threaded call of some CPU operators in a fresh
# process (torch.sqrt in torch 2.13) has been seen to return wrong values in
# one thread's share of the tensor.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def tie_image(seed: int, shape=(40, 56)) -> np.ndarray:
    """Integer image of few grey levels (equal FAST scores everywhere),
    with bright and dark squares, two of them cut by the border, so that
    corners lie within 3 px of it and the circle's wrap-around matters."""
    rng = np.random.default_rng(seed)
    H, W = shape
    img = (rng.integers(0, 3, (H, W)) * 40).astype(np.float32)
    img[8:16, 10:18] = 200.0
    img[22:30, 30:38] = 0.0
    img[0:5, 50:W] = 255.0  # corner cut by the top-right border
    img[H - 4 : H, 0:6] = 255.0  # and by the bottom-left
    return img


class TestFAST:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("threshold", [10.0, 45.0])
    def test_response_bit_for_bit(self, seed, threshold):
        img = tie_image(seed)
        got = fast.fast_response(T(img), threshold).numpy()
        ref = np.asarray(j_fast.fast_response(J(img), threshold))
        assert np.array_equal(got, ref)
        # integer scores that tie, and corners near the border
        s = ref[ref > 0]
        assert len(np.unique(s)) < len(s)
        assert (ref[:6] > 0).any() or (ref[-6:] > 0).any()

    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("max_feats", [5, 40, 2000])
    @pytest.mark.parametrize("nonmax", [True, False])
    def test_extract_bit_for_bit(self, seed, max_feats, nonmax):
        img = tie_image(seed)
        got = fast.fast_extract(T(img), max_feats, nonmax=nonmax)
        ref = j_fast.fast_extract(J(img), max_feats=max_feats, nonmax=nonmax)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r))

    def test_reference_cases(self):
        """The cases of tests/test_components.py: corners of a bright square,
        a flat image, first-in-scan-order cap, threshold."""
        img = np.zeros((48, 48), np.float32)
        img[20:28, 20:28] = 200.0
        xy, _, valid = fast.fast_extract(T(img), 20)
        got = xy.numpy()[valid.numpy()]
        sq = np.array([[20, 20], [27, 20], [20, 27], [27, 27]])
        assert len(got) >= 1 and np.abs(got[:, None] - sq[None]).max(-1).min() <= 2
        assert np.array_equal(got, np.asarray(j_fast.fast_extract(J(img), 20)[0])[valid.numpy()])
        assert int(fast.fast_extract(torch.full((32, 32), 80.0), 10)[2].sum()) == 0

        img = np.zeros((64, 64), np.float32)
        img[10:14, 10:14] = 200.0
        img[40:44, 40:44] = 200.0
        xy, _, valid = fast.fast_extract(T(img), 2)
        got = xy.numpy()[valid.numpy()]
        assert len(got) == 2 and got[:, 1].max() < 20

        img = np.zeros((48, 48), np.float32)
        img[20:28, 20:28] = 8.0
        assert int(fast.fast_extract(T(img), 20, threshold=10.0)[2].sum()) == 0


def copies_image(seed: int, shape=(70, 150)) -> np.ndarray:
    """Integer image of a few random 9x9 patches, each stamped several
    times on a flat background: the copies of a corner have the same
    neighbourhood, so their responses are equal bit for bit in either
    package, and the tables must order them alike (lowest index first).
    Copies are spread over tiles and cut by the border."""
    rng = np.random.default_rng(seed)
    H, W = shape
    img = np.full((H, W), 60.0, np.float32)
    patches = [rng.integers(0, 256, (9, 9)).astype(np.float32) for _ in range(3)]
    at = [(5, 5), (5, 40), (20, 70), (40, 8), (45, 100), (60, 130), (30, 140), (-3, 120), (62, 30)]
    for i, (r, c) in enumerate(at):
        p = patches[i % 3]
        r0, c0 = max(r, 0), max(c, 0)
        r1, c1 = min(r + 9, H), min(c + 9, W)
        img[r0:r1, c0:c1] = p[r0 - r : r1 - r, c0 - c : c1 - c]
    return img


class TestGridExtract:
    """Whole tables equal, every slot. Float responses are computed in a
    different order of roundings by XLA's fused program and by PyTorch, so
    corners whose responses are equal only in exact arithmetic may be
    ordered differently; equal neighbourhoods give equal bits on both sides
    and are ordered alike. FAST scores are integers: any image will do."""

    @pytest.mark.parametrize("response", ["fast", "harris", "min_eig", "min_eig_xla"])
    @pytest.mark.parametrize("min_distance", [1, 5])
    def test_equal_tables(self, response, min_distance):
        """70x150 in 32x64 tiles pads both axes."""
        if response == "fast":
            img = tie_image(4, (70, 150))
        else:
            img = copies_image(4)
        quality = 0.0 if response == "fast" else 0.01
        kw = dict(tile_h=32, tile_w=64, quality=quality, min_distance=min_distance)
        got = corners.grid_extract(T(img), 12, response=response, **kw)
        ref = j_corners.grid_extract(J(img), 12, response=response, **kw)
        assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))
        valid = got[2].numpy()
        assert valid.sum() > 10
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5)
        s = got[1].numpy()[valid]
        assert len(np.unique(s)) < len(s)  # equal scores among the kept
        if response == "fast":
            assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))

    def test_harris_response(self):
        img = tie_image(5, (70, 150))
        np.testing.assert_allclose(
            image.harris_response(T(img)).numpy(), np.asarray(j_harris(J(img))), rtol=1e-5, atol=1e-2
        )


def _table(xy, valid, lm=None, score=None, *, jax_side=False):
    n = len(xy)
    lm = np.arange(n, dtype=np.int32) if lm is None else lm
    score = np.ones(n, np.float32) if score is None else score
    parts = (np.asarray(xy, np.float32), np.asarray(valid, bool), lm, score)
    return JFeatureTable(*map(J, parts)) if jax_side else FeatureTable(*map(T, parts))


def _match_both(prev_img, next_img, xy, valid, cxy, cvalid, **kw):
    got = knn_matcher.knn_match(T(prev_img), T(next_img), _table(xy, valid), T(cxy), T(cvalid), **kw)
    ref = j_knn.knn_match(J(prev_img), J(next_img), _table(xy, valid, jax_side=True),
                          J(cxy), J(cvalid), **kw)
    for f in ("xy", "valid", "landmark", "score"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f))), f
    return got


class TestKnnMatch:
    def test_scene_with_ties(self):
        """Integer blob scene shifted by (3, 1) px plus a flat band: several
        candidates equidistant from a feature (Chebyshev ties), and features
        in the flat band whose patch errors tie exactly."""
        rng = np.random.default_rng(6)
        H, W = 80, 120
        centers = np.stack([rng.uniform(12, W - 12, 25), rng.uniform(12, 45, 25)], -1)
        prev_img = np.round(blob_image((H, W), centers, sigma=2.0)).astype(np.float32)
        next_img = np.round(blob_image((H, W), centers + [3.0, 1.0], sigma=2.0)).astype(np.float32)
        prev_img[55:, :] = 50.0  # flat band: equal patches there
        next_img[55:, :] = 50.0
        xy = np.round(np.concatenate([centers, rng.uniform([15, 60], [W - 15, H - 12], (15, 2))]))
        # candidates: the shifted corners, plus rings at equal Chebyshev
        # distance around some features, plus flat-band points
        cands = [np.round(centers + [3.0, 1.0])]
        for p in xy[::4]:
            cands.append(p + np.array([[2, 0], [-2, 0], [0, 2], [0, -2], [2, 2]]))
        cands.append(np.round(rng.uniform([15, 60], [W - 15, H - 12], (20, 2))))
        cxy = np.clip(np.concatenate(cands), 0, [W - 1, H - 1]).astype(np.float32)
        cvalid = rng.random(len(cxy)) > 0.1
        valid = rng.random(len(xy)) > 0.1
        d = np.abs(xy[:, None] - cxy[None]).max(-1)
        d[:, ~cvalid] = np.inf
        nn = np.sort(d, axis=1)[:, :7]
        assert (nn[:, 1:] == nn[:, :-1]).any(axis=1).sum() >= 10  # distance ties
        for threshold in (2.0, 0.6):
            got = _match_both(prev_img, next_img, xy, valid, cxy, cvalid, threshold=threshold)
            assert 0 < int(got.valid.sum()) < int(valid.sum())

    def test_equal_errors_take_the_first(self):
        """Constant images: every patch error is 0, so the best of the k
        neighbours is the first (nearest, lowest index among equal
        distances)."""
        img = np.full((40, 40), 70.0, np.float32)
        xy = np.array([[20.0, 20.0], [10.0, 12.0]])
        cxy = np.array([[22, 20], [18, 20], [20, 22], [11, 12], [9, 12], [30, 30]], np.float32)
        got = _match_both(img, img, xy, [True, True], cxy, np.ones(6, bool))
        assert got.xy.numpy().tolist() == [[22.0, 20.0], [11.0, 12.0]]

    def test_under_filled_candidates(self):
        """Fewer valid candidates than k: top-k admits invalid slots, whose
        xy are real garbage; cand_valid[best] keeps them out."""
        rng = np.random.default_rng(7)
        img = np.round(rng.uniform(0, 255, (48, 64))).astype(np.float32)
        xy = np.array([[20.0, 20.0], [40.0, 30.0], [30.0, 10.0]])
        cxy = np.array([[20, 20], [40, 31], [5, 5], [21, 20], [39, 30], [30, 11]], np.float32)
        cvalid = np.array([True, True, False, False, False, False])
        got = _match_both(img, img, xy, np.ones(3, bool), cxy, cvalid, threshold=50.0)
        # feature 0 has its own pixel; the least errors of features 1 and 2
        # are at the invalid candidates one pixel away, which are refused
        assert got.valid.numpy().tolist() == [True, False, False]
        # a candidate set smaller than k
        _match_both(img, img, xy, np.ones(3, bool), cxy[:3], cvalid[:3], threshold=50.0)

    def test_reference_cases(self):
        """The cases of tests/test_components.py: shifted blobs match with
        their landmarks, and a frame with nothing to match rejects."""
        rng = np.random.default_rng(0)
        centers = np.stack([rng.uniform(20, 100, 10), rng.uniform(20, 100, 10)], -1)
        img0 = blob_image((128, 128), centers, sigma=2.0)
        img1 = blob_image((128, 128), centers + [4.0, 2.0], sigma=2.0)
        cand = np.round(centers + [4.0, 2.0]).astype(np.float32)
        got = _match_both(img0, img1, np.round(centers), np.ones(10, bool), cand,
                          np.ones(10, bool), threshold=5.0)
        assert int(got.valid.sum()) == 10
        assert got.landmark.numpy().tolist() == list(range(10))
        img0 = blob_image((64, 64), [(30, 30)], sigma=2.0)
        got = _match_both(img0, np.zeros((64, 64), np.float32), [[30.0, 30.0]], [True],
                          [[10.0, 10.0]], [True], threshold=0.5)
        assert int(got.valid.sum()) == 0

    def test_fractional_positions(self):
        """Features off the pixel grid (an LK-tracked table handed to kNN):
        the four-tap blend; same matches."""
        rng = np.random.default_rng(8)
        centers = np.stack([rng.uniform(15, 100, 12), rng.uniform(15, 60, 12)], -1)
        img0 = blob_image((80, 120), centers, sigma=2.5)
        img1 = blob_image((80, 120), centers + [2.0, -1.0], sigma=2.5)
        cand = np.round(centers + [2.0, -1.0]).astype(np.float32)
        _match_both(img0, img1, centers + 0.37, np.ones(12, bool), cand, np.ones(12, bool),
                    threshold=5.0)


def two_view(seed, n=150, noise=0.3, n_outliers=20):
    """Pixels of a two-view scene (x2 = R x1 + t, z > 0 in front)."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
    X1 = np.stack([rng.uniform(-10, 10, n), rng.uniform(-5, 5, n), rng.uniform(8, 40, n)], -1)
    R = np.asarray(j_geo.rodrigues(jnp.asarray([0.01, -0.04, 0.005])))
    t = np.array([0.3, -0.05, -0.9]) / np.linalg.norm([0.3, -0.05, -0.9])
    X2 = X1 @ R.T + t
    uv1 = X1[:, :2] / X1[:, 2:3] * 500.0 + [320.0, 240.0] + rng.normal(0, noise, (n, 2))
    uv2 = X2[:, :2] / X2[:, 2:3] * 500.0 + [320.0, 240.0] + rng.normal(0, noise, (n, 2))
    out = rng.choice(n, n_outliers, replace=False)
    uv2[out] += rng.uniform(20, 80, (n_outliers, 2)) * rng.choice([-1, 1], (n_outliers, 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), K


def e_dist(Ea, Eb):
    a = np.asarray(Ea, np.float64) / np.linalg.norm(Ea)
    b = np.asarray(Eb, np.float64) / np.linalg.norm(Eb)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


class TestEightPointRansac:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_same_samples_same_model(self, seed):
        """The JAX package's own draw injected: E equal up to sign (2e-3 on
        unit-norm entries, as the five-point test) and the same inliers."""
        uv1, uv2, K = two_view(seed)
        valid = np.random.default_rng(seed).random(len(uv1)) > 0.05
        key = jax.random.PRNGKey(seed)
        H = 64
        samples = np.asarray(j_ransac.sample_minimal_sets(key, J(valid), H, 8))
        jE, jinl = j_ess.find_essential_ransac(J(uv1), J(uv2), J(valid), J(K), key, n_hypos=H)
        E, inl = ess.find_essential_ransac(T(uv1), T(uv2), T(valid), T(K), None, n_hypos=H,
                                           samples=T(samples))
        assert np.array_equal(inl.numpy(), np.asarray(jinl))
        assert int(inl.sum()) >= 100
        assert e_dist(E.numpy(), jE) < 2e-3

    def test_generator_draw(self):
        uv1, uv2, K = two_view(3)
        gen = torch.Generator().manual_seed(0)
        E, inl = ess.find_essential_ransac(T(uv1), T(uv2), torch.ones(len(uv1), dtype=torch.bool),
                                           T(K), gen, n_hypos=64)
        assert E.shape == (3, 3) and int(inl.sum()) >= 120


# --------------------------------------------------------------------------
# the kNN branch of the per-frame step
# --------------------------------------------------------------------------

H, W, N, M = 96, 160, 128, 512
BASE = dict(
    matcher="knn", tile_h=H, tile_w=W, n_per_tile=128, knn_cand_per_tile=200,
    reseed_tol=60, e_hypos=64, pnp_hypos=64, pnp_thresh=3.0, bundle_size=3, ba_iters=3,
    traj_cap=16,
)
# FAST with the eight-point bootstrap; the default extractor with five-point
RUNS = {
    "fast": dict(BASE, response="fast", quality=0.0, min_distance=1, tracked_tol=30,
                 essential_solver="eight_point"),
    "min_eig": dict(BASE, tracked_tol=12),
}


def flatten(s) -> dict:
    """A JAX kNN StepState as the flat numpy dict ``convert`` takes."""
    d = {"blocks.0.image": np.asarray(s.blocks[0][0])}
    for f in ("xy", "valid", "landmark", "score"):
        d[f"table.{f}"] = np.asarray(getattr(s.table, f))
    for f in ("xyz", "alive", "head"):
        d[f"map.{f}"] = np.asarray(getattr(s.map, f))
    for f in ("R", "t", "R_s", "t_s", "scale", "k", "R_hist", "t_hist",
              "tbl_xy_hist", "tbl_valid_hist", "tbl_lm_hist", "map_hist", "ba_overflow"):
        d[f] = np.asarray(getattr(s, f))
    return d


def _initial_table(img0, cfg):
    xy, sc, va = j_corners.grid_extract(J(img0), cfg.n_per_tile, tile_h=H, tile_w=W,
                                        quality=cfg.quality, min_distance=cfg.min_distance,
                                        response=cfg.response)
    txy, tsc, tva = j_corners.select_top(xy, sc, va, N)
    return JFeatureTable(xy=txy, valid=tva, landmark=jnp.full((N,), -1, jnp.int32), score=tsc)


def _jax_run(name):
    """Six frames of a small corridor through the JAX package's kNN
    frame_step, every step recorded."""
    C = 6
    seq = j_synthetic.make_sequence(n_frames=C + 1, shape=(H, W), density=200, seed=3)
    cfg = j_fused.StepConfig(lk_impl="tap", **RUNS[name])
    img0 = seq["images"][0]
    s = j_fused.init_state(pyr=tuple(j_build_pyramid(J(img0), cfg.lk_levels)),
                           table=_initial_table(img0, cfg), map_state=JMapState.empty(M), cfg=cfg)
    K = np.asarray(seq["K"], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    imgs = seq["images"][1:].astype(np.uint8).astype(np.float32)
    gts = np.linalg.norm(np.diff(seq["gt_t"], axis=0), axis=1).astype(np.float32)
    recs = []
    for i in range(C):
        before = s
        s, _, stats = j_fused.frame_step(s, J(imgs[i]), J(gts[i]), keys[i], J(K), cfg)
        recs.append(dict(before=before, after=s, img=imgs[i], gt=gts[i], key=keys[i],
                         tracked=int(stats["tracked"]), n3d=int(stats["n3d"]),
                         used_pnp=bool(stats["used_pnp"]), accepted=bool(stats["accepted"])))
    return dict(name=name, K=K, steps=recs, seq=seq)


@pytest.fixture(scope="module", params=sorted(RUNS))
def jax_run(request):
    return _jax_run(request.param)


def _samples_for(rec, cfg):
    """The minimal sets the JAX frame_step drew (same key derivation, same
    validity mask, same set size)."""
    key_pose, _ = jax.random.split(rec["key"])
    src, nxt, mp = rec["before"].table, rec["after"].table, rec["before"].map
    if rec["used_pnp"]:
        lm = np.asarray(src.landmark)
        alive = np.asarray(mp.alive)[np.clip(lm, 0, None)] & (lm >= 0)
        mask = np.asarray(src.valid) & np.asarray(nxt.valid) & alive
        return np.asarray(j_ransac.sample_minimal_sets(key_pose, J(mask), cfg.pnp_hypos, 6))
    corr = np.asarray(src.valid) & np.asarray(nxt.valid)
    if cfg.essential_solver == "eight_point":
        return np.asarray(j_ransac.sample_minimal_sets(key_pose, J(corr), cfg.e_hypos, 8))
    return np.asarray(j_ransac.sample_minimal_sets(key_pose, J(corr), ransac_budget(cfg.e_hypos), 5))


def rot_angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


class TestKnnFrameStep:
    def test_run_has_both_kinds_of_frame(self, jax_run):
        recs = jax_run["steps"]
        assert not recs[0]["used_pnp"]
        assert any(r["used_pnp"] for r in recs)

    def test_state_round_trip(self, jax_run):
        d = flatten(jax_run["steps"][2]["before"])
        s = convert.state_from_reference(d, "cpu")
        assert len(s.blocks) == 1 and len(s.blocks[0]) == 1
        back = convert.state_to_numpy(s)
        assert back.keys() == d.keys()
        for k, v in d.items():
            assert np.array_equal(back[k], v), k

    @pytest.mark.parametrize("kind", ["bootstrap", "pnp"])
    def test_step(self, jax_run, kind):
        """The matched (and reseeded) table equal bit for bit; the pose with
        the JAX package's draw injected within 5e-3 rad / 5e-3 on a PnP frame
        (the JAX package's f32 polish jitters by a few 1e-3 rad,
        tests/test_torch_solvers.py) and 1e-2 rad / 2e-2 on a bootstrap
        frame: with the 18-45 inliers that kNN matches at this size, the JAX
        package's own f32 Sampson polish lands up to 7.8e-3 rad and 1.6e-2
        (unit baseline) from its f64 result, so the bootstrap is held in f64
        by ``test_bootstrap_pose_in_f64``; landmark bindings on >= 97 % of
        slots."""
        recs = [r for r in jax_run["steps"] if r["used_pnp"] == (kind == "pnp")]
        tol, tol_t = (5e-3, 5e-3) if kind == "pnp" else (1e-2, 2e-2)
        for rec in recs[:2]:
            cfg = fused.StepConfig(**RUNS[jax_run["name"]])
            state = convert.state_from_reference(flatten(rec["before"]), "cpu")
            new, _, stats = fused.frame_step(
                state, T(rec["img"]), float(rec["gt"]), None, T(jax_run["K"]), cfg,
                samples=T(_samples_for(rec, cfg)),
            )
            ref = rec["after"]
            assert (stats["tracked"], stats["n3d"], stats["used_pnp"]) == \
                (rec["tracked"], rec["n3d"], rec["used_pnp"])
            assert bool(stats["accepted"]) == rec["accepted"]
            assert np.array_equal(new.table.xy.numpy(), np.asarray(ref.table.xy))
            assert np.array_equal(new.table.valid.numpy(), np.asarray(ref.table.valid))
            assert torch.equal(new.blocks[0][0], T(rec["img"]))
            assert rot_angle(new.R.numpy(), ref.R) < tol
            scale = max(1.0, float(np.linalg.norm(np.asarray(ref.t))))
            assert np.linalg.norm(new.t.numpy() - np.asarray(ref.t)) < tol_t * scale
            bound = new.table.landmark.numpy() >= 0
            assert (bound == (np.asarray(ref.table.landmark) >= 0)).mean() >= 0.97

    def test_bootstrap_pose_in_f64(self, jax_run):
        """The bootstrap's pose from the step's correspondences: the same
        RANSAC model and inliers in f32 (inliers equal; E 2e-3 up to sign, as
        tests/test_torch_solvers.py holds the five-point RANSAC: the f32
        8-point fit on 18 integer-pixel inliers differs by 6e-4), then
        ``recover_pose`` in float64 on both sides within 1e-6 rad."""
        cfg = fused.StepConfig(**RUNS[jax_run["name"]])
        K = jax_run["K"]
        for rec in [r for r in jax_run["steps"] if not r["used_pnp"]][:2]:
            src, nxt = rec["before"].table, rec["after"].table
            corr = np.asarray(src.valid) & np.asarray(nxt.valid)
            key_pose, _ = jax.random.split(rec["key"])
            samples = T(_samples_for(rec, cfg))
            if cfg.essential_solver == "eight_point":
                jE, jinl = j_ess.find_essential_ransac(
                    src.xy, nxt.xy, J(corr), J(K), key_pose, n_hypos=cfg.e_hypos)
                E, inl = ess.find_essential_ransac(
                    T(src.xy), T(nxt.xy), T(corr), T(K), None, n_hypos=cfg.e_hypos, samples=samples)
            else:
                jE, jinl = j_fp.find_essential_5pt_ransac(
                    src.xy, nxt.xy, J(corr), J(K), key_pose, n_hypos=ransac_budget(cfg.e_hypos))
                E, inl = fp.find_essential_5pt_ransac(
                    T(src.xy), T(nxt.xy), T(corr), T(K), None,
                    n_hypos=ransac_budget(cfg.e_hypos), samples=samples)
            assert np.array_equal(inl.numpy(), np.asarray(jinl))
            assert e_dist(E.numpy(), jE) < 2e-3
            f64 = [np.asarray(a, np.float64) for a in (jE, src.xy, nxt.xy, K)]
            jR, jt, _, _ = j_ess.recover_pose(J(f64[0]), J(f64[1]), J(f64[2]), jinl, J(f64[3]))
            R, t, _, _ = ess.recover_pose(T(f64[0]), T(f64[1]), T(f64[2]), T(np.asarray(jinl)), T(f64[3]))
            assert rot_angle(R.numpy(), jR) < 1e-6
            np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6)

    def test_fused_equals_modular_matcher(self, jax_run):
        """The step's kNN association equals a knn_match call on the same
        pair with the same candidates (tests/test_pipeline.py does this for
        the JAX package)."""
        cfg = fused.StepConfig(**RUNS[jax_run["name"]])
        seq = jax_run["seq"]
        img0 = T(seq["images"][0])
        xy, sc, va = corners.grid_extract(img0, cfg.n_per_tile, tile_h=H, tile_w=W,
                                          quality=cfg.quality, min_distance=cfg.min_distance,
                                          response=cfg.response)
        txy, tsc, tva = corners.select_top(xy, sc, va, N)
        table = FeatureTable(txy, tva, torch.full((N,), -1, dtype=torch.int32), tsc)
        state = fused.init_state([img0], table, MapState.empty(M), cfg)
        nxt = T(seq["images"][1].astype(np.float32))
        gen = torch.Generator().manual_seed(0)
        s2, _, stats = fused.frame_step(state, nxt, 1.0, gen, T(jax_run["K"]), cfg)
        kc_xy, _, kc_valid = corners.grid_extract(
            nxt, cfg.knn_cand_per_tile, tile_h=H, tile_w=W, quality=cfg.quality,
            min_distance=cfg.min_distance, response=cfg.response)
        ref = knn_matcher.knn_match(img0, nxt, table, kc_xy, kc_valid, k=cfg.knn_k,
                                    window=cfg.knn_window, threshold=cfg.knn_threshold)
        keep = ref.valid.numpy()
        assert np.array_equal(s2.table.xy.numpy()[keep], ref.xy.numpy()[keep])
        assert stats["tracked"] == int(ref.num_valid())


@pytest.mark.parametrize("settings", [
    dict(extractor="fast"), dict(essential_solver="eight_point"),
], ids=["fast", "default_extractor_eight_point"])
def test_run_with_knn(tmp_path, settings):
    """``run()`` with the kNN matcher end to end on the CPU: the loop that
    chip_smoke.py drives on the card at full size (phases knn_hd and
    knn_good). Finite poses, both kinds of frame, BA at its cadence, and a
    rebased ATE under 20 % of the path (the kNN bar of
    tests/test_torch_modular.py at this size)."""
    from pmv_tpu_torch.cli import rebased_ate
    from pmv_tpu_torch.config import VOConfig
    from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

    seq = j_synthetic.make_sequence(n_frames=16, shape=(H, W), density=200, seed=3)
    paths = j_synthetic.write_kitti_layout(seq, tmp_path)
    cfg = VOConfig(
        image_dir=paths["image_dir"], camera_calibration=paths["camera_calibration"],
        poses=paths["poses"], frames=16, init_frames=2, min_tracked_features=100,
        tracked_features_tol=20, bundle_size=4, max_iterations=3, feature_capacity=128,
        map_capacity=512, grid_rows=H, grid_cols=W, traj_cap=32, chunk_frames=4,
        matcher="knn", **settings,
    )
    pipe = OdometryPipeline(cfg, device="cpu")
    result = pipe.run()
    stats = pipe.frame_stats
    assert result["frames"] == len(stats) + 1 and result["ba_calls"] >= 1
    assert not stats[0]["used_pnp"] and any(s["used_pnp"] for s in stats)
    assert np.isfinite(np.stack(pipe.t)).all()
    off, n = pipe.init_offset, len(pipe.t)
    path = np.sum(np.linalg.norm(np.diff(pipe.gt_t[off : off + n], axis=0), axis=1))
    assert rebased_ate(pipe) < 0.20 * path


def test_reference_ate_runs_the_knn_hd_configuration(monkeypatch):
    """scripts/torch_reference_ate.py keeps the JAX package's copy of
    chip_smoke.py's ``HD_CFG`` (it imports nothing of the port): the two
    must name one configuration, or the ATE bar is set from another one.
    (chip_smoke.py refuses to load without a card; it is loaded here with
    one pretended, only to read its constants.)"""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent

    def load(name, rel):
        spec = importlib.util.spec_from_file_location(name, root / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    smoke = load("chip_smoke_constants", "chip_smoke.py")
    ref = load("torch_reference_ate", "scripts/torch_reference_ate.py")
    # camera, verbose and the RANSAC seed are the script's own arguments
    per_run = {"camera", "verbose", "seed"}
    assert {k: v for k, v in smoke.HD_CFG.items() if k not in per_run} == ref.KNN_HD
