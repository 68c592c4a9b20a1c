"""The port's kernel modules against the JAX package, on the CPU.

On the CPU every wrapper (``capture_level``, ``lk_template``, ``lk_iterate``,
``min_eig_response``) runs its plain PyTorch version, which is also the
yardstick the CUDA kernel is held against on the card (``chip_smoke.py``).
Here the same numpy-seeded arrays go through the JAX function — the XLA
formulation and the Pallas kernel in interpret mode — and through the port.

``capture_level`` and ``lk_iterate`` take the *unpadded* level and positions
in padded coordinates; the JAX functions take the padded level.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.frontend import image as j_image
from pmv_tpu.frontend import lucas_kanade as j_lk
from pmv_tpu.frontend import pallas_capture, pallas_kernels, pallas_lk
from pmv_tpu.io import synthetic as j_synthetic
from pmv_tpu_torch import build
from pmv_tpu_torch.frontend import capture, image, lk_kernels, min_eig
from pmv_tpu_torch.frontend import lucas_kanade as lk


def T(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _pyr_and_pts(seed=0, shape=(120, 180), n=70, levels=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    H, W = shape
    pts = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)], -1).astype(np.float32)
    return img, pts


# ---------------------------------------------------------------- K4


class TestMinEig:
    def test_plain_matches_xla_whole_image(self):
        """rtol 1e-5: same arithmetic in the same order, f32 on both sides;
        atol 1e-3 absorbs the cancellation in ``mean - rad`` on flat areas
        of a 0-255 image."""
        rng = np.random.default_rng(0)
        img = (rng.random((96, 131)) * 255).astype(np.float32)
        ref = np.asarray(j_image.min_eig_response(jnp.asarray(img)))
        got = min_eig.min_eig_response(T(img)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)

    def test_plain_matches_pallas_interior(self):
        """The TPU kernel edge-replicates where the port (like the XLA
        version) zeroes the 1-px gradient border: they agree from row/col 2
        inwards."""
        rng = np.random.default_rng(1)
        img = (rng.random((70, 90)) * 255).astype(np.float32)
        ref = np.asarray(
            pallas_kernels.min_eig_response(jnp.asarray(img), tile_rows=32, interpret=True)
        )
        got = min_eig.min_eig_response(T(img)).numpy()
        np.testing.assert_allclose(got[2:-2, 2:-2], ref[2:-2, 2:-2], rtol=1e-5, atol=1e-3)

    def test_wrapper_uses_plain_on_cpu_and_counts_nothing(self):
        before = min_eig.min_eig_response.launches
        img = torch.rand(20, 30)
        assert torch.equal(min_eig.min_eig_response(img), image.min_eig_response(img))
        assert min_eig.min_eig_response.launches == before


# ---------------------------------------------------------------- image


class TestImage:
    @pytest.mark.parametrize("shape", [(64, 96), (37, 53)])
    def test_pyramid(self, shape):
        """Shifted sums in the JAX package's order: 1e-5 relative."""
        rng = np.random.default_rng(2)
        img = (rng.random(shape) * 255).astype(np.float32)
        ref = j_image.build_pyramid(jnp.asarray(img), 3)
        got = image.build_pyramid(T(img), 3)
        assert len(got) == len(ref) == 4
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)

    def test_gradient_and_blur(self):
        rng = np.random.default_rng(3)
        img = (rng.random((40, 50)) * 255).astype(np.float32)
        gx, gy = image.spatial_gradient(T(img))
        rx, ry = j_image.spatial_gradient(jnp.asarray(img))
        assert np.array_equal(gx.numpy(), np.asarray(rx))
        assert np.array_equal(gy.numpy(), np.asarray(ry))
        np.testing.assert_allclose(
            image.box_blur3(T(img)).numpy(), np.asarray(j_image.box_blur3(jnp.asarray(img))),
            rtol=1e-6,
        )
        for g, r in zip(image.structure_tensor(T(img)), j_image.structure_tensor(jnp.asarray(img))):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------- K1


class TestCapture:
    @pytest.mark.parametrize("win,search", [(21, 10), (15, 6)])
    def test_bit_exact_vs_xla_and_pallas(self, win, search):
        img, pts = _pyr_and_pts()
        PAD = j_lk._pad_for(win, search)
        j_pyr = j_image.build_pyramid(jnp.asarray(img), 3)
        for lvl, j_img in enumerate(j_pyr):
            j_img_p = jnp.pad(j_img, PAD, mode="edge")
            ctr = jnp.asarray(pts) / (2.0**lvl) + PAD
            ref, rr, rc = j_lk._capture_region(j_img_p, ctr, win, search)
            pal, pr, pc = pallas_capture.capture_level(j_img_p, ctr, win, search, interpret=True)
            blk, r0, c0 = capture.capture_level(T(j_img), T(ctr), win, search)
            for a, b in ((r0, rr), (c0, rc), (blk, ref), (r0, pr), (c0, pc), (blk, pal)):
                assert np.array_equal(a.numpy(), np.asarray(b))

    def test_corner_positions_clip(self):
        img, _ = _pyr_and_pts(seed=3)
        H, W = img.shape
        win, search = 15, 6
        PAD = j_lk._pad_for(win, search)
        pts = np.array(
            [[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1], [W / 2, H / 2], [-40, -40], [W + 40, H + 40]],
            np.float32,
        )
        j_img_p = jnp.pad(jnp.asarray(img), PAD, mode="edge")
        ref, rr, rc = j_lk._capture_region(j_img_p, jnp.asarray(pts) + PAD, win, search)
        blk, r0, c0 = capture.capture_level(T(img), T(pts) + PAD, win, search)
        assert np.array_equal(r0.numpy(), np.asarray(rr))
        assert np.array_equal(c0.numpy(), np.asarray(rc))
        assert np.array_equal(blk.numpy(), np.asarray(ref))

    def test_capture_blocks_all_levels(self):
        img, pts = _pyr_and_pts(seed=1, n=40)
        ref = j_lk.capture_blocks(tuple(j_image.build_pyramid(jnp.asarray(img), 3)), jnp.asarray(pts), win=15)
        got = lk.capture_blocks(image.build_pyramid(T(img), 3), T(pts), win=15)
        assert len(got) == len(ref) == 4
        for (gb, gr, gc), (rb, rr, rc) in zip(got, ref):
            assert np.array_equal(gr.numpy(), np.asarray(rr))
            assert np.array_equal(gc.numpy(), np.asarray(rc))
            np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=1e-5, atol=1e-4)


# Level shapes of the new-design tests: the default loop's coarsest level
# (23 x 76: smaller than a region, so every block is clipped and most of it
# is replicated edge), the next one up, and an odd-sized one.
LEVEL_SHAPES = [(23, 76), (46, 153), (61, 97)]
WIN_SEARCH = [(21, 10), (15, 6)]


def _border_points(H, W):
    """Positions on all four borders and corners, just inside, just outside
    and far outside the level, plus a few in the interior."""
    us = [-30.0, -0.6, 0.0, 0.4, W / 2.0, W - 1.4, W - 1.0, W - 0.4, W + 30.0]
    vs = [-30.0, -0.6, 0.0, 0.4, H / 2.0, H - 1.4, H - 1.0, H - 0.4, H + 30.0]
    return np.array([[u, v] for u in us for v in vs], np.float32)


class TestClampedRead:
    """The kernels read the unpadded level at clamped coordinates in place of
    a padded copy; ``capture_level_clamped`` is that addressing in PyTorch."""

    @pytest.mark.parametrize("shape", LEVEL_SHAPES)
    @pytest.mark.parametrize("win,search", WIN_SEARCH)
    def test_equals_pad_then_slice_at_borders(self, win, search, shape):
        rng = np.random.default_rng(7)
        level = T(rng.uniform(0, 255, shape).astype(np.float32))
        H, W = shape
        PAD = lk._pad_for(win, search)
        rnd = np.stack([rng.uniform(-5, W + 4, 40), rng.uniform(-5, H + 4, 40)], -1)
        center = T(np.concatenate([_border_points(H, W), rnd.astype(np.float32)])) + PAD
        got = capture.capture_level_clamped(level, center, win, search)
        want = capture.capture_level_plain(level, center, win, search)
        Rg = lk.region_size(win, search)
        assert got[0].shape == (center.shape[0], Rg, Rg)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        # the borders were really hit: some blocks sit at each clip limit
        r0, c0 = want[1], want[2]
        assert int(r0.min()) == 0 and int(r0.max()) == H + 2 * PAD - Rg
        assert int(c0.min()) == 0 and int(c0.max()) == W + 2 * PAD - Rg

    @pytest.mark.parametrize("shape", LEVEL_SHAPES)
    @pytest.mark.parametrize("win,search", WIN_SEARCH)
    def test_capture_vs_pallas_at_borders(self, win, search, shape):
        """``capture_level`` on the unpadded level against the Pallas capture
        kernel (interpret mode) on the padded one, border features included:
        blocks and origins bit for bit."""
        rng = np.random.default_rng(8)
        img = rng.uniform(0, 255, shape).astype(np.float32)
        PAD = lk._pad_for(win, search)
        ctr = _border_points(*shape) + PAD
        pal, pr, pc = pallas_capture.capture_level(
            jnp.pad(jnp.asarray(img), PAD, mode="edge"), jnp.asarray(ctr), win, search,
            interpret=True)
        blk, r0, c0 = capture.capture_level(T(img), T(ctr), win, search)
        for a, b in ((r0, pr), (c0, pc), (blk, pal)):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_ctypes_signatures_match_the_sources():
    """``build.SIGNATURES`` against the ``extern "C"`` declarations in
    ``csrc/*.cu``: a mismatch would cut a pointer or shift every argument."""
    kinds = {"int": build._i, "float": build._f}
    found = {}
    for name in build.SOURCES:
        text = (build.CSRC / name).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            args = []
            for a in m.group(2).split(","):
                a = " ".join(a.split())
                if "*" in a or a.startswith("cudaStream_t"):
                    args.append(build._p)
                else:
                    args.append(kinds[a.split()[0]])
            found[m.group(1)] = tuple(args)
    assert found == build.SIGNATURES


# ---------------------------------------------------------------- K2, K3


def _scene(n_frames=3, seed=2, n_per_tile=48, density=90):
    from pmv_tpu.frontend import corners as j_corners

    seq = j_synthetic.make_sequence(n_frames=n_frames, shape=(128, 192), density=density, seed=seed)
    imgs = [np.asarray(f, np.float32) for f in seq["images"]]
    xy, _, valid = j_corners.grid_extract(jnp.asarray(imgs[0]), n_per_tile=n_per_tile, tile_h=128, tile_w=192)
    return imgs, np.asarray(xy, np.float32), np.asarray(valid)


class TestTemplate:
    def test_stats_vs_xla_on_same_window(self):
        """``_template_stats`` on the very same sampled window: elementwise
        parts bit-equal, the G sums 1e-5 relative (summation order)."""
        rng = np.random.default_rng(4)
        win = 15
        F = (rng.random((30, win + 2, win + 2)) * 255).astype(np.float32)
        ref = j_lk._template_stats(jnp.asarray(F), win)
        got = lk._template_stats(T(F), win)
        for g, r in zip(got[:3], ref[:3]):
            assert np.array_equal(g.numpy(), np.asarray(r))
        for g, r in zip(got[3:], ref[3:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5)

    def test_sampler_vs_tap_matrices(self):
        """Direct-index bilinear sampling vs the JAX package's tap-matrix
        products: same taps and weights, different association; 1e-4 on
        0-255 values."""
        rng = np.random.default_rng(5)
        region = (rng.random((20, 40, 40)) * 255).astype(np.float32)
        lr = rng.uniform(0, 40 - 15 - 1.01, 20).astype(np.float32)
        lc = rng.uniform(0, 40 - 15 - 1.01, 20).astype(np.float32)
        ref = j_lk._sample_window(jnp.asarray(region), jnp.asarray(lr), jnp.asarray(lc), 15)
        got = lk._sample_window(T(region), T(lr), T(lc), 15)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)

    def test_level_vs_pallas_kernels(self):
        """lk_template + lk_iterate of one level vs the two Pallas kernels
        (``_level_call`` in interpret mode): min_eig 1e-4 relative on
        textured slots, refined guess 5e-3 px."""
        imgs, xy, valid = _scene(n_frames=2)
        win, iters = 15, 10
        search = j_lk._resolve_search(win, None)
        PAD = j_lk._pad_for(win, search)
        N = xy.shape[0]
        half = (win - 1) / 2.0
        blk, br0, bc0 = capture.capture_level(T(imgs[0]), T(xy) + PAD, win, search)
        raw_r = T(xy)[:, 1] + PAD - half - 1.0 - br0
        raw_c = T(xy)[:, 0] + PAD - half - 1.0 - bc0
        Tt, Ix, Iy, st = lk_kernels.lk_template(blk, raw_r, raw_c, win)
        g, region, rr0, rc0 = lk_kernels.lk_iterate(
            T(imgs[1]), Tt, Ix, Iy, st, T(xy) + PAD, win, search, iters)

        N_pad = -(-N // 128) * 128
        scal = np.zeros((8, N_pad), np.float32)
        scal[0, :N], scal[1, :N] = raw_r.numpy(), raw_c.numpy()
        scal[2, :N], scal[3, :N] = xy[:, 1] + PAD, xy[:, 0] + PAD
        scal[4, :N], scal[5, :N] = rr0.numpy(), rc0.numpy()

        def lanes(b):
            out = np.zeros((b.shape[1], b.shape[2], N_pad), np.float32)
            out[:, :, :N] = np.transpose(b.numpy(), (1, 2, 0))
            return jnp.asarray(out)

        out = np.asarray(
            pallas_lk._level_call(lanes(blk), lanes(region), jnp.asarray(scal), win, iters, True)
        )
        ok = valid & (out[2, :N] > 1e-2)
        assert ok.sum() >= 20
        np.testing.assert_allclose(st[:, 4].numpy()[ok], out[2, :N][ok], rtol=1e-4)
        np.testing.assert_allclose(g[:, 1].numpy()[ok], out[0, :N][ok], atol=5e-3)
        np.testing.assert_allclose(g[:, 0].numpy()[ok], out[1, :N][ok], atol=5e-3)


def _wave_images(shape, shift, seed):
    """Two smooth textured float32 images of ``shape`` (sums of seeded random
    sinusoids, 0-255), the second the first moved by ``shift`` = (du, dv)."""
    rng = np.random.default_rng(seed)
    H, W = shape
    k = rng.uniform(0.15, 0.7, (24, 2)) * rng.choice([-1.0, 1.0], (24, 2))
    ph = rng.uniform(0, 2 * np.pi, 24)
    amp = rng.uniform(0.5, 1.0, 24)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)

    def render(dx, dy):
        z = sum(a * np.sin(kx * (xx - dx) + ky * (yy - dy) + p)
                for a, (kx, ky), p in zip(amp, k, ph))
        return (127.5 + 127.5 * z / np.abs(z).max()).astype(np.float32)

    return render(0.0, 0.0), render(*shift)


class TestIterateCaptures:
    @pytest.mark.parametrize("shape", LEVEL_SHAPES)
    @pytest.mark.parametrize("win,search", WIN_SEARCH)
    def test_level_vs_pallas_track_level(self, win, search, shape):
        """``lk_template`` + ``lk_iterate`` of one level against
        ``pallas_lk._track_level_cached`` in interpret mode, border features
        included. The region handed on is pure extraction: bit-equal after
        the (Rg, Rg, N) -> (N, Rg, Rg) transpose, origins equal. Positions:
        1e-3 px on textured slots (same taps and weights; the two differ in
        the association of the blend and in summation order)."""
        H, W = shape
        iters = 10
        img0, img1 = _wave_images(shape, (0.8, -0.6), seed=11)
        rng = np.random.default_rng(12)
        inner = np.stack([rng.uniform(2, W - 3, 60), rng.uniform(2, H - 3, 60)], -1)
        pts = np.concatenate([_border_points(H, W), inner.astype(np.float32)])
        guess = (pts + rng.uniform(-0.5, 0.5, pts.shape)).astype(np.float32)
        PAD = lk._pad_for(win, search)
        half = (win - 1) / 2.0

        blk, br0, bc0 = capture.capture_level(T(img0), T(pts) + PAD, win, search)
        raw_r = T(pts)[:, 1] + PAD - half - 1.0 - br0
        raw_c = T(pts)[:, 0] + PAD - half - 1.0 - bc0
        Tt, Ix, Iy, st = lk_kernels.lk_template(blk, raw_r, raw_c, win)
        g, region, rr0, rc0 = lk_kernels.lk_iterate(
            T(img1), Tt, Ix, Iy, st, T(guess) + PAD, win, search, iters)

        ref_g, ref_me, _, (ref_region_t, ref_r0, ref_c0) = pallas_lk._track_level_cached(
            jnp.transpose(jnp.asarray(blk.numpy()), (1, 2, 0)),
            jnp.asarray(br0.numpy()), jnp.asarray(bc0.numpy()),
            jnp.asarray(img1), jnp.asarray(pts), jnp.asarray(guess),
            win, iters, search, True)

        assert np.array_equal(rr0.numpy(), np.asarray(ref_r0))
        assert np.array_equal(rc0.numpy(), np.asarray(ref_c0))
        assert np.array_equal(region.numpy(), np.transpose(np.asarray(ref_region_t), (2, 0, 1)))
        ref_me = np.asarray(ref_me)
        np.testing.assert_allclose(st[:, 4].numpy(), ref_me, rtol=1e-4, atol=1e-4)
        ok = (ref_me > 1.0) & np.isfinite(np.asarray(ref_g)).all(axis=1)
        assert ok.sum() >= 40
        np.testing.assert_allclose((g - PAD).numpy()[ok], np.asarray(ref_g)[ok], atol=1e-3)
        # the track found the shift where the whole window lies in the level
        m = win // 2 + 2
        seen = ok & (pts[:, 0] > m) & (pts[:, 0] < W - 1 - m) & (pts[:, 1] > m) & (pts[:, 1] < H - 1 - m)
        if seen.any():
            np.testing.assert_allclose(
                (g - PAD).numpy()[seen] - pts[seen], np.broadcast_to([0.8, -0.6], (seen.sum(), 2)), atol=0.1)


class TestTrackCached:
    @pytest.mark.parametrize("win", [15, 21])
    def test_vs_xla_and_pallas_two_hops(self, win):
        """Full pyramid ``track_cached`` against both JAX trackers: positions
        atol 5e-3 px on slots valid in both (the bar the JAX package holds
        its own two trackers to), status equal on >= 99 %. The second hop
        takes its templates from blocks captured during the first."""
        imgs, xy, valid = _scene()
        j_pyrs = [j_image.build_pyramid(jnp.asarray(im), 3) for im in imgs]
        pyrs = [image.build_pyramid(T(im), 3) for im in imgs]

        ref_blocks = j_lk.capture_blocks(tuple(j_pyrs[0]), jnp.asarray(xy), win=win)
        pal_blocks = pallas_lk.capture_blocks(tuple(j_pyrs[0]), jnp.asarray(xy), win=win)
        blocks = lk.capture_blocks(pyrs[0], T(xy), win=win)

        ref_xy, ref_st, ref_blocks = j_lk.track_cached(ref_blocks, j_pyrs[1], jnp.asarray(xy), jnp.asarray(valid), win=win)
        pal_xy, pal_st, _ = pallas_lk.track_cached(pal_blocks, j_pyrs[1], jnp.asarray(xy), jnp.asarray(valid), win=win, interpret=True)
        got_xy, got_st, blocks = lk.track_cached(blocks, pyrs[1], T(xy), T(valid), win=win)

        for other_xy, other_st in ((ref_xy, ref_st), (pal_xy, pal_st)):
            o_st = np.asarray(other_st)
            assert (got_st.numpy() == o_st).mean() >= 0.99
            both = got_st.numpy() & o_st
            assert both.sum() >= 20
            np.testing.assert_allclose(got_xy.numpy()[both], np.asarray(other_xy)[both], atol=5e-3)

        # second hop, each side from its own first-hop result
        ref2_xy, ref2_st, _ = j_lk.track_cached(ref_blocks, j_pyrs[2], ref_xy, ref_st, win=win)
        got2_xy, got2_st, _ = lk.track_cached(blocks, pyrs[2], got_xy, got_st, win=win)
        assert (got2_st.numpy() == np.asarray(ref2_st)).mean() >= 0.99
        both2 = got2_st.numpy() & np.asarray(ref2_st)
        assert both2.sum() >= 20
        # first-hop differences (<= 5e-3) carry into the second hop's start
        np.testing.assert_allclose(got2_xy.numpy()[both2], np.asarray(ref2_xy)[both2], atol=2e-2)

    def test_cpu_tensors_take_the_plain_versions(self):
        """On CPU tensors each wrapper returns its plain version's result,
        bit for bit, and counts no launch."""
        imgs, xy, _ = _scene(n_frames=2)
        win, search = 9, 4
        PAD = lk._pad_for(win, search)
        level = T(imgs[1])
        center = T(xy) + PAD
        got = capture.capture_level(level, center, win, search)
        want = capture.capture_level_plain(level, center, win, search)
        padded = lk._capture_region(image._pad_edge(level, PAD), center, win, search)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(got, padded))
        blk, r0, c0 = got
        half = (win - 1) / 2.0
        raw_r = center[:, 1] - half - 1.0 - r0
        raw_c = center[:, 0] - half - 1.0 - c0
        got_t = lk_kernels.lk_template(blk, raw_r, raw_c, win)
        want_t = lk_kernels.lk_template_plain(blk, raw_r, raw_c, win)
        assert all(torch.equal(a, b) for a, b in zip(got_t, want_t))
        T_, Ix, Iy, st = got_t
        got_i = lk_kernels.lk_iterate(level, T_, Ix, Iy, st, center, win, search, 3)
        want_i = lk_kernels.lk_iterate_plain(level, T_, Ix, Iy, st, center, win, search, 3)
        assert all(torch.equal(a, b) for a, b in zip(got_i, want_i))
        # the region it hands on is the capture kernel's block, and its loop
        # is the plain loop on that block
        assert all(torch.equal(a, b) for a, b in zip(got_i[1:], got))
        assert torch.equal(got_i[0], lk._iterate(blk, r0, c0, T_, Ix, Iy, st, center, win, 3))
        assert capture.capture_level.launches == 0
        assert lk_kernels.lk_template.launches == 0 and lk_kernels.lk_iterate.launches == 0
