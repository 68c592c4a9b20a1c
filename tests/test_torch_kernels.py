"""The port's kernel modules against the JAX package, on the CPU.

On the CPU every wrapper (``capture_level``, ``lk_template``, ``lk_iterate``,
``min_eig_response``) runs its plain PyTorch version, which is also the
yardstick the CUDA kernel is held against on the card (``chip_smoke.py``).
Here the same numpy-seeded arrays go through the JAX function — the XLA
formulation and the Pallas kernel in interpret mode — and through the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmv_tpu.frontend import image as j_image
from pmv_tpu.frontend import lucas_kanade as j_lk
from pmv_tpu.frontend import pallas_capture, pallas_kernels, pallas_lk
from pmv_tpu.io import synthetic as j_synthetic
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
            blk, r0, c0 = capture.capture_level(T(j_img_p), T(ctr), win, search)
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
        blk, r0, c0 = capture.capture_level(T(j_img_p), T(pts) + PAD, win, search)
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
        img0_p = np.pad(imgs[0], PAD, mode="edge")
        img1_p = np.pad(imgs[1], PAD, mode="edge")
        blk, br0, bc0 = capture.capture_level(T(img0_p), T(xy) + PAD, win, search)
        region, rr0, rc0 = capture.capture_level(T(img1_p), T(xy) + PAD, win, search)
        raw_r = T(xy)[:, 1] + PAD - half - 1.0 - br0
        raw_c = T(xy)[:, 0] + PAD - half - 1.0 - bc0
        Tt, Ix, Iy, st = lk_kernels.lk_template(blk, raw_r, raw_c, win)
        g = lk_kernels.lk_iterate(region, Tt, Ix, Iy, st, T(xy) + PAD, rr0, rc0, win, iters)

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
        img_p = image._pad_edge(T(imgs[1]), PAD)
        center = T(xy) + PAD
        got = capture.capture_level(img_p, center, win, search)
        want = capture.capture_level_plain(img_p, center, win, search)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        blk, r0, c0 = got
        half = (win - 1) / 2.0
        raw_r = center[:, 1] - half - 1.0 - r0
        raw_c = center[:, 0] - half - 1.0 - c0
        got_t = lk_kernels.lk_template(blk, raw_r, raw_c, win)
        want_t = lk_kernels.lk_template_plain(blk, raw_r, raw_c, win)
        assert all(torch.equal(a, b) for a, b in zip(got_t, want_t))
        T_, Ix, Iy, st = got_t
        g = lk_kernels.lk_iterate(blk, T_, Ix, Iy, st, center, r0, c0, win, 3)
        gp = lk_kernels.lk_iterate_plain(blk, r0, c0, T_, Ix, Iy, st, center, win, 3)
        assert torch.equal(g, gp)
        assert capture.capture_level.launches == 0
        assert lk_kernels.lk_template.launches == 0 and lk_kernels.lk_iterate.launches == 0
