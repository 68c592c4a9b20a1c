"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA card + nvcc
    python3 chip_smoke.py --ptxas    # also print registers / shared memory
    python3 chip_smoke.py --skip-main  # phases 1-3 only, no summary and no ok line

Phases, each printing one JSON line as it ends:

1. device   — card name and power limit as ``nvidia-smi`` gives them;
2. build    — compile ``pmv_tpu_torch/csrc/*.cu`` (set-up time);
3. kernels  — every hand-written kernel against its plain PyTorch version on
               the card, at the shapes the main path gives it, with its time,
               the plain version's time and the card's bound for the same work;
4. main path — a synthetic KITTI-sized corridor through
               ``OdometryPipeline(cfg, device="cuda").run()`` at the default
               configuration's full size, with the kernels' launch counts
               (a 14-frame run of the same pipeline goes first, untimed and
               uncounted, so that ms/frame is not the libraries' start-up);
5. the ``kernels`` summary line, the card line, and the final ``ok`` line.

Any failure raises and the script exits non-zero; nothing here runs on the
CPU in place of the GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

sys.path.insert(0, str(Path(__file__).resolve().parent))

from pmv_tpu_torch import build, cli  # noqa: E402
from pmv_tpu_torch.config import VOConfig  # noqa: E402
from pmv_tpu_torch.frontend import capture, corners, image, lk_kernels, min_eig  # noqa: E402
from pmv_tpu_torch.frontend import lucas_kanade as lk  # noqa: E402
from pmv_tpu_torch.io import synthetic  # noqa: E402
from pmv_tpu_torch.pipeline.odometry import OdometryPipeline  # noqa: E402

DEV = torch.device("cuda")
SHAPE = (370, 1226)  # KITTI odometry grayscale frame
N_FEAT = 512
LEVELS = 4  # pyramid has LEVELS + 1 images
WARMUP_FRAMES = 14  # untimed run before the main path: bootstrap, PnP and BA frames

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# the float32 rate outside the tensor cores. Bounds are stated against these,
# with the card's power limit printed beside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

WRAPPERS = {
    "capture_level": capture.capture_level,
    "lk_template": lk_kernels.lk_template,
    "lk_iterate": lk_kernels.lk_iterate,
    "min_eig_response": min_eig.min_eig_response,
}
META = {
    "capture_level": ("pmv_tpu_torch/csrc/capture.cu", "pmv_tpu/frontend/pallas_capture.py:104"),
    "lk_template": ("pmv_tpu_torch/csrc/lk.cu", "pmv_tpu/frontend/pallas_lk.py:303"),
    "lk_iterate": ("pmv_tpu_torch/csrc/lk.cu", "pmv_tpu/frontend/pallas_lk.py:311"),
    "min_eig_response": ("pmv_tpu_torch/csrc/min_eig.cu", "pmv_tpu/frontend/pallas_kernels.py:103"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


_flush_buf = None


def time_ms(fn, reps: int = 20, warmup: int = 3, calls: int = 1) -> float:
    """Median device time of one call of ``fn`` in ms, by CUDA events around
    each call. Before each call the 50 MB L2 cache is overwritten (the inputs
    come from device memory, which is what the bound assumes) and the stream
    is kept busy for ~0.2 ms, so that the host has queued the events and the
    call's kernels before the device reaches them: the interval then holds
    the kernels, not the time Python takes to launch them. (A plain version
    launches so many kernels that the device still overtakes the host: its
    time is what its caller waits for.)

    With ``calls`` > 1 the events go around that many calls back to back and
    the interval is divided by their number: all but the first find their
    inputs in the L2, as a kernel of the main path finds the pyramid level
    that was just built, and the events' own cost is spread."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _flush_buf.zero_()
        torch.cuda._sleep(400_000 * calls)  # device cycles
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_f = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def kernel_inputs(seed: int = 0):
    """The first two frames of a 12-frame bench corridor (made from the seed
    with numpy; the world is seeded along the whole path, so 12 frames give
    the scene its density), their pyramids on the card, and 512 positions:
    detected corners first, seeded random positions in the slots left."""
    seq = synthetic.make_sequence(
        n_frames=12, shape=SHAPE, K=synthetic.KITTI_K, density=150.0,
        speed=1.0, yaw_rate=0.004, seed=seed,
    )
    img0 = torch.from_numpy(seq["images"][0].astype(np.uint8)).to(DEV).float()
    img1 = torch.from_numpy(seq["images"][1].astype(np.uint8)).to(DEV).float()
    pyr0 = image.build_pyramid(img0, LEVELS)
    pyr1 = image.build_pyramid(img1, LEVELS)
    xy, score, valid = corners.grid_extract(img0, 80)
    xy, score, valid = corners.select_top(xy, score, valid, N_FEAT)
    # fill invalid slots (if any) with seeded random positions
    rng = np.random.default_rng(seed)
    rnd = torch.from_numpy(
        rng.uniform([5, 5], [SHAPE[1] - 6, SHAPE[0] - 6], (N_FEAT, 2)).astype(np.float32)
    ).to(DEV)
    pts = torch.where(valid[:, None], xy, rnd).contiguous()
    return img0, pyr0, pyr1, pts, valid


def check_capture(pyr1, pts, win: int):
    """K1 on all five level shapes: bit-exact blocks and origins. The level
    goes in unpadded; the plain version pads it and gathers."""
    search = lk._resolve_search(win, None)
    PAD = lk._pad_for(win, search)
    Rg = lk.region_size(win, search)
    err, t_k, t_w, t_p, t_lib, t_bound = 0.0, [], [], [], [], []
    for lvl, img in enumerate(pyr1):
        center = (pts / 2.0**lvl + PAD).contiguous()
        blk, r0, c0 = capture.capture_level(img, center, win, search)
        blk_p, r0_p, c0_p = capture.capture_level_plain(img, center, win, search)
        torch.cuda.synchronize()
        if not (torch.equal(r0, r0_p) and torch.equal(c0, c0_p)):
            raise AssertionError(f"capture_level level {lvl}: origins differ")
        err = max(err, float((blk - blk_p).abs().max()))
        if not torch.equal(blk, blk_p):
            raise AssertionError(f"capture_level level {lvl}: blocks not bit-exact")
        t_k.append(time_ms(lambda: capture.capture_level(img, center, win, search)))
        t_w.append(time_ms(lambda: capture.capture_level(img, center, win, search), calls=10))
        t_p.append(time_ms(lambda: capture.capture_level_plain(img, center, win, search)))
        r0l, c0l = r0.long(), c0.long()
        t_lib.append(time_ms(
            lambda: image._pad_edge(img, PAD).unfold(0, Rg, 1).unfold(1, Rg, 1)[r0l, c0l]))
        n = pts.shape[0]
        read = min(img.numel(), n * Rg * Rg) * 4 + n * 2 * 4
        write = n * Rg * Rg * 4 + 2 * n * 4
        t_bound.append(bound(read + write, 0.0)[0])
    return {
        "max_abs_err": err,
        "ms": statistics.mean(t_k),
        "warm_ms": statistics.mean(t_w),
        "plain_ms": statistics.mean(t_p),
        "bound_ms": statistics.mean(t_bound),
        "bound_by": "bytes",
        "library_ms": statistics.mean(t_lib),
        "bar": "bit-exact blocks and origins on all five level shapes; times are means over the five",
    }


def level_templates(pyr0, pts, lvl: int, win: int, search: int):
    """Templates of level ``lvl`` as a tracked frame has them: blocks captured
    from the previous frame's level at the features, then ``lk_template``.
    Returns (blk, raw_r, raw_c, (T, Ix, Iy, stats))."""
    PAD = lk._pad_for(win, search)
    half = (win - 1) / 2.0
    p = pts / 2.0**lvl
    blk, br0, bc0 = capture.capture_level(pyr0[lvl], (p + PAD).contiguous(), win, search)
    raw_r = (p[:, 1] + PAD - half - 1.0 - br0).contiguous()
    raw_c = (p[:, 0] + PAD - half - 1.0 - bc0).contiguous()
    return blk, raw_r, raw_c, lk_kernels.lk_template(blk, raw_r, raw_c, win)


def check_lk_template(pyr0, pts, win: int, timed: bool):
    """K2 called directly at level 0 against its plain version."""
    search = lk._resolve_search(win, None)
    N = pts.shape[0]
    blk, raw_r, raw_c, (T, Ix, Iy, st) = level_templates(pyr0, pts, 0, win, search)
    Tp, Ixp, Iyp, stp = lk_kernels.lk_template_plain(blk, raw_r, raw_c, win)
    torch.cuda.synchronize()
    err_t = max(float((a - b).abs().max()) for a, b in ((T, Tp), (Ix, Ixp), (Iy, Iyp)))
    # T/Ix/Iy take no reduction: same arithmetic, so 1e-4 on 0-255 images is
    # generous. The G sums differ by summation order: rtol 1e-4.
    if err_t > 1e-4:
        raise AssertionError(f"lk_template win={win}: T/Ix/Iy differ by {err_t}")
    if not torch.allclose(st[:, :3], stp[:, :3], rtol=1e-4, atol=1e-2):
        raise AssertionError(f"lk_template win={win}: G sums differ")
    textured = stp[:, 4] > 1e-2
    rel_me = float(((st[:, 4] - stp[:, 4]).abs() / stp[:, 4].abs().clamp(min=1e-6))[textured].max())
    if rel_me > 1e-4:
        raise AssertionError(f"lk_template win={win}: min_eig rel err {rel_me}")
    out = {"max_abs_err": err_t, "min_eig_rel_err": rel_me}
    if timed:
        ww = win * win
        # the (win+2)^2 bilinear window touches (win+3)^2 floats of each block
        b, by = bound(
            N * ((win + 3) ** 2 + 2) * 4 + N * (3 * ww + 5) * 4,
            N * ((win + 2) ** 2 * 9 + ww * 10),
        )
        out.update(
            ms=time_ms(lambda: lk_kernels.lk_template(blk, raw_r, raw_c, win)),
            plain_ms=time_ms(lambda: lk_kernels.lk_template_plain(blk, raw_r, raw_c, win)),
            library_ms=None, bound_ms=b, bound_by=by,
        )
    return out


def check_lk_iterate(pyr0, pyr1, pts, win: int, iters: int, timed: bool):
    """K3 on all five level shapes, on the template kernel's outputs: the
    region and origins it hands on bit-exact against ``capture_level_plain``,
    positions within 1e-3 px of ``lk_iterate_plain`` on textured slots, two
    calls on the same inputs equal bit for bit, for every block size built.
    Times (kernel at each block size, plain, bound) are means over the five
    level shapes; the bound counts each level pixel under a region once."""
    search = lk._resolve_search(win, None)
    PAD = lk._pad_for(win, search)
    Rg = lk.region_size(win, search)
    N, ww = pts.shape[0], win * win
    sizes = lk_kernels.ITERATE_THREADS_BUILT
    err_g = 0.0
    t_k = {nt: [] for nt in sizes}
    t_w, t_p, t_bound, by_iters = [], [], [], {}
    for lvl, level in enumerate(pyr1):
        _, _, _, (T, Ix, Iy, st) = level_templates(pyr0, pts, lvl, win, search)
        guess = (pts / 2.0**lvl + PAD).contiguous()
        args = (level, T, Ix, Iy, st, guess, win, search, iters)
        gp, region_p, r0_p, c0_p = lk_kernels.lk_iterate_plain(*args)
        ok = (st[:, 4] > 1e-2) & torch.isfinite(gp).all(dim=1)
        for nt in sizes:
            g, region, r0, c0 = lk_kernels.lk_iterate(*args, threads=nt)
            again = lk_kernels.lk_iterate(*args, threads=nt)
            torch.cuda.synchronize()
            where = f"lk_iterate win={win} level {lvl} threads={nt}"
            if not (torch.equal(r0, r0_p) and torch.equal(c0, c0_p)):
                raise AssertionError(f"{where}: origins differ")
            if not torch.equal(region, region_p):
                raise AssertionError(f"{where}: region not bit-exact")
            if not all(torch.equal(a, b) for a, b in zip((g, region, r0, c0), again)):
                raise AssertionError(f"{where}: two calls on the same inputs differ")
            e = float((g - gp).abs()[ok].max())
            if not e <= 1e-3:
                raise AssertionError(f"{where}: positions differ by {e} px")
            if nt == lk_kernels.ITERATE_THREADS:
                err_g = max(err_g, e)
            if timed:
                t_k[nt].append(time_ms(lambda: lk_kernels.lk_iterate(*args, threads=nt)))
        if timed:
            t_w.append(time_ms(lambda: lk_kernels.lk_iterate(*args), calls=10))
            if lvl == 0:
                # capture-and-hand-on alone (0 iterations) and what an iteration adds
                by_iters = {str(n): time_ms(lambda: lk_kernels.lk_iterate(*args[:-1], n), calls=10)
                            for n in (0, iters, 2 * iters)}
            t_p.append(time_ms(lambda: lk_kernels.lk_iterate_plain(*args), reps=5, warmup=1))
            t_bound.append(bound(
                (min(level.numel(), N * Rg * Rg) + N * (3 * ww + 5 + 2)) * 4
                + N * (Rg * Rg + 2 + 2) * 4,
                N * iters * ww * 13,
            ))
    out = {"max_abs_err": err_g}
    if timed:
        nt = lk_kernels.ITERATE_THREADS
        out.update(
            ms=statistics.mean(t_k[nt]), warm_ms=statistics.mean(t_w),
            plain_ms=statistics.mean(t_p),
            bound_ms=statistics.mean(b for b, _ in t_bound),
            bound_by=t_bound[0][1],  # of level 0, the largest
            library_ms=None, threads=nt,
            ms_by_threads={str(k): statistics.mean(v) for k, v in t_k.items()},
            level0_ms_by_threads={str(k): v[0] for k, v in t_k.items()},
            level0_bound_ms=t_bound[0][0], level0_warm_ms_by_iters=by_iters,
            bar="region and origins bit-exact, positions 1e-3 px, two calls equal, on all "
                "five level shapes at every block size; times are means over the five",
        )
    return out


def track_cached_plain(pyr0, pyr1, pts, valid, win: int, iters: int):
    """The 5-level cached track of ``lk.track_cached`` (blocks captured from
    ``pyr0`` at ``pts``, then tracked into ``pyr1``) built from the plain
    versions only, on whatever device the tensors lie: the yardstick for the
    same track through the kernels."""
    search = lk._resolve_search(win, None)
    PAD = lk._pad_for(win, search)
    lim = lk.template_limit(lk.region_size(win, search), win)
    half = (win - 1) / 2.0
    H, W = pyr1[0].shape
    top = len(pyr1) - 1
    guess = pts / 2.0**top
    ok_all = torch.ones_like(valid)
    for lvl in range(top, -1, -1):
        p = pts / 2.0**lvl
        blk, br0, bc0 = capture.capture_level_plain(pyr0[lvl], p + PAD, win, search)
        raw_r = p[:, 1] + PAD - half - 1.0 - br0
        raw_c = p[:, 0] + PAD - half - 1.0 - bc0
        ok_all &= (raw_r > -0.75) & (raw_r < lim + 0.75) & (raw_c > -0.75) & (raw_c < lim + 0.75)
        T, Ix, Iy, st = lk_kernels.lk_template_plain(blk, raw_r, raw_c, win)
        guess = lk_kernels.lk_iterate_plain(
            pyr1[lvl], T, Ix, Iy, st, guess + PAD, win, search, iters)[0] - PAD
        if lvl > 0:
            guess = guess * 2.0
    inside = ((guess[:, 0] >= 0) & (guess[:, 0] <= W - 1)
              & (guess[:, 1] >= 0) & (guess[:, 1] <= H - 1))
    return guess, valid & inside & ok_all & (st[:, 4] > 1e-4)


def check_track(pyr0, pyr1, pts, valid, win: int, iters: int):
    """Full 5-level track_cached through the kernels against the plain
    versions on the card: positions 1e-3 px, min_eig-driven status equal on
    >= 99.5 % of slots. ``valid`` marks the slots that hold a detected corner,
    as on the main path."""
    blocks = lk.capture_blocks(pyr0, pts, win=win)
    p_k, s_k, _ = lk.track_cached(blocks, pyr1, pts, valid, win=win, iters=iters)
    p_p, s_p = track_cached_plain(pyr0, pyr1, pts, valid, win, iters)
    torch.cuda.synchronize()
    both = s_k & s_p
    err = float((p_k - p_p).abs()[both].max()) if bool(both.any()) else float("nan")
    agree = float((s_k == s_p).float().mean())
    if not (err <= 1e-3):
        raise AssertionError(f"track_cached win={win}: positions differ by {err} px")
    if agree < 0.995:
        raise AssertionError(f"track_cached win={win}: status agrees on {agree:.4f}")
    moved = float((p_p - pts).norm(dim=1)[both].mean())
    return {"win": win, "pos_max_abs_err_px": err, "status_agree": agree,
            "tracked": int(both.sum()), "mean_flow_px": moved}


def check_min_eig(img0):
    r = min_eig.min_eig_response(img0)
    rp = min_eig.min_eig_response_plain(img0)
    torch.cuda.synchronize()
    err = float((r - rp).abs().max())
    if not torch.allclose(r, rp, rtol=1e-5, atol=1e-3):
        raise AssertionError(f"min_eig_response differs from plain by {err}")
    H, W = img0.shape
    b, by = bound(2 * H * W * 4, H * W * 60)
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: min_eig.min_eig_response(img0)),
        "plain_ms": time_ms(lambda: min_eig.min_eig_response_plain(img0)),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "bar": "rtol 1e-5, atol 1e-3 on a 0-255 image, whole image with border",
    }


def phase_kernels() -> dict:
    img0, pyr0, pyr1, pts, corner = kernel_inputs()
    res = {
        "capture_level": check_capture(pyr1, pts, win=21),
        "lk_template": check_lk_template(pyr0, pts, win=21, timed=True),
        "lk_iterate": check_lk_iterate(pyr0, pyr1, pts, win=21, iters=10, timed=True),
    }
    parity = {
        "lk_template": check_lk_template(pyr0, pts, win=32, timed=False),
        "lk_iterate": check_lk_iterate(pyr0, pyr1, pts, win=32, iters=10, timed=False),
    }
    res["min_eig_response"] = check_min_eig(img0)
    tracks = [check_track(pyr0, pyr1, pts, corner, 21, 10),
              check_track(pyr0, pyr1, pts, corner, 32, 10)]
    # what the events of one timed call cost by themselves; part of every `ms`
    events_only = time_ms(lambda: None)
    emit({"phase": "kernels", "shapes": {"N": N_FEAT, "image": SHAPE, "win": 21, "Rg": 55, "iters": 10},
          "events_only_ms": events_only,
          "timing": "ms: median of 20 single calls by CUDA events, L2 flushed and the stream kept busy "
                    "before each; warm_ms: the same around 10 calls back to back, per call",
          "results": res, "win32_Rg84": parity, "track_cached": tracks})
    return res


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


def path_length(pipe) -> float:
    """Ground-truth path length over the frames the run tracked."""
    off = pipe.init_offset
    n = min(len(pipe.t), len(pipe.gt_t) - off)
    return float(np.sum(np.linalg.norm(np.diff(pipe.gt_t[off : off + n], axis=0), axis=1)))


def phase_main(n_frames: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="pmv_smoke_") as tmp:
        t0 = time.perf_counter()
        seq = synthetic.make_sequence(
            n_frames=n_frames, shape=SHAPE, K=synthetic.KITTI_K, density=150.0,
            speed=1.0, yaw_rate=0.004, seed=0,
        )
        paths = synthetic.write_kitti_layout(seq, tmp)
        data_s = time.perf_counter() - t0
        def make_cfg(frames: int) -> VOConfig:
            return VOConfig(
                image_dir=paths["image_dir"],
                camera_calibration=paths["camera_calibration"],
                poses=paths["poses"],
                camera=0, frames=frames, init_frames=5,
                min_tracked_features=400, tracked_features_tol=150,
                bundle_size=5, max_iterations=5,
                feature_capacity=512, map_capacity=8192, verbose=0, seed=0,
                error_path=str(Path(tmp) / "errors.txt"),
            )

        # A short run first, so that the timed run does not pay for the start
        # of cuBLAS/cuSOLVER and the first trace of every operator.
        t0 = time.perf_counter()
        OdometryPipeline(make_cfg(WARMUP_FRAMES), device="cuda").run()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0

        cfg = make_cfg(n_frames)
        pipe = OdometryPipeline(cfg, device="cuda")
        reset_counts()
        result = pipe.run()
        torch.cuda.synchronize()
        launches = counts()
        error_file = (Path(tmp) / "errors.txt").read_text()

    stats = pipe.frame_stats
    n_pnp = sum(1 for s in stats if s["used_pnp"])
    n_boot = sum(1 for s in stats if not s["used_pnp"])
    n_reseed = sum(1 for s in stats if s["reseed"])
    ate, path = cli.rebased_ate(pipe), path_length(pipe)
    poses_finite = bool(np.isfinite(np.stack(pipe.t)).all() and np.isfinite(np.stack(pipe.R)).all())
    line = {
        "phase": "main_path",
        "config": {"image": SHAPE, "feature_capacity": cfg.feature_capacity,
                   "map_capacity": cfg.map_capacity, "lk_window": cfg.lk_window,
                   "lk_iters": cfg.lk_iters, "pyramid_images": cfg.lk_levels + 1,
                   "bundle_size": cfg.bundle_size, "ba_iters": cfg.max_iterations,
                   "chunk_frames": cfg.chunk_frames},
        "dataset_seconds": data_s,
        "warmup_frames": WARMUP_FRAMES, "warmup_seconds": warmup_s,
        "frames": result["frames"],
        "tracked_frames": len(stats),
        "runtime_s": result["runtime"],
        "ms_per_frame": result["runtime"] / max(len(stats), 1) * 1e3,
        "ba_calls": result["ba_calls"],
        "pnp_frames": n_pnp, "bootstrap_frames": n_boot, "reseed_frames": n_reseed,
        "ate_rebased_m": ate, "path_m": path, "t_total": result["t_total"],
        "poses_finite": poses_finite, "launches": launches,
    }
    emit(line)
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"a kernel was never launched on the main path: {launches}")
    # A tracked frame is two launches per pyramid image (template, iterate);
    # the capture kernel runs only at init and after a reseed.
    n_img = cfg.lk_levels + 1
    want = {"lk_template": n_img * len(stats), "lk_iterate": n_img * len(stats),
            "capture_level": n_img * (1 + n_reseed)}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"launch counts {got} are not {want}")
    if n_boot < 1 or n_pnp < 1 or result["ba_calls"] < 1:
        raise AssertionError("main path saw no bootstrap, no PnP frame or no BA call")
    if not poses_finite:
        raise AssertionError("non-finite poses")
    if not ate < 0.05 * path:
        raise AssertionError(f"rebased ATE {ate:.3f} m is not under 5 % of the {path:.1f} m path")
    if not error_file.startswith("Runtime: "):
        raise AssertionError("error file malformed")
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=45, help="synthetic frames of the main path")
    ap.add_argument("--ptxas", action="store_true", help="print nvcc's per-kernel resource usage")
    ap.add_argument("--skip-main", action="store_true", help="kernels phase only (for kernel work): prints no kernels summary and no ok line")
    args = ap.parse_args()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    if args.ptxas:
        lib = build.build(extra_flags=("-Xptxas", "-v"))
        print(build.build_log, flush=True)
        del lib
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds, "sources": list(build.SOURCES)})

    with torch.no_grad():
        res = phase_kernels()
        if args.skip_main:
            # no main-path run, so no launch counts: no summary and no verdict
            print(smi, flush=True)
            return 0
        launches = phase_main(args.frames)["launches"]

    kernels = []
    for name in WRAPPERS:
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda", "source": META[name][0],
            "replaces": META[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
