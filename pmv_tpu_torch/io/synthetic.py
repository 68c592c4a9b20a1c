"""Synthetic KITTI-like sequence generator.

The build/test environment has no KITTI download, so the framework generates
its own ground-truthed sequences: a 3D blob field rendered through a KITTI-
convention pinhole camera moving along a smooth forward trajectory. The
output can be materialized on disk as PNGs + ``calib.txt`` + ``poses.txt`` in
the exact layout the reference consumes (README.md:40-45), which lets every
end-to-end test exercise the same parsing/IO path as a real KITTI run.

Conventions: poses are KITTI ground-truth rows ``[R | t]`` = cam->world, with
the camera looking along +z. (The pipeline's internal world frame looks along
-z; the relation is the z-flip applied at OdometryPipeline.cpp:273-277.)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pmv_tpu_torch.io.png import write_png

KITTI_K = np.array(
    [[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]]
)
KITTI_SHAPE = (370, 1226)  # (H, W) of KITTI odometry grayscale frames


def make_trajectory(n_frames: int, speed: float = 1.0, yaw_rate: float = 0.004,
                    seed: int = 0, turn_every: int = 0, turn_len: int = 12,
                    turn_yaw: float = 0.06, stop_every: int = 0,
                    stop_len: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """Smooth forward trajectory: (R (T,3,3), t (T,3)) in KITTI convention.

    The camera drives forward (+z in its own frame) at ``speed`` m/frame,
    with a slowly varying yaw. Mimics KITTI 07 scale (~1 m/frame).

    ``turn_every`` > 0 inserts sharp alternating turns (KITTI-07-style
    intersections): every ``turn_every`` frames, ``turn_len`` frames of
    ``turn_yaw`` rad/frame extra yaw — the stress profile that exercises the
    motion gate and the reseed path the way real corners do.

    ``stop_every`` > 0 is the stop-go family (traffic lights): every
    ``stop_every`` frames the speed ramps to ~0 for ``stop_len`` frames then
    back up. Near-zero baselines starve triangulation and make the GT-scale
    step tiny — the regime the reference's motion gate exists for
    (OdometryPipeline.cpp:187-205).
    """
    rng = np.random.default_rng(seed)
    yaw = 0.0
    pos = np.zeros(3)
    Rs, ts = [], []
    # smooth yaw-rate noise
    rates = yaw_rate * np.cumsum(rng.normal(0, 0.3, n_frames))
    rates = rates - np.linspace(0, rates[-1], n_frames)
    turn = np.zeros(n_frames)
    if turn_every > 0:
        sign = 1.0
        k0 = turn_every
        while k0 < n_frames:
            turn[k0 : k0 + turn_len] = sign * turn_yaw
            sign = -sign
            k0 += turn_every + turn_len
    speed_k = np.full(n_frames, speed)
    if stop_every > 0:
        k0 = stop_every
        ramp = max(3, stop_len // 3)
        while k0 < n_frames:
            for i in range(ramp):  # decelerate
                if k0 - ramp + i >= 0 and k0 - ramp + i < n_frames:
                    speed_k[k0 - ramp + i] = speed * (1.0 - (i + 1) / (ramp + 1))
            speed_k[k0 : k0 + stop_len] = 0.02 * speed  # creeping stop
            for i in range(ramp):  # accelerate
                if k0 + stop_len + i < n_frames:
                    speed_k[k0 + stop_len + i] = speed * (i + 1) / (ramp + 1)
            k0 += stop_every + stop_len
    for k in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        Rs.append(R)
        ts.append(pos.copy())
        forward = R @ np.array([0.0, 0.0, 1.0])
        pos = pos + speed_k[k] * forward
        yaw += yaw_rate + rates[k] * 0.05 + turn[k]
    return np.stack(Rs), np.stack(ts)


def make_world(gt_R: np.ndarray, gt_t: np.ndarray, density: float = 60.0,
               seed: int = 0) -> np.ndarray:
    """Scatter 3D landmarks in a corridor around the trajectory.

    ``density`` points are seeded near every 5th camera position, offset
    laterally/vertically like building facades and road furniture.
    """
    rng = np.random.default_rng(seed + 1)
    pts = []
    for k in range(0, len(gt_t), 5):
        R, t = gt_R[k], gt_t[k]
        n = int(density)
        local = np.stack(
            [
                rng.uniform(-25, 25, n),       # lateral
                rng.uniform(-4, 6, n),         # vertical
                rng.uniform(4, 60, n),         # depth ahead
            ],
            axis=-1,
        )
        # keep points away from the camera axis so they project off-center too
        pts.append(local @ R.T + t)
    return np.concatenate(pts, axis=0)


def render_frame(
    K: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    world: np.ndarray,
    shape: tuple[int, int] = (192, 640),
    point_ids: np.ndarray | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Render a float32 grayscale frame by splatting Gaussian blobs at the
    projections of ``world`` points (standard pinhole: ``X_c = R^T (X_w - t)``,
    visible iff ``z_c > 0``)."""
    H, W = shape
    Xc = (world - t) @ R
    z = Xc[:, 2]
    vis = z > 0.5
    u = np.where(vis, Xc[:, 0] / np.where(vis, z, 1.0) * K[0, 0] + K[0, 2], -1)
    v = np.where(vis, Xc[:, 1] / np.where(vis, z, 1.0) * K[1, 1] + K[1, 2], -1)
    r = 3
    inb = vis & (u > r) & (u < W - r - 1) & (v > r) & (v < H - r - 1)
    img = np.zeros((H, W), np.float32)
    # deterministic per-point appearance
    if point_ids is None:
        point_ids = np.arange(len(world))
    amp = 80.0 + (point_ids % 97) * 1.5
    sig = 1.0 + (point_ids % 7) * 0.12
    ui, vi = u[inb], v[inb]
    ai, si = amp[inb], sig[inb]
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    for k in range(len(ui)):
        cx, cy = ui[k], vi[k]
        ix, iy = int(np.floor(cx)), int(np.floor(cy))
        dx, dy = cx - ix, cy - iy
        patch = ai[k] * np.exp(-(((xx - dx) ** 2 + (yy - dy) ** 2) / (2 * si[k] ** 2)))
        img[iy - r : iy + r + 1, ix - r : ix + r + 1] += patch
    # low-frequency background so flat regions still have mild gradient
    gy = np.linspace(0, 20, H)[:, None]
    gx = np.linspace(0, 10, W)[None, :]
    img += gy + gx
    return np.clip(img, 0, 255.0)


def apply_stressors(
    img: np.ndarray,
    frame_idx: int,
    n_frames: int,
    occluders: int = 0,
    noise_std: float = 0.0,
    flicker: float = 0.0,
    exposure_drift: float = 0.0,
    vignette: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Photometric + occlusion stress on a rendered frame.

    - ``occluders``: N texture-less rectangles sweeping across the view
      (passing vehicles/poles) — they blank tracked features wholesale and
      force the reseed path (tracked < tracked_features_tol).
    - ``noise_std``: per-pixel Gaussian sensor noise (independent per frame).
    - ``flicker``: sinusoidal global gain variation (auto-exposure hunting),
      +-``flicker`` fractional amplitude.
    - ``exposure_drift``: slow monotonic gain ramp over the run (sun rising /
      auto-exposure trend): gain goes 1 -> 1+drift linearly in frame_idx.
      Violates LK's brightness-constancy assumption cumulatively.
    - ``vignette``: radial gain falloff, ``1 - vignette*(r/r_max)^2`` — a
      static lens effect that modulates patch appearance as features travel
      outward (SSD/LK see a slowly changing template).
    Deterministic given (seed, frame_idx).
    """
    H, W = img.shape
    out = img.copy()
    if flicker > 0:
        out *= 1.0 + flicker * np.sin(2 * np.pi * frame_idx / 17.0)
    if exposure_drift != 0.0:
        out *= 1.0 + exposure_drift * frame_idx / max(n_frames - 1, 1)
    if vignette > 0:
        yy = (np.arange(H) - H / 2.0)[:, None] / (H / 2.0)
        xx = (np.arange(W) - W / 2.0)[None, :] / (W / 2.0)
        out *= 1.0 - vignette * np.clip((yy**2 + xx**2) / 2.0, 0, 1)
    for j in range(occluders):
        # constant-velocity sweep, staggered starts, wrapping
        w = W // 6 + 13 * j % (W // 8)
        h = H // 2 + 7 * j % (H // 4)
        speed_px = 0.6 * W / max(n_frames, 1) * (1.5 + 0.5 * j)
        x0 = int((j * W / max(occluders, 1) + frame_idx * speed_px) % (W + w)) - w
        y0 = int(H * 0.15 + (j * 29) % max(H // 3, 1))
        xa, xb = max(x0, 0), min(x0 + w, W)
        ya, yb = max(y0, 0), min(y0 + h, H)
        if xb > xa and yb > ya:
            out[ya:yb, xa:xb] = 12.0  # flat, textureless
    if noise_std > 0:
        rng = np.random.default_rng((seed * 100003 + frame_idx) & 0x7FFFFFFF)
        out += rng.normal(0, noise_std, out.shape)
    return np.clip(out, 0, 255.0)


def make_sequence(
    n_frames: int = 30,
    shape: tuple[int, int] = (192, 640),
    K: np.ndarray | None = None,
    speed: float = 1.0,
    yaw_rate: float = 0.004,
    density: float = 60.0,
    seed: int = 0,
    turn_every: int = 0,
    turn_len: int = 12,
    turn_yaw: float = 0.06,
    stop_every: int = 0,
    stop_len: int = 10,
    occluders: int = 0,
    noise_std: float = 0.0,
    flicker: float = 0.0,
    exposure_drift: float = 0.0,
    vignette: float = 0.0,
) -> dict:
    """In-memory synthetic sequence: images (T,H,W) f32, gt_R, gt_t, K, world.

    The stress knobs (``turn_every``/``occluders``/``noise_std``/``flicker``)
    default to off — the smooth corridor remains the throughput benchmark;
    the stress profile exercises the motion gate, reseed, and BA robustness
    the way KITTI 07's corners and traffic do.
    """
    H, W = shape
    if K is None:
        K = np.array(
            [[0.6 * W, 0.0, W / 2.0], [0.0, 0.6 * W, H / 2.0], [0.0, 0.0, 1.0]]
        )
    gt_R, gt_t = make_trajectory(
        n_frames, speed=speed, yaw_rate=yaw_rate, seed=seed,
        turn_every=turn_every, turn_len=turn_len, turn_yaw=turn_yaw,
        stop_every=stop_every, stop_len=stop_len,
    )
    world = make_world(gt_R, gt_t, density=density, seed=seed)
    ids = np.arange(len(world))
    imgs = []
    any_photo = (
        occluders or noise_std > 0 or flicker > 0
        or exposure_drift != 0.0 or vignette > 0
    )
    for k in range(n_frames):
        img = render_frame(K, gt_R[k], gt_t[k], world, shape, ids, seed)
        if any_photo:
            img = apply_stressors(
                img, k, n_frames,
                occluders=occluders, noise_std=noise_std, flicker=flicker,
                exposure_drift=exposure_drift, vignette=vignette,
                seed=seed,
            )
        imgs.append(img)
    return {"images": np.stack(imgs), "gt_R": gt_R, "gt_t": gt_t, "K": K, "world": world}


def write_kitti_layout(seq: dict, out_dir: str | Path) -> dict[str, str]:
    """Materialize a synthetic sequence in the on-disk layout the reference
    consumes: image_0/NNNNNN.png, calib.txt (P0..P3 lines), poses.txt."""
    out = Path(out_dir)
    img_dir = out / "image_0"
    img_dir.mkdir(parents=True, exist_ok=True)
    for k, img in enumerate(seq["images"]):
        write_png(img_dir / f"{k:06d}.png", img.astype(np.uint8))
    K = seq["K"]
    P = np.concatenate([K, np.zeros((3, 1))], axis=1).reshape(-1)
    p_line = " ".join(f"{v:.12e}" for v in P)
    calib = "\n".join(f"P{i}: {p_line}" for i in range(4)) + "\n"
    (out / "calib.txt").write_text(calib)
    lines = []
    for R, t in zip(seq["gt_R"], seq["gt_t"]):
        M = np.concatenate([R, t[:, None]], axis=1).reshape(-1)
        lines.append(" ".join(f"{v:.12e}" for v in M))
    (out / "poses.txt").write_text("\n".join(lines) + "\n")
    return {
        "image_dir": str(img_dir),
        "camera_calibration": str(out / "calib.txt"),
        "poses": str(out / "poses.txt"),
    }
