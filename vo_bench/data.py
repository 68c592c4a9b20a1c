"""The cell's recorded drive, made from the seed by the benchmark's own
scene generator and kept in a cache inside the checkout, keyed by the
traffic's scene, its length and the seed. Users have their drives on disk
already, so making one is not part of the program's set-up."""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
import struct
import zlib
from pathlib import Path

import numpy as np

from vo_bench import scene
from vo_bench.png import write_png

DATA_ROOT = Path(__file__).resolve().parent / "data"


def read_png(path: Path) -> np.ndarray:
    """An 8-bit grayscale PNG as :mod:`vo_bench.png` writes it (filter 0)."""
    raw = Path(path).read_bytes()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos: pos + 4])
        tag, body = raw[pos + 4: pos + 8], raw[pos + 8: pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)[:, 1:]


def scene_kwargs(traffic: dict) -> dict:
    sc = dict(traffic["scene"])
    if sc.pop("K", "kitti") == "kitti":
        sc["K"] = scene.KITTI_K
    sc["shape"] = tuple(sc["shape"])
    return sc


def materialize(traffic: dict, seed: int, root: Path = DATA_ROOT) -> tuple[dict, np.ndarray]:
    """The drive of ``traffic`` for ``seed`` in the KITTI layout: its paths
    and its frames (T, H, W) uint8 as written. Made once per key; a
    directory is complete when its ``ok`` marker exists."""
    frames = int(traffic["frames"])
    key = json.dumps({"scene": traffic["scene"], "frames": frames}, sort_keys=True)
    tag = hashlib.sha256(key.encode()).hexdigest()[:10]
    d = Path(root) / f"{traffic['scene'].get('family', 'scene')}_{frames}_{seed}_{tag}"
    paths = {"image_dir": str(d / "image_0"), "camera_calibration": str(d / "calib.txt"),
             "poses": str(d / "poses.txt")}
    if (d / "ok").exists():
        imgs = np.stack([read_png(d / "image_0" / f"{k:06d}.png") for k in range(frames)])
        return paths, imgs
    kw = scene_kwargs(traffic)
    kw.pop("family", None)
    imgs = _render(frames, seed, kw, d)
    K = kw.get("K")
    scene.write_calib_and_poses(K if K is not None else scene.default_K(kw["shape"]),
                                *_trajectory(frames, seed, kw), d)
    (d / "ok").touch()
    return paths, imgs


_TRAJ_KEYS = ("speed", "yaw_rate", "turn_every", "turn_len", "turn_yaw", "stop_every", "stop_len")
_PHOTO_KEYS = ("occluders", "noise_std", "flicker", "exposure_drift", "vignette")


def _trajectory(frames: int, seed: int, kw: dict):
    return scene.make_trajectory(frames, seed=seed, **{k: kw[k] for k in _TRAJ_KEYS if k in kw})


def _render_range(job) -> list:
    """Frames ``ks`` of the sequence, each written as a PNG and returned as
    uint8 (a thread's share of :func:`_render`)."""
    ks, seed, kw, world, gt_R, gt_t, img_dir = job
    shape = kw["shape"]
    K = kw.get("K")
    K = K if K is not None else scene.default_K(shape)
    photo = {k: kw[k] for k in _PHOTO_KEYS if k in kw}
    out = []
    for k in ks:
        img = scene.render_frame(K, gt_R[k], gt_t[k], world, shape, np.arange(len(world)), seed)
        if any(photo.values()):
            img = scene.apply_stressors(img, k, len(gt_t), seed=seed, **photo)
        img = img.astype(np.uint8)
        write_png(Path(img_dir) / f"{k:06d}.png", img)
        out.append(img)
    return out


def _render(frames: int, seed: int, kw: dict, d: Path) -> np.ndarray:
    """The frames of the port's ``io.synthetic.make_sequence(frames,
    seed=seed, **kw)``: its trajectory and world, each frame rendered (and
    its stressors applied) as there, by up to 8 threads (numpy and zlib release the interpreter
    lock) and written to ``d/image_0``."""
    gt_R, gt_t = _trajectory(frames, seed, kw)
    world = scene.make_world(gt_R, gt_t, density=kw.get("density", 60.0), seed=seed)
    img_dir = d / "image_0"
    img_dir.mkdir(parents=True, exist_ok=True)
    n = max(1, min(8, os.cpu_count() or 1, frames // 16))
    jobs = [(list(range(i, frames, n)), seed, kw, world, gt_R, gt_t, str(img_dir)) for i in range(n)]
    with ThreadPoolExecutor(n) as pool:
        parts = list(pool.map(_render_range, jobs))
    imgs = [None] * frames
    for i, part in enumerate(parts):
        for j, img in enumerate(part):
            imgs[i + j * n] = img
    return np.stack(imgs)
