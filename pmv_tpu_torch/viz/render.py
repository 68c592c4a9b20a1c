"""Trajectory-map and frame-annotation rendering (numpy raster) — the
port's copy of ``pmv_tpu/viz/render.py``.

Offline replacements for the reference's live GUI output: ``drawMap``
(OdometryPipeline.cpp:104-169 — 511x511 top-down map, landmark dots colored
by image side, green estimated path/pose rectangle, red ground truth) and
the per-frame feature crosses (``drawCross``, :93-102). A headless TPU run
renders the same artifacts to PNG/AVI instead of cv::imshow windows.

The drawing code works on numpy arrays only; :func:`save_run_visuals` reads
the pipeline's tensors back with ``.cpu().numpy()`` once, at its start.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

GREEN = (0, 255, 0)
RED = (255, 0, 0)
MAGENTA = (255, 0, 255)
CYAN = (0, 255, 255)

MAP_SIZE = 511  # reference map canvas (OdometryPipeline.cpp:107)


def _put(img: np.ndarray, r, c, color) -> None:
    H, W = img.shape[:2]
    r = np.asarray(r, int).reshape(-1)
    c = np.asarray(c, int).reshape(-1)
    ok = (r >= 0) & (r < H) & (c >= 0) & (c < W)
    img[r[ok], c[ok]] = color


def draw_cross(img: np.ndarray, row: int, col: int, color, radius: int = 3) -> None:
    """Reference drawCross (OdometryPipeline.cpp:93-102)."""
    rr = np.arange(-radius + 1, radius)
    _put(img, np.full_like(rr, row), col + rr, color)
    _put(img, row + rr, np.full_like(rr, col), color)


def draw_circle(img: np.ndarray, row: float, col: float, radius: int, color) -> None:
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    m = yy**2 + xx**2 <= radius**2
    _put(img, row + yy[m], col + xx[m], color)


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Line segment between (col, row) endpoints (dense sampling raster)."""
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = max(2, int(2 * max(abs(x1 - x0), abs(y1 - y0))) + 1)
    ts = np.linspace(0.0, 1.0, n)
    _put(img, np.rint(y0 + ts * (y1 - y0)), np.rint(x0 + ts * (x1 - x0)), color)


def _y_rotation(R: np.ndarray, flip: bool = False) -> float:
    """Reference calcYRotation (include/OdometryPipeline.h:89-108): yaw from
    R[0,0]/R[0,2] with the sign convention selected by ``flip``."""
    import math

    c = float(np.clip(R[0][0], -1.0, 1.0))
    s = float(R[0][2])
    ang = math.acos(c)
    if flip:
        return -ang if s <= 0 else ang
    return ang if s <= 0 else -ang


def draw_rotated_rect(
    img: np.ndarray, center, size, angle_deg: float, color
) -> None:
    """Rotated rectangle outline, vertex layout exactly as
    cv::RotatedRect::points (the reference draws its pose markers with it,
    OdometryPipeline.cpp:130-148): ``angle_deg`` clockwise, ``size`` =
    (width, height), center in (col, row)."""
    import math

    ang = angle_deg * math.pi / 180.0
    b = math.cos(ang) * 0.5
    a = math.sin(ang) * 0.5
    w, h = float(size[0]), float(size[1])
    cx, cy = float(center[0]), float(center[1])
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (2 * cx - p0[0], 2 * cy - p0[1])
    p3 = (2 * cx - p1[0], 2 * cy - p1[1])
    pts = [p0, p1, p2, p3]
    for i in range(4):
        draw_line(img, pts[i], pts[(i + 1) % 4], color)


def _draw_pose_rects(
    m: np.ndarray,
    t_est,
    gt_t,
    R_est,
    gt_R,
    init_offset: int,
    map_scale: float,
) -> None:
    """Estimated (green) and ground-truth (red) rotated pose rectangles for
    the LAST trajectory entry, exactly as OdometryPipeline.cpp:130-148:
    10x15 rect, yaw from calcYRotation, and the reference's own quirks kept —
    the position casts the coordinate to int BEFORE scaling, and the GT
    rectangle's rotation reads gt_R[j] (trajectory index, NOT offset by
    init_offset, unlike its position)."""
    cx = MAP_SIZE // 2
    cy = int(MAP_SIZE / 1.2)
    j = len(t_est) - 1
    if j < 0 or R_est is None:
        return
    x = cx + int(t_est[j][0]) * map_scale
    y = cy + int(t_est[j][2]) * map_scale
    ang = _y_rotation(np.asarray(R_est[j])) / 3.1416 * 180.0
    draw_rotated_rect(m, (x, y), (10, 15), ang, GREEN)
    g = j + init_offset
    if gt_R is not None and g < len(gt_t) and j < len(gt_R):
        x = cx + int(gt_t[g][0]) * map_scale
        y = cy - int(gt_t[g][2]) * map_scale
        ang = _y_rotation(np.asarray(gt_R[j]), flip=True) / 3.1416 * 180.0
        draw_rotated_rect(m, (x, y), (10, 15), ang, RED)


def draw_map(
    t_est: np.ndarray,
    gt_t: np.ndarray,
    init_offset: int,
    map_scale: float,
    landmarks: np.ndarray | None = None,
    landmark_cols: np.ndarray | None = None,
    img_width: int = 1226,
    R_est: np.ndarray | None = None,
    gt_R: np.ndarray | None = None,
) -> np.ndarray:
    """Top-down map (MAP_SIZE x MAP_SIZE x 3 uint8) in the reference's frame:
    x -> map column from center, z -> map row from rows/1.2 (estimate uses
    +z, ground truth -z, exactly as OdometryPipeline.cpp:131-168). When
    ``R_est``/``gt_R`` are given, the current-pose rotated rectangles are
    drawn (:130-148)."""
    m = np.zeros((MAP_SIZE, MAP_SIZE, 3), np.uint8)
    cx = MAP_SIZE // 2
    cy = int(MAP_SIZE / 1.2)

    if landmarks is not None and len(landmarks):
        cols = (
            landmark_cols
            if landmark_cols is not None
            else np.zeros(len(landmarks))
        )
        color_sel = cols > img_width / 2
        r = cy + (landmarks[:, 2] * map_scale).astype(int)
        c = cx + (landmarks[:, 0] * map_scale).astype(int)
        _put(m, r[color_sel], c[color_sel], MAGENTA)
        _put(m, r[~color_sel], c[~color_sel], CYAN)

    _draw_pose_rects(m, t_est, gt_t, R_est, gt_R, init_offset, map_scale)

    j = len(t_est) - 1
    for i in range(j + 1):
        # Reference path tracing casts the coordinate to int BEFORE scaling
        # (OdometryPipeline.cpp:152-167) — bug-compatible on purpose.
        draw_circle(m, cy + int(t_est[i][2]) * map_scale, cx + int(t_est[i][0]) * map_scale, 1, GREEN)
        g = i + init_offset
        if g < len(gt_t):
            draw_circle(m, cy - int(gt_t[g][2]) * map_scale, cx + int(gt_t[g][0]) * map_scale, 1, RED)
    return m


def annotate_frame(
    img: np.ndarray,
    xy: np.ndarray,
    valid: np.ndarray,
    img_width: int | None = None,
) -> np.ndarray:
    """Feature crosses on a grayscale frame, colored by image side like the
    reference (OdometryPipeline.cpp:117-124)."""
    W = img_width or img.shape[1]
    rgb = np.stack([np.clip(img, 0, 255).astype(np.uint8)] * 3, axis=-1)
    for (u, v), ok in zip(np.asarray(xy), np.asarray(valid)):
        if not ok:
            continue
        color = MAGENTA if u > W / 2 else CYAN
        draw_cross(rgb, int(v), int(u), color)
    return rgb


class LiveMapRenderer:
    """Per-frame trajectory map, replayed exactly like the reference draws it
    while running (drawMap is called once per processed frame,
    OdometryPipeline.cpp:413): frame k's map shows the path prefix [0, k],
    the pose rectangles at k, and the landmark dots. The path prefix is
    accumulated incrementally (the redrawn circles are identical every
    frame), so a full replay is O(n) circles, not O(n^2)."""

    def __init__(self, pipe):
        self.t = [np.asarray(x) for x in pipe.t]
        self.R = [np.asarray(x) for x in pipe.R]
        self.gt_t = pipe.gt_t
        self.gt_R = pipe.gt_R
        self.off = pipe.init_offset
        self.scale = pipe.cfg.map_scale
        self.base = np.zeros((MAP_SIZE, MAP_SIZE, 3), np.uint8)
        self.k = -1

    def render(self, k: int, landmarks=None, landmark_cols=None,
               img_width: int = 1226) -> np.ndarray:
        """Map as of trajectory entry ``k`` (monotonically increasing)."""
        cx = MAP_SIZE // 2
        cy = int(MAP_SIZE / 1.2)
        k = min(k, len(self.t) - 1)
        while self.k < k:
            self.k += 1
            i = self.k
            draw_circle(self.base, cy + int(self.t[i][2]) * self.scale,
                        cx + int(self.t[i][0]) * self.scale, 1, GREEN)
            g = i + self.off
            if g < len(self.gt_t):
                draw_circle(self.base, cy - int(self.gt_t[g][2]) * self.scale,
                            cx + int(self.gt_t[g][0]) * self.scale, 1, RED)
        m = self.base.copy()
        if landmarks is not None and len(landmarks):
            cols = landmark_cols if landmark_cols is not None else np.zeros(len(landmarks))
            sel = cols > img_width / 2
            r = cy + (landmarks[:, 2] * self.scale).astype(int)
            c = cx + (landmarks[:, 0] * self.scale).astype(int)
            _put(m, r[sel], c[sel], MAGENTA)
            _put(m, r[~sel], c[~sel], CYAN)
        _draw_pose_rects(m, self.t[: k + 1], self.gt_t, self.R[: k + 1],
                         self.gt_R, self.off, self.scale)
        return m


def _host_tables(pipe):
    """Every frame's (xy, valid, landmark) table as numpy arrays, read back
    in one transfer each."""
    if not pipe.tables:
        return None, None, None
    return tuple(
        torch.stack([getattr(tb, f) for tb in pipe.tables]).cpu().numpy()
        for f in ("xy", "valid", "landmark")
    )


def save_run_visuals(pipe, out_dir: str | Path | None = None) -> dict:
    """Post-run artifacts: trajectory map PNG and point cloud PLY (+ AVI
    when video_path is set)."""
    from pmv_tpu_torch.io.png import write_png
    from pmv_tpu_torch.viz.pointcloud import export_map

    out = Path(out_dir) if out_dir else Path(pipe.cfg.error_path or ".").parent
    out.mkdir(parents=True, exist_ok=True)
    map_xyz = pipe.map.xyz.cpu().numpy()
    map_alive = pipe.map.alive.cpu().numpy()
    m = draw_map(
        [np.asarray(x) for x in pipe.t],
        pipe.gt_t,
        pipe.init_offset,
        pipe.cfg.map_scale,
        landmarks=map_xyz[map_alive],
        R_est=[np.asarray(x) for x in pipe.R],
        gt_R=pipe.gt_R,
    )
    map_path = out / "map.png"
    write_png(map_path, m)
    artifacts = {"map": str(map_path)}

    ply_path = out / "pointcloud.ply"
    n_pts = export_map(pipe, ply_path)
    artifacts["pointcloud"] = str(ply_path)
    artifacts["pointcloud_points"] = n_pts

    if pipe.cfg.video_path:
        from pmv_tpu_torch.io.prefetch import FramePrefetcher
        from pmv_tpu_torch.viz.video import AVIWriter

        writer = AVIWriter(pipe.cfg.video_path, fps=10)
        start = pipe.init_offset
        stop = min(pipe.cfg.frames, len(pipe.file_names))
        live = LiveMapRenderer(pipe) if pipe.cfg.fancy_video else None
        txy, tvalid, tlm = _host_tables(pipe)
        # Per-frame landmark POSITIONS: the fused run snapshots map.xyz at BA
        # cadence (StepState.map_hist), so the replay can draw frame k's dots
        # where they were THEN — matching drawMap's read-at-draw-time
        # semantics (OdometryPipeline.cpp:110-127) to within one cadence
        # group. Runs without the history (modular loop, map_hist=0) fall
        # back to the final optimized coordinates.
        hist = getattr(pipe, "map_hist", None)
        hist_cad = max(1, getattr(pipe, "map_hist_cadence", 1))
        for idx, img in FramePrefetcher(pipe.file_names[start:stop]):
            k = idx  # trajectory index
            if k >= len(pipe.t):
                break
            # Reference drawMap iterates the CURRENT frame's feature->landmark
            # associations (fr.map, OdometryPipeline.cpp:110-127): crosses on
            # the frame and map dots only for features bound to a live
            # landmark, colored by the feature's image side.
            lm_k = cols_k = None
            if txy is not None and k < len(txy):
                xy = txy[k]
                lm = tlm[k]
                bound = tvalid[k] & (lm >= 0)
                bound[bound] &= map_alive[lm[bound]]
                frame = annotate_frame(img, xy, bound)
                xyz_k = (
                    hist[min(k // hist_cad, len(hist) - 1)]
                    if hist is not None and len(hist)
                    else map_xyz
                )
                lm_k = xyz_k[lm[bound]]
                cols_k = xy[bound, 0]
            else:
                frame = np.stack([np.clip(img, 0, 255).astype(np.uint8)] * 3, -1)
            if pipe.cfg.fancy_video:
                # Reference fancy_video: alpha-blend the LIVE per-frame map
                # into a square region of the frame
                # (OdometryPipeline.cpp:413-422, alpha 0.75).
                mk = live.render(k, landmarks=lm_k, landmark_cols=cols_k,
                                 img_width=img.shape[1])
                side = min(frame.shape[0], frame.shape[1])
                # nearest-neighbor resize of the map to (side, side)
                ys = (np.arange(side) * (mk.shape[0] / side)).astype(int)
                xs = (np.arange(side) * (mk.shape[1] / side)).astype(int)
                m_small = mk[ys][:, xs]
                roi = frame[:side, :side].astype(np.float32)
                frame[:side, :side] = np.clip(
                    0.75 * m_small + 0.25 * roi, 0, 255
                ).astype(np.uint8)
            writer.add(frame)
        writer.close()
        artifacts["video"] = pipe.cfg.video_path
    return artifacts
