"""KITTI odometry dataset parsing with the reference's exact semantics.

- :func:`parse_calibration` mirrors OdometryPipeline.cpp:596-658: take line
  ``camera_id`` of calib.txt, read the 3x4 projection matrix, keep its left
  3x3 block as the camera matrix K (the 4th column / baseline is dropped).
- :func:`parse_poses` mirrors OdometryPipeline.cpp:525-594: each line is a
  row-major 3x4 ``[R | t]``; at most ``stop`` rows are read.
- :func:`list_images` mirrors the ``cv::glob(image_dir)`` call
  (OdometryPipeline.cpp:62): sorted file listing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pmv_tpu_torch.config import OdometryPipelineException


def parse_calibration(path: str | Path, camera_id: int) -> np.ndarray:
    p = Path(path)
    if not p.is_file():
        raise OdometryPipelineException("Unable to open calibration file")
    lines = p.read_text().splitlines()
    if camera_id >= len(lines):
        raise OdometryPipelineException(f"No calibration line {camera_id}")
    tokens = lines[camera_id].split()
    # tokens[0] is the "P0:" label; the next 12 are the row-major 3x4 P.
    vals = [float(t) for t in tokens[1:13]]
    P = np.asarray(vals, dtype=np.float64).reshape(3, 4)
    return P[:, :3].copy()


def parse_poses(path: str | Path, stop: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Returns (gt_R (T,3,3), gt_t (T,3)) reading at most ``stop`` lines."""
    p = Path(path)
    if not p.is_file():
        raise OdometryPipelineException("Unable to open pose file")
    Rs, ts = [], []
    for k, line in enumerate(p.read_text().splitlines()):
        if stop is not None and k >= stop:
            break
        vals = np.asarray([float(v) for v in line.split()], dtype=np.float64)
        P = vals.reshape(3, 4)
        Rs.append(P[:, :3])
        ts.append(P[:, 3])
    return np.stack(Rs), np.stack(ts)


def list_images(image_dir: str | Path) -> list[Path]:
    d = Path(image_dir)
    if not d.is_dir():
        raise OdometryPipelineException(f"Image directory not found: {image_dir}")
    exts = {".png", ".jpg", ".jpeg", ".pgm", ".ppm", ".npy"}
    return sorted(p for p in d.iterdir() if p.suffix.lower() in exts)
