"""3D point-cloud export (numpy; the port's copy of
``pmv_tpu/viz/pointcloud.py``) — offline replacement for the reference's dlib
perspective window (OdometryPipeline.cpp:298-326).

The reference filters far-away points before display: any landmark with a
coordinate beyond 4x the per-axis median magnitude is skimmed
(:309-317). The same filter is applied here, and the result is written as a
standard ASCII PLY any viewer opens.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def median_skim(points: np.ndarray) -> np.ndarray:
    """Reference skim: drop points with |coord| > 4 * median(|coord|) on any
    axis (OdometryPipeline.cpp:309-317)."""
    if len(points) == 0:
        return points
    med = np.median(np.abs(points), axis=0)
    keep = (np.abs(points) <= 4.0 * np.abs(med)).all(axis=1)
    return points[keep]


def write_ply(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    points = np.asarray(points, np.float32)
    n = len(points)
    header = [
        "ply",
        "format ascii 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    lines = ["\n".join(header)]
    for i in range(n):
        row = f"{points[i,0]:.4f} {points[i,1]:.4f} {points[i,2]:.4f}"
        if colors is not None:
            c = colors[i]
            row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
        lines.append(row)
    Path(path).write_text("\n".join(lines) + "\n")


def export_map(pipe, path: str | Path) -> int:
    """Write the live landmark map (median-skimmed) as PLY, read back from
    the pipeline's device. Returns the number of exported points."""
    alive = pipe.map.alive.cpu().numpy()
    pts = pipe.map.xyz.cpu().numpy()[alive]
    pts = median_skim(pts)
    write_ply(path, pts)
    return len(pts)
