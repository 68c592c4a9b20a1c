"""An 8-bit grayscale PNG writer (filter 0, zlib level 6): a frozen copy of
the port's ``io/png.py`` writer, so that the frames a run writes do not
depend on the program."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write an 8-bit grayscale (H, W) or RGB (H, W, 3) PNG (filter 0)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        color_type, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"Unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = np.concatenate(
        [
            np.zeros((h, 1), np.uint8),  # filter byte 0 per scanline
            img.reshape(h, w * channels),
        ],
        axis=1,
    ).tobytes()
    data = _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")
    Path(path).write_bytes(data)
