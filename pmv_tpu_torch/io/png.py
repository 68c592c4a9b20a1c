"""Minimal pure-Python PNG codec (8-bit grayscale / RGB), no external deps.

The reference leans on OpenCV's ``imread`` (Frame.cpp:33). This image has no
cv2/PIL, so the framework ships its own codec: this pure-Python fallback plus
a multithreaded C++ decoder (``native/``) for the hot ingest path. Decoding
here is numpy-vectorized for filter types 0/1/2 (what our encoder and most
tools emit); 3/4 fall back to a per-row scalar loop.
"""

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


def read_png(path: str | Path) -> np.ndarray:
    """Read an 8-bit PNG to (H, W) grayscale or (H, W, C) uint8."""
    data = Path(path).read_bytes()
    if data[:8] != _SIG:
        raise ValueError(f"Not a PNG file: {path}")
    pos = 8
    idat = bytearray()
    w = h = bit_depth = color_type = interlace = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.extend(body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IEND":
            break
    if bit_depth != 8 or interlace != 0:
        raise ValueError(f"Unsupported PNG (bit_depth={bit_depth}, interlace={interlace})")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    stride = w * channels
    raw = raw.reshape(h, stride + 1)
    filters = raw[:, 0]
    rows = raw[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    bpp = channels
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, row = int(filters[y]), rows[y]
        if f == 0:
            recon = row
        elif f == 1:  # sub: cumsum per byte-lane (left dependency only)
            recon = row.reshape(-1, bpp).cumsum(axis=0).reshape(-1) % 256
        elif f == 2:  # up
            recon = (row + prev) % 256
        elif f == 3:  # average
            recon = row.copy()
            for x in range(stride):
                left = recon[x - bpp] if x >= bpp else 0
                recon[x] = (recon[x] + ((left + prev[x]) >> 1)) % 256
        elif f == 4:  # paeth
            recon = row.copy()
            for x in range(stride):
                a = recon[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                recon[x] = (recon[x] + pred) % 256
        else:
            raise ValueError(f"Bad PNG filter {f}")
        out[y] = recon
        prev = recon
    img = out.astype(np.uint8).reshape(h, w, channels)
    if color_type == 3:
        img = palette[img[..., 0]]
    if img.shape[2] == 1:
        img = img[..., 0]
    return img


def load_grayscale(path: str | Path) -> np.ndarray:
    """Load an image as float32 grayscale in [0, 255].

    Color images are converted with the BGR2GRAY weights the reference
    inherits from OpenCV (Frame.cpp:41): 0.299 R + 0.587 G + 0.114 B.
    """
    p = Path(path)
    if p.suffix == ".npy":
        img = np.load(p)
    else:
        img = read_png(p)
    if img.ndim == 3:
        img = (
            0.299 * img[..., 0].astype(np.float32)
            + 0.587 * img[..., 1].astype(np.float32)
            + 0.114 * img[..., 2].astype(np.float32)
        )
    return np.ascontiguousarray(img, dtype=np.float32)
