"""Minimal AVI video writer (uncompressed DIB frames), no external deps —
the port's copy of ``pmv_tpu/viz/video.py``.

The reference writes an MJPG ``.avi`` of the annotated frames after the run
(main.cpp:14-23 via cv::VideoWriter). No codec library is used: the frames
are stored uncompressed (BI_RGB bottom-up BGR24) in a standard RIFF/AVI
container any player accepts.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


class AVIWriter:
    """Write (H, W) grayscale or (H, W, 3) RGB uint8 frames to an AVI."""

    def __init__(self, path: str | Path, fps: int = 20):
        self.path = Path(path)
        self.fps = fps
        self.frames: list[bytes] = []
        self.shape: tuple[int, int] | None = None

    def add(self, frame: np.ndarray) -> None:
        if frame.dtype != np.uint8:
            frame = np.clip(frame, 0, 255).astype(np.uint8)
        if frame.ndim == 2:
            frame = np.stack([frame] * 3, axis=-1)
        H, W = frame.shape[:2]
        if self.shape is None:
            self.shape = (H, W)
        elif self.shape != (H, W):
            raise ValueError("frame size changed mid-video")
        bgr = frame[..., ::-1]  # RGB -> BGR
        # bottom-up rows, each padded to 4 bytes
        row_bytes = W * 3
        pad = (-row_bytes) % 4
        rows = [bgr[y].tobytes() + b"\x00" * pad for y in range(H - 1, -1, -1)]
        self.frames.append(b"".join(rows))

    def close(self) -> None:
        if self.shape is None:
            return
        H, W = self.shape
        n = len(self.frames)
        frame_size = len(self.frames[0])

        def chunk(tag: bytes, data: bytes) -> bytes:
            pad = b"\x00" if len(data) % 2 else b""
            return tag + struct.pack("<I", len(data)) + data + pad

        def lst(four: bytes, data: bytes) -> bytes:
            return chunk(b"LIST", four + data)

        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            1_000_000 // self.fps,  # us per frame
            frame_size * self.fps,  # max bytes/sec
            0, 0x10, n, 0, 1, frame_size, W, H, 0, 0, 0, 0,
        )
        strh = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh",
            b"vids", b"DIB ", 0, 0, 0, 0, 1, self.fps, 0, n,
            frame_size, 0xFFFFFFFF, 0, 0, 0, W, H,
        )
        strf = struct.pack("<IiiHHIIiiII", 40, W, H, 1, 24, 0, frame_size, 0, 0, 0, 0)
        hdrl = lst(
            b"hdrl",
            chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)),
        )
        movi_chunks = b"".join(chunk(b"00db", f) for f in self.frames)
        movi = lst(b"movi", movi_chunks)
        # idx1 index
        idx = b""
        offset = 4
        for f in self.frames:
            idx += b"00db" + struct.pack("<III", 0x10, offset, len(f))
            offset += 8 + len(f) + (len(f) % 2)
        body = hdrl + movi + chunk(b"idx1", idx)
        riff = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body
        self.path.write_bytes(riff)
        self.frames.clear()
