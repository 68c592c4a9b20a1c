"""ctypes bindings for the native C++ frame decoder (``native/``) — the
port's copy of ``pmv_tpu/io/native.py``.

The reference's hot ingest path is OpenCV's C++ ``imread`` inside the
producer thread (Frame.cpp:33, OdometryPipeline.cpp:216). Here the
equivalent is the repo's small C++ library (``native/frame_loader.cpp``, a
zlib-based PNG decoder), loaded via ctypes from the committed
``native/libframe_loader.so``. ``available()`` is False when it does not
load (not built, or its C library or zlib missing); the pure-Python codec
then takes over. Host ingest only: nothing here touches the device.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_LIB_PATHS = [Path(__file__).resolve().parents[2] / "native" / "libframe_loader.so"]


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for p in _LIB_PATHS:
        if p.is_file():
            try:
                lib = ctypes.CDLL(str(p))
                lib.fl_decode_gray.restype = ctypes.c_int
                lib.fl_decode_gray.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                ]
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    return _load() is not None


_MAX_PIXELS = 4096 * 4096


def load_grayscale(path: str | Path) -> np.ndarray:
    """Decode an 8-bit PNG to float32 grayscale via the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native frame loader not built")
    buf = np.empty(_MAX_PIXELS, dtype=np.float32)
    h = ctypes.c_int(0)
    w = ctypes.c_int(0)
    rc = lib.fl_decode_gray(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _MAX_PIXELS,
        ctypes.byref(h),
        ctypes.byref(w),
    )
    if rc != 0:
        raise ValueError(f"native decode failed ({rc}): {path}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()
