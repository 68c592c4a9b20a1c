"""Asynchronous frame prefetching — the host-side producer.

The reference decouples image loading + feature extraction from pose
estimation with a two-thread producer/consumer pipeline over a bounded
``dlib::pipe`` (OdometryPipeline.cpp:210-245, include/OdometryPipeline.h:
246-251). The equivalent here: a background thread decodes frames
ahead of the device loop into a bounded queue, so image IO/decode overlaps
with the per-frame device step. Empty/corrupt images are skipped like the
reference does (OdometryPipeline.cpp:218-219).
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator, Sequence
from pathlib import Path

import numpy as np

from pmv_tpu_torch.io.png import load_grayscale


class FramePrefetcher:
    """Iterate decoded grayscale frames with background lookahead.

    Yields (index, image float32 (H, W)) in order; frames that fail to decode
    are skipped. Decoding uses the pure-Python PNG codec.
    """

    def __init__(self, paths: Sequence[str | Path], depth: int = 8, loader=None):
        self._paths = list(paths)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._loader = loader or _default_loader
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        for i, p in enumerate(self._paths):
            try:
                img = self._loader(p)
            except Exception:
                img = None
            self._queue.put((i, img))
        self._queue.put(None)

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        while True:
            item = self._queue.get()
            if item is None:
                return
            i, img = item
            if img is None or img.size == 0:
                continue  # skip empty/corrupt frames
            yield i, img


def _default_loader(path):
    return load_grayscale(path)
