"""Asynchronous frame prefetching — the host-side producer.

The reference decouples image loading + feature extraction from pose
estimation with a two-thread producer/consumer pipeline over a bounded
``dlib::pipe`` (OdometryPipeline.cpp:210-245, include/OdometryPipeline.h:
246-251). The equivalent here: a background thread decodes frames
ahead of the device loop into a bounded queue, so image IO/decode overlaps
with the per-frame device step. Empty/corrupt images are skipped like the
reference does (OdometryPipeline.cpp:218-219), and counted
(``ingest.skipped``). Under the program's tracer each decode is an
``ingest.decode`` span on the producer thread and each wait of the consumer
an ``ingest.wait`` span (:mod:`pmv_tpu_torch.utils.profiling`).
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator, Sequence
from pathlib import Path

import numpy as np

from pmv_tpu_torch.io import native
from pmv_tpu_torch.io.png import load_grayscale
from pmv_tpu_torch.utils.profiling import count, span


class FramePrefetcher:
    """Iterate decoded grayscale frames with background lookahead.

    Yields (index, image (H, W)) in order; frames that fail to decode are
    skipped. The native C++ decoder (pmv_tpu_torch.io.native) is used when
    its library loads; otherwise the pure-Python codec.
    """

    def __init__(self, paths: Sequence[str | Path], depth: int = 8, loader=None):
        self._paths = list(paths)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._loader = loader or _default_loader
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        for i, p in enumerate(self._paths):
            with span("ingest.decode"):
                try:
                    img = self._loader(p)
                except Exception:
                    img = None
            self._queue.put((i, img))

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        for _ in self._paths:  # the producer puts one item per path
            with span("ingest.wait"):
                i, img = self._queue.get()
            if img is None or img.size == 0:
                count("ingest.skipped")
                continue  # skip empty/corrupt frames
            yield i, img


def decoder() -> str:
    """Which decoder ``FramePrefetcher`` uses by default: ``native`` or
    ``python``."""
    return "native" if native.available() else "python"


def _default_loader(path):
    if native.available():
        try:
            return native.load_grayscale(path)
        except ValueError:
            pass  # the Python codec has the last word on a file it cannot read
    return load_grayscale(path)
