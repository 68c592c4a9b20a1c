"""Timing and tracing — PyTorch counterpart of ``pmv_tpu/utils/profiling.py``.

The reference carries a hand-rolled nestable stopwatch (``tick``/``tock``,
include/OdometryPipeline.h:113, OdometryPipeline.cpp:84-91) for the run-level
and per-stage timings printed under ``verbose``. :class:`Stopwatch`
reproduces that stack discipline and drains the CUDA device before it reads
the clock; :func:`trace` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


class Stopwatch:
    """Nestable tick/tock stopwatch (stack semantics like the reference).

    With a CUDA ``device``, :meth:`tock` waits for the device to finish the
    work queued so far, so a reading covers the work and not its enqueue."""

    def __init__(self, device=None) -> None:
        self._stack: list[float] = []
        self._device = torch.device(device) if device is not None else None

    def tick(self) -> None:
        self._stack.append(time.perf_counter())

    def tock(self) -> float:
        if not self._stack:
            return 0.0
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return time.perf_counter() - self._stack.pop()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | Path | None, device=None):
    """``torch.profiler`` trace of the enclosed work, exported as a Chrome
    trace to ``log_dir/trace.json``; a no-op when ``log_dir`` is None.

    It records the CPU activity and, on a CUDA ``device`` (``None``: when a
    CUDA device is available), the CUDA activity: every kernel launched in
    the process, those of the hand-written kernels included."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = (
        torch.device(device).type == "cuda" if device is not None
        else torch.cuda.is_available()
    )
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / TRACE_FILE))
