"""Timing and tracing — PyTorch counterpart of ``pmv_tpu/utils/profiling.py``.

The reference carries a hand-rolled nestable stopwatch (``tick``/``tock``,
include/OdometryPipeline.h:113, OdometryPipeline.cpp:84-91) for the run-level
timing. :class:`Stopwatch` reproduces that stack discipline and drains the
CUDA device before it reads the clock; :func:`trace` records a
``torch.profiler`` trace.

The program's own tracer: :func:`span` names an interval of host time at a
layer boundary of the port (the loop's chunks and frames, the stages of a
frame step, the BA, the frame prefetch) and :func:`count` a counter. Both
record only while a :class:`Tracer` is on (:func:`tracing`, or
:func:`trace`); otherwise ``span`` hands back one shared no-op object and
``count`` returns at once: no clock is read, nothing is allocated. No span
synchronises the device: a span holds the host time of the work it
encloses, whose device side is in a device trace on the same clock
(``perf_counter_ns``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import torch


class Stopwatch:
    """Nestable tick/tock stopwatch (stack semantics like the reference).

    With a CUDA ``device``, :meth:`tock` waits for the device to finish the
    work queued so far, so a reading covers the work and not its enqueue.
    Per-stage times come from :func:`span` under a :class:`Tracer`."""

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


# --------------------------------------------------------------------------
# the program's tracer
# --------------------------------------------------------------------------


class Span:
    """One closed span: its ``name``, the span open around it on the same
    thread (``parent``, a :class:`Span` or None), the thread
    (``threading.get_ident()``) and its host interval in
    ``time.perf_counter_ns()``."""

    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns")

    def __init__(self, name: str) -> None:
        self.name = name
        self.parent: Span | None = None
        self.thread = 0
        self.start_ns = 0
        self.end_ns = 0

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Tracer:
    """The spans and counters recorded while it is on, kept in memory until
    the caller reads them: ``spans`` in the order they closed, ``counters``
    by name. With ``annotate`` each span also enters
    ``torch.profiler.record_function(name)``, so that a profiler's trace
    shows the program's stages over its operators and kernels."""

    def __init__(self, annotate: bool = False) -> None:
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.annotate = annotate
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_current: Tracer | None = None  # the tracer that is on, for every thread


class _OpenSpan:
    __slots__ = ("_tracer", "_span", "_annotation")

    def __init__(self, tracer: Tracer, name: str) -> None:
        self._tracer = tracer
        self._span = Span(name)
        self._annotation = None

    def __enter__(self) -> Span:
        sp, stack = self._span, self._tracer._stack()
        sp.parent = stack[-1] if stack else None
        sp.thread = threading.get_ident()
        stack.append(sp)
        if self._tracer.annotate:
            self._annotation = torch.profiler.record_function(sp.name)
            self._annotation.__enter__()
        sp.start_ns = time.perf_counter_ns()
        return sp

    def __exit__(self, *exc):
        sp = self._span
        sp.end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        stack = self._tracer._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        self._tracer.spans.append(sp)
        return False


def span(name: str):
    """A context manager timing the enclosed statements as span ``name``
    under the tracer that is on; a shared no-op when none is."""
    tracer = _current
    return _NO_SPAN if tracer is None else _OpenSpan(tracer, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the tracer that is on, if any."""
    tracer = _current
    if tracer is not None:
        tracer.count(name, n)


@contextlib.contextmanager
def tracing(tracer: Tracer | None):
    """Turn ``tracer`` on for the enclosed work, in every thread (threads
    started inside keep their own span stacks); None turns tracing off."""
    global _current
    prev, _current = _current, tracer
    try:
        yield tracer
    finally:
        _current = prev


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | Path | None, device=None):
    """``torch.profiler`` trace of the enclosed work, exported as a Chrome
    trace to ``log_dir/trace.json``; a no-op when ``log_dir`` is None.

    It records the CPU activity and, on a CUDA ``device`` (``None``: when a
    CUDA device is available), the CUDA activity: every kernel launched in
    the process, those of the hand-written kernels included. The program's
    tracer is on meanwhile, its spans annotated into the trace; the context
    yields that :class:`Tracer` (None without ``log_dir``)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = (
        torch.device(device).type == "cuda" if device is not None
        else torch.cuda.is_available()
    )
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof, tracing(Tracer(annotate=True)) as tracer:
        yield tracer
    prof.export_chrome_trace(str(out / TRACE_FILE))
