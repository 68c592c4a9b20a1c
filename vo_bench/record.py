"""Wrappers that the harness puts around the program's stage functions.

The program's loop looks each stage up by module attribute at call time
(``fused.chunk_step`` calls ``fused.frame_step``, ``frame_step`` calls
``steps.track_step_cached``, ``find_essential_5pt_ransac`` and so on), so a
wrapper set on the module attribute sees every call. Two uses:

- :class:`Spans` (traced runs): host intervals of ``frame_step`` and
  ``ba_step``, each ended by a device synchronise, in every drive of the
  window, the profiled one too.
- :class:`Recorder` (the correctness drive, after the window): each stage
  call's inputs and outputs, copied, for the reference to judge.

The Recorder also takes the stage files ``stages/<stage>.py``
(:func:`vo_bench.judge.stage_files`, whose docstring holds their contract):
each wraps the functions its ``POINTS`` name, imported when the recorded
drive starts, and records ``{"n", "args": keep(arguments), "out":
keep_out(out)}`` per call under its own name. Their wrappers go on first,
under the built-in ones, so a stage file that wraps ``frame_step`` reads
the step's own ``n``; a function that two stages wrap records into both.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import time
from dataclasses import dataclass, field

import torch


def _patch_points(stages: dict | None = None):
    """(module, attribute) of every stage function the harness wraps: the
    built-in stages', then the ``POINTS`` of each stage file in ``stages``,
    imported here."""
    from pmv_tpu_torch.ba import schur_lm
    from pmv_tpu_torch.frontend import corners
    from pmv_tpu_torch.pipeline import fused, segmented, steps
    from pmv_tpu_torch.solvers import essential

    points = {
        "frame": [(fused, "frame_step")],
        "ba_step": [(fused, "ba_step")],
        "lk": [(steps, "track_step_cached")],
        "corners": [(corners, "grid_extract"), (segmented, "grid_extract")],
        "essential": [(fused, "find_essential_5pt_ransac")],
        "pose": [(essential, "recover_pose")],
        "ba": [(schur_lm, "ba_solve_grid")],
        "gate": [(fused, "motion_gate")],
        "stitch": [(segmented, "stitch_segments")],
    }
    for name, mod in (stages or {}).items():
        points[name] = [(importlib.import_module(m), attr) for m, attr in mod.POINTS]
    return points


@contextlib.contextmanager
def patched(wrappers: dict, stages: dict | None = None):
    """Set ``wrappers[stage](original) -> wrapper`` on every patch point of
    each stage, in the order of ``wrappers``, on top of what is there; the
    stage files ``stages`` add theirs. Restore the originals on exit."""
    points = _patch_points(stages)
    saved = []
    try:
        for stage, make in wrappers.items():
            for mod, attr in points[stage]:
                orig = getattr(mod, attr)
                saved.append((mod, attr, orig))
                setattr(mod, attr, make(orig))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Spans:
    """Host spans of the per-frame step and the BA step, each ended by a
    device synchronise, so that a span holds the device work its call
    queued. The profiled drive runs under them too: its device timeline
    (``device_idle_share``, ``launches_per_frame``) holds one synchronise
    more per frame step and per BA call than an untraced drive."""

    device: torch.device
    spans: list = field(default_factory=list)
    after_frame: object = None  # called with the count of frame steps so far

    def _end(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter_ns()

    def wrappers(self) -> dict:
        def frame(orig):
            @functools.wraps(orig)
            def wrapped(*args, **kwargs):
                t0 = time.perf_counter_ns()
                out = orig(*args, **kwargs)
                kind = "pnp" if bool(out[2]["used_pnp"]) else "bootstrap"
                self.spans.append(Span(f"frame_step.{kind}", t0, self._end()))
                if self.after_frame is not None:
                    self.after_frame(sum(s.name.startswith("frame_step") for s in self.spans))
                return out
            return wrapped

        def ba(orig):
            @functools.wraps(orig)
            def wrapped(*args, **kwargs):
                t0 = time.perf_counter_ns()
                out = orig(*args, **kwargs)
                self.spans.append(Span("ba_step", t0, self._end()))
                return out
            return wrapped

        return {"frame": frame, "ba_step": ba}


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_copy(v) for v in x)
    return x


class Recorder:
    """Every stage call of one drive: ``calls[stage]`` is a list of dicts
    with the frame-step index ``n`` the call belongs to (-1 before the first
    frame step), the bound arguments (``args``) and the outputs (``out``),
    all copied at the call. ``stages``: the stage files recorded beside the
    built-in stages."""

    def __init__(self, stages: dict | None = None):
        self.n = -1
        self.calls: dict[str, list] = {}
        self.stages = stages or {}

    def _wrap(self, stage: str, keep, keep_out=_copy):
        """A wrapper factory recording ``keep(arguments)`` (a callable, or a
        tuple of argument names copied as they are) and ``keep_out(out)``."""
        if not callable(keep):
            names = keep
            keep = lambda a: {k: _copy(a[k]) for k in names}  # noqa: E731

        def make(orig):
            sig = inspect.signature(orig)

            @functools.wraps(orig)
            def wrapped(*args, **kwargs):
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                rec = {"n": self.n, "args": keep(bound.arguments)}
                out = orig(*args, **kwargs)
                rec["out"] = keep_out(out)
                self.calls.setdefault(stage, []).append(rec)
                return out
            return wrapped
        return make

    def wrappers(self) -> dict:
        def frame(orig):
            @functools.wraps(orig)
            def wrapped(state, *args, **kwargs):
                self.n += 1
                out = orig(state, *args, **kwargs)
                st = out[2]
                self.calls.setdefault("frame", []).append(
                    {"n": self.n, "k": state.k, "used_pnp": bool(st["used_pnp"]),
                     "reseed": bool(st["reseed"])})
                return out
            return wrapped

        def essential_args(a):
            if a["samples"] is not None:
                raise ValueError("the essential-matrix RANSAC was handed its samples; "
                                 "the comparison replays the generator's draw")
            rec = {k: _copy(a[k]) for k in ("p1", "p2", "valid", "K", "n_hypos", "thresh_px")}
            rec["gen_state"] = a["gen"].get_state()
            return rec

        files = {name: self._wrap(name, mod.keep, getattr(mod, "keep_out", _copy))
                 for name, mod in self.stages.items()}
        return {
            **files,
            "frame": frame,
            "lk": self._wrap("lk", lambda a: {
                "xy": _copy(a["prev_table"].xy), "valid": _copy(a["prev_table"].valid),
                "win": a["win"], "iters": a["iters"], "search": a["search"],
                "levels": len(a["next_pyr"]) - 1},
                lambda out: {"xy": _copy(out[0].xy), "valid": _copy(out[0].valid)}),
            "corners": self._wrap("corners", lambda a: {
                "img": a["img"], **{k: a[k] for k in ("n_per_tile", "tile_h", "tile_w", "quality",
                                                       "min_distance", "response")}}),
            "essential": self._wrap("essential", essential_args),
            "pose": self._wrap("pose", ("E", "p1", "p2", "valid", "K")),
            "ba": self._wrap("ba", ("tr", "lm", "obs_uv", "local", "obs_mask", "pose_free", "K",
                                    "iters", "delta", "lam0", "obs_gate_px"),
                             lambda out: (_copy(out[0]), _copy(out[1]))),
            "gate": self._wrap("gate", ("R_delta", "t_delta", "R_prev", "t_prev", "R_s_prev",
                                        "t_s_prev", "scale"),
                               lambda out: (_copy(out[0]), _copy(out[1]), bool(out[4]))),
            "stitch": self._wrap("stitch", ("R_hist", "t_hist", "L")),
        }
