"""What decides ``correct``: each stage call that the correctness drive
recorded is recomputed by the plain reference (float64) from that stage's
inputs, and the program's outputs are judged against it.

The reference follows the program step by step: a stage's inputs are the
program's state at that frame (the feature table, the map's points, the
pose and its generator), its frames are the harness's own. One number per
stage, the largest reading over the calls drawn from the seed, or one
taken over all of them together (``essential_support``, ``ba_gain_ratio``):

- ``lk_px``: mean distance (px, capped at 1) between the program's tracked
  positions and the reference's pyramidal LK from the two raw frames, over
  the slots either keeps; a slot only one of them keeps counts 1 px;
- ``corner_rel``: largest gap between a corner's score and the reference's
  min-eigenvalue response at its pixel, over the frame's largest response;
- ``essential_support``: over all the sampled bootstrap calls together,
  the share of the correspondences that the reference's essential matrix
  holds under the configuration's threshold (five-point RANSAC and refit,
  replayed from the same generator state) that the program's does not
  hold. RANSAC maximises that count, and float32 and float64 agree on it
  to an inlier or two per call, where the sum of the Sampson errors of one
  refit differs between them by up to 70 %;
- ``pose_rad``: the larger of the angle between the bootstrap's rotation
  and the reference's and the distance between their unit translations;
- ``tri_rel``: median relative gap between the bootstrap's points and the
  reference's triangulation under the program's pose;
- ``ba_rise``: how much the window's Huber cost (float64) after the BA
  exceeds the cost before it, relative to the latter: Levenberg-Marquardt
  keeps a step only when it lowers the cost, so a sound BA never raises it;
- ``ba_gain_ratio``: over all the sampled BA calls together, the fall of
  the windows' Huber cost under the reference's float64 LM (the same
  iterations from the same inputs) over the fall under the program's; a BA
  that lowers no cost in sum reads inf;
- ``gate_rel``: gap between the program's new pose and the reference's
  motion gate applied to the program's delta (inf where acceptance differs);
- ``stitch_rel``: gap between the stitched trajectory and the reference's.

``control=True`` puts the reference computed in TF32 in the program's
place: the same numbers then read the control.

A stage that these seven do not cover is added as a file,
``stages/<stage>.py`` under the benchmark's folder, found by its name as
``metrics/<name>.py`` is (:func:`stage_files`; no folder, no stage files).
A stage file imports nothing of the program when it is loaded, and gives:

- ``POINTS``: ``("module.path", "attribute")`` pairs of the program's
  functions that the recorder wraps (:mod:`vo_bench.record`), imported
  only when the correctness drive starts. A function that another stage
  wraps too gets both wrappers, and each records its calls;
- ``NUMBERS``: the names of the numbers it gives, none of them a built-in
  stage's, ``repeat`` or another file's;
- ``keep(arguments) -> dict`` and, optionally, ``keep_out(out)`` (default
  ``record._copy``): what the recorder copies of a call's bound arguments
  and of its outputs, into ``rec["args"]`` and ``rec["out"]``;
- ``judge(rec, index, drv, control) -> dict``: the readings of one call,
  ``index`` its position among its stage's calls (as
  :meth:`Drive.corner_image` takes it). Keys that start ``sum.`` are added
  up over the sampled calls, and the optional ``summed(sums) -> dict``
  turns those sums into numbers (it is not called where there are none).

Stage files are judged after the seven, in the order of their names, so
they draw from the seed's generator after them; ``samples[<stage>]`` caps
a file's draws as a built-in's (all calls by default), and a file whose
numbers no limit names is not judged.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

from vo_bench.reference import F64, TF32, ba, essential, image, pose
from vo_bench.reference import geometry as geo

STAGES = ("lk", "corners", "essential", "pose", "ba", "gate", "stitch")
NUMBERS = {"lk": ["lk_px"], "corners": ["corner_rel"], "essential": ["essential_support"],
           "pose": ["pose_rad", "tri_rel"], "ba": ["ba_rise", "ba_gain_ratio"], "gate": ["gate_rel"],
           "stitch": ["stitch_rel"]}


class Drive:
    """Where each recorded call's frames are: ``frames`` (T, H, W) uint8 of
    the harness, the program's init frame and, for a segmented run, its
    segments (``starts``) and chunk length."""

    def __init__(self, frames, init_offset: int, init_frames: int, starts=None, chunk: int = 8):
        self.frames = frames
        self.init_offset = init_offset
        self.init_frames = init_frames
        self.starts = starts
        self.chunk = chunk

    def image_of(self, n: int) -> int:
        """The frame that frame step ``n`` tracks into."""
        if self.starts is None:
            return self.init_offset + 1 + n
        B, C = len(self.starts), self.chunk
        c, r = divmod(n, B * C)
        b, j = divmod(r, C)
        return self.starts[b] + 1 + c * C + j

    def corner_image(self, i: int, rec) -> int:
        """The frame of the ``i``-th corner extraction: the init frames,
        then (segmented) each segment's first frame, then reseeds."""
        if rec["n"] >= 0:
            return self.image_of(rec["n"])
        if i < self.init_frames:
            return i
        return self.starts[i - self.init_frames]

    def frame(self, idx: int, device, dtype=torch.float64):
        return torch.as_tensor(self.frames[idx], device=device).to(dtype)


def _med(x):
    return float(torch.median(x)) if x.numel() else None


def _lk(rec, index: int, drv: Drive, control: bool):
    a, out = rec["args"], rec["out"]
    dev = a["xy"].device
    idx = drv.image_of(rec["n"])
    search = a["search"] if a["search"] > 0 else max(4, a["win"] // 2)

    def run(P):
        prev = image.build_pyramid(drv.frame(idx - 1, dev, P.dtype), a["levels"], P)
        nxt = image.build_pyramid(drv.frame(idx, dev, P.dtype), a["levels"], P)
        return image.track(prev, nxt, a["xy"].to(P.dtype), a["valid"], a["win"], a["iters"], search, P)

    ref_xy, ref_ok = run(F64)
    xy, ok = run(TF32) if control else (out["xy"], out["valid"])
    either = ok | ref_ok
    gap = torch.clamp(torch.linalg.norm(xy.double() - ref_xy, dim=-1), max=1.0)
    gap = torch.where(ok & ref_ok, gap, 1.0)[either]
    return {"lk_px": float(gap.mean()) if gap.numel() else None}


def _corners(rec, index: int, drv: Drive, control: bool):
    a, (xy, score, valid) = rec["args"], rec["out"]
    dev = xy.device
    raw = drv.frame(drv.corner_image(index, rec), dev, torch.float32)
    if not torch.equal(a["img"], raw):  # the program's frame is not the harness's
        return {"corner_rel": float("inf")}
    ref = image.min_eig_response(raw, F64)
    if control:
        score = image.min_eig_response(raw, TF32)[xy[:, 1].long(), xy[:, 0].long()]
    at = ref[xy[:, 1].long(), xy[:, 0].long()]
    gap = (score.double() - at).abs()[valid]
    return {"corner_rel": float(gap.max() / ref.abs().max()) if gap.numel() else None}


def _essential(rec, index: int, drv: Drive, control: bool):
    a, (E, _) = rec["args"], rec["out"]
    p1, p2, valid, K = a["p1"], a["p2"], a["valid"], a["K"]
    draw = (a["gen_state"], a["n_hypos"], a["thresh_px"])
    E_ref, _ = essential.ransac(p1.double(), p2.double(), valid, K.double(), *draw, P=F64)
    if control:
        E, _ = essential.ransac(p1, p2, valid, K, *draw, P=TF32)
    held = lambda e: essential.support(e, p1, p2, valid, K, a["thresh_px"])  # noqa: E731
    return {"sum.e_held": held(E), "sum.e_ref_held": held(E_ref)}


def _pose(rec, index: int, drv: Drive, control: bool):
    a, (R, t, X, front) = rec["args"], rec["out"]
    d = lambda x: x.double()  # noqa: E731
    R_ref, t_ref, _, _ = essential.recover_pose(d(a["E"]), d(a["p1"]), d(a["p2"]), a["valid"], d(a["K"]), F64)
    if control:
        R, t, X, front = essential.recover_pose(a["E"], a["p1"], a["p2"], a["valid"], a["K"], TF32)
    unit = lambda v: d(v) / torch.linalg.norm(d(v))  # noqa: E731
    gap = max(float(geo.rotation_gap(d(R), R_ref)), float(torch.linalg.norm(unit(t) - unit(t_ref))))
    x1 = essential.normalize(d(a["p1"]), d(a["K"]))
    x2 = essential.normalize(d(a["p2"]), d(a["K"]))
    X_ref = essential.triangulate(d(R), d(t), x1, x2)
    rel = torch.linalg.norm(d(X) - X_ref, dim=-1) / torch.clamp(torch.linalg.norm(X_ref, dim=-1), min=1e-300)
    return {"pose_rad": gap, "tri_rel": _med(rel[front])}


def _ba(rec, index: int, drv: Drive, control: bool):
    """Also the two falls of the cost that ``ba_gain_ratio`` sums."""
    a, (tr, lm) = rec["args"], rec["out"]
    keys = ("tr", "lm", "obs_uv", "local", "obs_mask", "pose_free", "K")
    ins = [a[k] for k in keys]
    if control:
        tr, lm = ba.solve(*ins, iters=a["iters"], P=TF32, gate_px=a["obs_gate_px"])
    ref = ba.solve(*(x.double() if x.is_floating_point() else x for x in ins), iters=a["iters"], P=F64,
                   gate_px=a["obs_gate_px"])
    cost = lambda tr_, lm_: float(ba.cost(tr_, lm_, a["obs_uv"], a["local"], a["obs_mask"], a["K"]))  # noqa: E731
    c0, c1 = cost(a["tr"], a["lm"]), cost(tr, lm)
    return {"ba_rise": (c1 - c0) / max(c0, 1e-300), "sum.ba_fall": c0 - c1, "sum.ba_ref_fall": c0 - cost(*ref)}


def _pose_gap(R, t, R_ref, t_ref) -> float:
    R, t = torch.as_tensor(R).double(), torch.as_tensor(t).double()
    R_ref, t_ref = torch.as_tensor(R_ref).double(), torch.as_tensor(t_ref).double()
    dt = torch.linalg.norm(t - t_ref, dim=-1) / torch.clamp(torch.linalg.norm(t_ref, dim=-1), min=1.0)
    return float(max((R - R_ref).abs().max(), dt.max()))


def _gate(rec, index: int, drv: Drive, control: bool):
    a = rec["args"]
    R, t, accepted = rec["out"]
    args = [a[k] for k in ("R_delta", "t_delta", "R_prev", "t_prev", "R_s_prev", "t_s_prev", "scale")]
    R_ref, t_ref, acc_ref = pose.gate(*args, P=F64)
    if control:
        R, t, accepted = pose.gate(*args, P=TF32)
    if accepted != acc_ref:
        return {"gate_rel": float("inf")}
    return {"gate_rel": _pose_gap(R, t, R_ref, t_ref)}


def _stitch(rec, index: int, drv: Drive, control: bool):
    a = rec["args"]
    R, t = rec["out"]
    R_ref, t_ref = pose.stitch(a["R_hist"], a["t_hist"], a["L"], F64)
    if control:
        R, t = pose.stitch(a["R_hist"], a["t_hist"], a["L"], TF32)
    return {"stitch_rel": _pose_gap(np.stack(R), np.stack(t), R_ref, t_ref)}


JUDGES = {"lk": _lk, "corners": _corners, "essential": _essential, "pose": _pose, "ba": _ba, "gate": _gate,
          "stitch": _stitch}


def _summed(sums: dict) -> dict:
    """The numbers taken over all the sampled calls of a stage together."""
    out = {}
    if "sum.e_held" in sums:
        ref = sums["sum.e_ref_held"]
        out["essential_support"] = (ref - sums["sum.e_held"]) / ref if ref > 0 else 0.0
    if "sum.ba_fall" in sums:
        fall = sums["sum.ba_fall"]
        out["ba_gain_ratio"] = sums["sum.ba_ref_fall"] / fall if fall > 0 else float("inf")
    return out


def stage_files(here: Path) -> dict:
    """The stage files ``<here>/stages/<stage>.py`` by stage name, in the
    order of their names; none where the folder is missing. Raises
    ``ValueError`` for a file that lacks part of the contract (module
    docstring), takes the name of a built-in stage or of the recorder's
    ``frame`` and ``ba_step``, or gives a number that is taken."""
    folder = here / "stages"
    if not folder.is_dir():
        return {}
    taken = {"repeat", *(n for names in NUMBERS.values() for n in names)}
    out = {}
    for path in sorted(folder.glob("[!_]*.py")):
        name = path.stem
        if name in (*STAGES, "frame", "ba_step"):
            raise ValueError(f"stage file {path.name}: {name!r} is a built-in stage")
        spec = importlib.util.spec_from_file_location(f"vo_bench_stage_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lacks = [k for k in ("POINTS", "NUMBERS", "keep", "judge") if not hasattr(mod, k)]
        if lacks:
            raise ValueError(f"stage file {path.name} lacks {', '.join(lacks)}")
        clash = taken & set(mod.NUMBERS)
        if clash:
            raise ValueError(f"stage file {path.name}: {', '.join(sorted(clash))} taken")
        taken |= set(mod.NUMBERS)
        out[name] = mod
    return out


def _declared(stage: str, names, got: dict) -> dict:
    """``got``, where every number it gives is one of the stage's ``names``."""
    extra = [k for k in got if not k.startswith("sum.") and k not in names]
    if extra:
        raise ValueError(f"stage {stage} gave {', '.join(extra)}, not among its NUMBERS")
    return got


def judge(calls: dict, drv: Drive, samples: dict, seed: int, control: bool = False,
          detail: list | None = None, numbers_wanted=None, stages: dict | None = None) -> dict:
    """The largest reading of each number over the calls of each stage drawn
    from ``seed`` (``samples[stage]`` of them; all when there are fewer),
    or, for the summed numbers, the reading over all of them together.
    The seven built-in stages first, then the stage files ``stages``
    (:func:`stage_files`). A stage with no call gives no number;
    ``numbers_wanted`` limits the stages judged to those that give one of
    these numbers. ``detail``, when given, receives each call's readings as
    (stage, call index, frame step, readings)."""
    rng = np.random.default_rng(seed)
    numbers: dict[str, float] = {}

    def put_summed(got: dict) -> None:
        for name, v in got.items():
            numbers[name] = v if v == v else float("inf")

    def stage_sums(stage: str, names, judge_call) -> dict:
        """Judge the stage's sampled calls into ``numbers``; returns its sums."""
        sums: dict[str, float] = {}
        if numbers_wanted is not None and not set(names) & set(numbers_wanted):
            return sums
        recs = calls.get(stage, [])
        if not recs:
            return sums
        n_take = min(samples.get(stage, len(recs)), len(recs))
        for j in sorted(rng.choice(len(recs), size=n_take, replace=False).tolist()):
            rec = recs[j]
            got = _declared(stage, names, judge_call(rec, j, drv, control))
            if detail is not None:
                detail.append((stage, j, rec["n"], got))
            for name, v in got.items():
                if name.startswith("sum."):
                    sums[name] = sums.get(name, 0.0) + v
                    continue
                if v is None:
                    continue
                if v != v:  # NaN: the stage produced no usable answer
                    v = float("inf")
                numbers[name] = max(numbers.get(name, -float("inf")), v)
        return sums

    sums: dict[str, float] = {}
    for stage in STAGES:
        sums.update(stage_sums(stage, NUMBERS[stage], JUDGES[stage]))
    put_summed(_summed(sums))
    for stage, mod in (stages or {}).items():
        file_sums = stage_sums(stage, mod.NUMBERS, mod.judge)
        if file_sums and hasattr(mod, "summed"):
            put_summed(_declared(stage, mod.NUMBERS, mod.summed(file_sums)))
    return numbers
