"""Divergence diagnostics of one (configuration, seed) run, and the drift
mechanism behind it.

    python3 -m pmv_tpu_torch.diag seed [--device cpu]   # from the repo root
    python3 -m pmv_tpu_torch.diag analyze NPZ...

The counterparts of ``scripts/diag_seed.py`` and ``scripts/diag_analyze.py``.

``seed`` runs the tuned-default configuration at full length with verbose
stats on the card (the CPU only with ``--device cpu``) and dumps the
per-frame trajectory error against ground truth and the per-frame stats
(tracked / n3d / branch / inliers / gate), so that a divergence can be
placed at a frame and a mechanism (lost tracks -> re-triangulation with a
wrong heading, a gate failure, BA drag). Knobs: ``DIAG_SEED`` (1),
``DIAG_FRAMES`` (598), ``DIAG_OUT`` (``artifacts/torch/diag``),
``DIAG_OVERRIDES`` (``{}``, JSON of ``VOConfig`` keys) and ``DIAG_FAMILY``
(``corridor``; a scene family of ``parity_sweep.FAMILY_KW``). It writes
``diag_{tag}.npz`` (``stats`` (T-1, 5) int32, ``err``, ``t_est``, ``gt``,
``off``), ``diag_{tag}.log`` (the run's verbose output) and prints one JSON
line with the onsets ``first_err_gt_*m``. The scene is the sweep's, written
under ``bench.CACHE`` when it is missing.

``analyze`` (numpy only) attributes each dump's error growth to its frames'
labels: g[k] = err[k] - err[k-1] summed over the frames of a bootstrap
(tri) event and the few after it, over turns (the top decile of the ground
truth's yaw rate), over gate rejections and over plain PnP frames; with the
heading error's evolution and the five largest single-frame growths. A
mechanism that owns a bad seed's drift is the dominant bucket of that seed
and not of a good one.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------- seed


def seed_knobs(env=None) -> dict:
    env = os.environ if env is None else env
    return {
        "seed": int(env.get("DIAG_SEED", "1")),
        "frames": int(env.get("DIAG_FRAMES", "598")),
        "out": Path(env.get("DIAG_OUT", "artifacts/torch/diag")),
        "overrides": json.loads(env.get("DIAG_OVERRIDES", "{}")),
        "family": env.get("DIAG_FAMILY", "corridor"),
    }


def run_seed(device=None, env=None) -> dict:
    """The diagnostic run: writes the npz and the log, returns the summary."""
    from pmv_tpu_torch import resolve_device
    from pmv_tpu_torch.config import VOConfig
    from pmv_tpu_torch.parity_sweep import FAMILY_KW, build_dataset
    from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

    dev = resolve_device(device)  # before any work: no card, no run
    k = seed_knobs(env)
    if k["family"] not in FAMILY_KW:
        raise ValueError(f"DIAG_FAMILY={k['family']!r}: one of {sorted(FAMILY_KW)}")
    paths = build_dataset(k["frames"], k["family"])
    base = dict(
        image_dir=paths["image_dir"],
        camera_calibration=paths["camera_calibration"],
        poses=paths["poses"],
        camera=0, frames=k["frames"], init_frames=5,
        min_tracked_features=400, tracked_features_tol=150,
        bundle_size=5, max_iterations=5,
        feature_capacity=512, map_capacity=8192,
        verbose=1, seed=k["seed"],
    )
    base.update(k["overrides"])
    pipe = OdometryPipeline(VOConfig(**base), device=dev)
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = pipe.run()
    # the verbose line's columns (tracked, n3d, pnp, inliers, accepted), as
    # scripts/diag_seed.py parses them
    rows = [(s["tracked"], s["n3d"], bool(s["used_pnp"]), s["inliers"], bool(s["accepted"]))
            for s in pipe.frame_stats]
    stats = np.asarray(rows, np.int32) if rows else np.zeros((0, 5), np.int32)
    # each pose's distance from the ground truth, both rebased at the init
    # frame (gt in the pipeline's z-flipped world)
    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    err = np.linalg.norm((t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off]), axis=1)

    k["out"].mkdir(parents=True, exist_ok=True)
    ov = k["overrides"]
    tag = f"seed{k['seed']}" + ("_" + "_".join(f"{a}={b}" for a, b in sorted(ov.items())) if ov else "")
    if k["family"] != "corridor":
        tag += f"_{k['family']}"
    np.savez(k["out"] / f"diag_{tag}.npz", stats=stats, err=err, t_est=t_est, gt=gt, off=off)
    (k["out"] / f"diag_{tag}.log").write_text(buf.getvalue())

    summary = {
        "tag": tag, "frames": int(result["frames"]),
        "ate_rmse_m": float(np.sqrt(np.mean(err**2))) if len(err) else 0.0,
        "t_total": result["t_total"],
        "n_tri": int((~stats[:, 2].astype(bool)).sum()) if len(stats) else -1,
        "n_gate_reject": int((~stats[:, 4].astype(bool)).sum()) if len(stats) else -1,
    }
    # first frame where the error exceeds each threshold (divergence onset)
    for thresh in (5.0, 10.0, 20.0, 40.0):
        summary[f"first_err_gt_{int(thresh)}m"] = int(np.argmax(err > thresh)) if np.any(err > thresh) else -1
    return summary


# ---------------------------------------------------------------- analyze


def yaw_of(t: np.ndarray) -> np.ndarray:
    """Heading angle (x-z plane) of consecutive trajectory steps."""
    d = np.diff(t, axis=0)
    return np.arctan2(d[:, 0], -d[:, 2])  # forward = -z in pipeline world


def analyze(path: Path, tri_halo: int = 2, turn_thresh: float = 0.008) -> dict:
    """Error-growth attribution of one ``seed`` dump (the dict and rounding of
    ``scripts/diag_analyze.py``)."""
    d = np.load(path)
    stats, err, t_est, gt, off = d["stats"], d["err"], d["t_est"], d["gt"], int(d["off"])
    n = len(err)
    g = np.diff(err, prepend=0.0)  # per-frame error growth (signed)

    used_pnp = stats[:, 2].astype(bool)
    accepted = stats[:, 4].astype(bool)
    m = min(n, len(used_pnp))
    g, used_pnp, accepted = g[:m], used_pnp[:m], accepted[:m]

    tri = ~used_pnp
    # halo: the frames right after a tri event are its (the fresh map's
    # heading error surfaces over the next few frames)
    tri_z = np.zeros(m, bool)
    for i in np.where(tri)[0]:
        tri_z[i : i + tri_halo + 1] = True

    gt_yaw = yaw_of(gt[off : off + m + 1])
    yr = np.abs(np.diff(gt_yaw, prepend=gt_yaw[0]))
    # "turn" = the top decile of this trajectory's yaw rate (the smooth
    # corridor never crosses a fixed intersection threshold)
    thr = max(turn_thresh, float(np.quantile(yr, 0.9)))
    turn = (yr > thr)[:m]

    reject = ~accepted

    buckets = {
        "tri_event_halo": tri_z,
        "turn": turn & ~tri_z,
        "gate_reject": reject & ~tri_z & ~turn,
        "plain_pnp": ~tri_z & ~turn & ~reject,
    }
    out = {
        "file": path.name,
        "frames": int(m),
        "final_err_m": round(float(err[-1]), 2),
        "ate_rmse_m": round(float(np.sqrt(np.mean(err**2))), 2),
        "n_tri": int(tri.sum()),
        "n_gate_reject": int(reject.sum()),
    }
    for name, mask in buckets.items():
        out[f"growth_{name}_m"] = round(float(g[mask].sum()), 2)
        out[f"frames_{name}"] = int(mask.sum())
        out[f"growth_per_frame_{name}_mm"] = (
            round(float(g[mask].sum() / mask.sum() * 1e3), 1) if mask.sum() else 0.0
        )

    # heading error: estimated heading minus the ground truth's, smoothed
    est_yaw = yaw_of(t_est[: m + 1])
    hd = np.unwrap(est_yaw[:m]) - np.unwrap(gt_yaw[:m])
    k = min(21, max(3, m // 20) | 1)
    hd_s = np.convolve(hd, np.ones(k) / k, mode="same")
    out["heading_err_final_deg"] = round(float(np.degrees(hd_s[-1])), 2)
    out["heading_err_max_deg"] = round(float(np.degrees(np.abs(hd_s).max())), 2)
    top = np.argsort(-np.abs(g))[:5]
    out["top_growth_events"] = [
        {
            "frame": int(i),
            "growth_m": round(float(g[i]), 2),
            "label": next(nm for nm, msk in buckets.items() if msk[i]),
        }
        for i in top
    ]
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m pmv_tpu_torch.diag")
    sub = ap.add_subparsers(dest="cmd", required=True)
    seed_p = sub.add_parser("seed", help="one diagnostic run (DIAG_* knobs)")
    seed_p.add_argument("--device", default=None, help="torch device; default: cuda (an error without a card)")
    an_p = sub.add_parser("analyze", help="drift mechanisms of seed dumps")
    an_p.add_argument("npz", nargs="*", help="default: artifacts/torch/diag/diag_seed*.npz")
    args = ap.parse_args(argv)
    if args.cmd == "seed":
        print(json.dumps(run_seed(args.device)), flush=True)
        return 0
    paths = [Path(p) for p in args.npz] or sorted(Path("artifacts/torch/diag").glob("diag_seed*.npz"))
    for p in paths:
        print(json.dumps(analyze(p)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
