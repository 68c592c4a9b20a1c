"""The motion gate with its composition, and the segments' stitch, as the
configuration states them."""

from __future__ import annotations

import math

import numpy as np
import torch

from vo_bench.reference.prec import Prec


def gate(R_d, t_d, R, t, R_s, t_s, scale, P: Prec):
    """Accept the delta iff it moves forward (t_z < 0), turns by less than
    pi/8 (the reference's signed yaw, whose negative branch always passes),
    is z-dominant and shorter than twice the step scale; else replay the
    last accepted delta. Returns (R_new, t_new, accepted)."""
    R_d, t_d, R, t, R_s, t_s, scale = (P.q(x) for x in (R_d, t_d, R, t, R_s, t_s, scale))
    tz = t_d[2]
    yaw = torch.acos(torch.clamp(R_d[0, 0], -1.0, 1.0))
    yaw = torch.where(R_d[0, 2] <= 0, yaw, -yaw)
    accept = bool((tz < 0) & (yaw < math.pi / 8) & (tz.abs() > torch.maximum(t_d[0].abs(), t_d[1].abs()))
                  & (tz.abs() < 2.0 * scale))
    Rd, td = (R_d, t_d) if accept else (R_s, t_s)
    return P.q(Rd @ R), P.q(R @ td + t), accept


def stitch(R_hist, t_hist, L: int, P: Prec):
    """Each segment's per-frame deltas replayed onto the last pose of the
    segment before: ``t <- R t_d + t``, ``R <- R_d R``."""
    dt = np.float64 if P.dtype == torch.float64 else np.float32
    q = (lambda a: a) if P.name == "float64" else (lambda a: P.q(torch.from_numpy(np.asarray(a, dt))).numpy())
    R_a, t_a = np.eye(3, dtype=dt), np.zeros(3, dt)
    R_out, t_out = [R_a], [t_a]
    for Rl, tl in zip(q(np.asarray(R_hist, dt)), q(np.asarray(t_hist, dt))):
        for j in range(L):
            t_a = q(R_a @ (Rl[j].T @ (tl[j + 1] - tl[j])) + t_a)
            R_a = q((Rl[j + 1] @ Rl[j].T) @ R_a)
            R_out.append(R_a)
            t_out.append(t_a)
    return np.stack(R_out), np.stack(t_out)
