"""Motion-plausibility gate — the reference's ``motionHeuristics``; PyTorch
counterpart of ``pmv_tpu/pipeline/heuristics.py``.

Reference: OdometryPipeline.cpp:171-208. A relative pose delta (R_d, t_d) is
accepted iff the motion is forward-dominant and physically plausible:

- forward translation: ``t_d.z < 0``
- yaw below pi/8 (via the reference's signed ``calcYRotation``, whose
  negative branch always passes — reproduced faithfully)
- z-dominant: ``|t_z| > max(|t_x|, |t_y|)``
- bounded step: ``|t_z| < 2 * scale`` (scale = last GT-derived step length)

On rejection the previous accepted delta is replayed. Either way the
(possibly replaced) delta is pushed into the heuristic history and composed
onto the trajectory: ``t_new = R_prev @ t_d + t_prev; R_new = R_d @ R_prev``.
"""

from __future__ import annotations

import math

import torch

from pmv_tpu_torch.core import geometry as geo

Tensor = torch.Tensor


def motion_gate(
    R_delta: Tensor,
    t_delta: Tensor,
    R_prev: Tensor,
    t_prev: Tensor,
    R_s_prev: Tensor,
    t_s_prev: Tensor,
    scale: Tensor,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Returns (R_new, t_new, R_s_new, t_s_new, accepted)."""
    tz = t_delta[2]
    accept = (
        (tz < 0)
        & (geo.calc_y_rotation(R_delta) < math.pi / 8)
        & (tz.abs() > torch.maximum(t_delta[0].abs(), t_delta[1].abs()))
        & (tz.abs() < 2.0 * scale)
    )
    R_d = torch.where(accept, R_delta, R_s_prev)
    t_d = torch.where(accept, t_delta, t_s_prev)
    R_new, t_new = geo.compose_delta(R_prev, t_prev, R_d, t_d)
    return R_new, t_new, R_d, t_d, accept
