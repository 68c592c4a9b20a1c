"""Camera / SO(3) / SE(3) geometry with the reference implementation's
conventions — PyTorch counterpart of ``pmv_tpu/core/geometry.py``.

- World -> camera projection (reference ``Feature3D::projectPoint``,
  Feature3D.cpp:18-33): ``p' = R^T (p - t); p'.z *= -1;
  uv = f * p'.xy / p'.z + c`` with the "magic_z" guard (1/z replaced by 1 when
  z == 0).
- The bundle-adjustment pose parameterization (CeresBundleAdjustment.cpp:26-34):
  a pose block is ``[angle_axis(R^T), -t]`` and the residual rotates
  ``p + tr[3:6]`` by the angle-axis (include/ProjectionResidual.h:38-58).
- The y-rotation (yaw) extraction used by the motion gate
  (include/OdometryPipeline.h:89-108).

Everything is shape-polymorphic over leading batch dimensions and preserves
the input dtype. Matrix products are full float32 (package numerics policy).
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def hat(w: Tensor) -> Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rodrigues(aa: Tensor) -> Tensor:
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3), with a
    Taylor-series guard at theta ~ 0."""
    # (keepdim: a 0-dim tensor next to a Python scalar is promoted to float64
    # under torch.func transforms)
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]  # (..., 1, 1)
    theta = torch.sqrt(torch.clamp(theta2, min=torch.finfo(aa.dtype).tiny))
    small = theta2 < 1e-12
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = hat(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + sinc * K + cosc * (K @ K)


def rodrigues_inv(R: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3). Stable for theta
    in [0, pi); at pi it falls back to the largest-diagonal branch."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.acos(cos_t)
    w = 0.5 * torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-6
    near_pi = theta > math.pi - 1e-4
    scale = torch.where(
        small,
        1.0 + theta * theta / 6.0,
        theta / torch.where(sin_t == 0, torch.ones_like(sin_t), sin_t),
    )
    aa_generic = w * scale[..., None]
    B = (R + R.transpose(-1, -2)) / 2.0
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    one_minus_cos = torch.clamp(1.0 - cos_t, min=1e-12)
    axis2 = torch.clamp((diag - cos_t[..., None]) / one_minus_cos[..., None], min=0.0)
    axis = torch.sqrt(axis2)
    sign = torch.where(w >= 0, 1.0, -1.0).to(R.dtype)
    aa_pi = sign * axis * theta[..., None]
    return torch.where(near_pi[..., None], aa_pi, aa_generic)


def angle_axis_rotate(aa: Tensor, p: Tensor) -> Tensor:
    """Rotate points p (..., 3) by angle-axis aa (..., 3) —
    ``ceres::AngleAxisRotatePoint`` semantics (ProjectionResidual.h:48),
    smooth at theta ~ 0."""
    aa, p = torch.broadcast_tensors(aa, p)
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=torch.finfo(aa.dtype).tiny))
    small = theta2 < 1e-12
    axis = aa / torch.where(small, torch.ones_like(theta), theta)
    cos_t = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta))
    sin_t = torch.where(small, theta, torch.sin(theta))
    cross = torch.linalg.cross(axis, p, dim=-1)
    dot = torch.sum(axis * p, dim=-1, keepdim=True)
    rotated = cos_t * p + sin_t * cross + (1.0 - cos_t) * dot * axis
    first_order = p + torch.linalg.cross(aa, p, dim=-1)
    return torch.where(small, first_order, rotated)


def angle_axis_rotate_jac(aa: Tensor, p: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Rotation of points with its derivatives in closed form: ``aa`` (..., 3)
    angle-axis, ``p`` (..., N, 3) points. Returns ``q = R(aa) p`` (..., N, 3),
    ``dq/daa`` (..., N, 3, 3) and ``R`` (..., 3, 3), which is ``dq/dp``.

    ``dq/daa = -R [p]x J_r(aa)`` with the right Jacobian of SO(3),
    ``J_r = I - b [aa]x + c [aa]x^2``, ``b = (1 - cos t) / t^2``,
    ``c = (t - sin t) / t^3`` (series below t = 0.1, where the closed forms
    cancel in float32). The solvers use this where the JAX package takes
    ``jacfwd`` of the residual: the same derivative in a few dozen tensor ops
    instead of several hundred."""
    R = rodrigues(aa)
    q = p @ R.transpose(-1, -2)
    t2 = torch.sum(aa * aa, dim=-1)[..., None, None]
    t = torch.sqrt(torch.clamp(t2, min=1e-4))
    series = t2 < 1e-2
    b = torch.where(
        series, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, 2.0 * torch.sin(0.5 * t) ** 2 / (t * t)
    )
    c = torch.where(
        series, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (t - torch.sin(t)) / (t * t * t)
    )
    W = hat(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    Jr = eye - b * W + c * (W @ W)
    return q, -(R[..., None, :, :] @ hat(p) @ Jr[..., None, :, :]), R


def calc_y_rotation(R: Tensor, flip: bool = False) -> Tensor:
    """Yaw extraction used by the motion gate
    (include/OdometryPipeline.h:89-108): ``cos = R[0,0]``, ``sin = R[0,2]``."""
    cos = torch.clamp(R[..., 0, 0], -1.0, 1.0)
    sin = R[..., 0, 2]
    ac = torch.acos(cos)
    if flip:
        return torch.where(sin <= 0, -ac, ac)
    return torch.where(sin <= 0, ac, -ac)


def transform(points: Tensor, R: Tensor, t: Tensor) -> Tensor:
    """Camera -> world: ``p' = R p + t`` (Feature3D.cpp:85-89)."""
    return points @ R.transpose(-1, -2) + t[..., None, :]


def transform_inv(points: Tensor, R: Tensor, t: Tensor) -> Tensor:
    """World -> camera: ``p' = R^T (p - t)`` (Feature3D.cpp:91-97)."""
    return (points - t[..., None, :]) @ R


def project_points(points: Tensor, R: Tensor, t: Tensor, K: Tensor) -> Tensor:
    """Project world points (..., N, 3) through pose (R, t) and intrinsics K
    to pixels (..., N, 2), (u=column, v=row) — the reference model
    (Feature3D.cpp:18-33) with its z flip and ``magic_z`` guard."""
    pc = transform_inv(points, R, t)
    z = -pc[..., 2]
    magic_z = torch.where(
        z != 0, 1.0 / torch.where(z == 0, torch.ones_like(z), z), torch.ones_like(z)
    )
    u = pc[..., 0] * magic_z * K[..., 0, 0] + K[..., 0, 2]
    v = pc[..., 1] * magic_z * K[..., 1, 1] + K[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def camera_depth(points: Tensor, R: Tensor, t: Tensor) -> Tensor:
    """The (z-flipped) camera-frame depth used for cheirality tests:
    positive when the point is in front of the camera."""
    return -transform_inv(points, R, t)[..., 2]


def pose_to_ba_params(R: Tensor, t: Tensor) -> Tensor:
    """World pose (R, t) -> 6-vector BA block ``[angle_axis(R^T), -t]``."""
    aa = rodrigues_inv(R.transpose(-1, -2))
    return torch.cat([aa, -t], dim=-1)


def ba_params_to_pose(params: Tensor) -> tuple[Tensor, Tensor]:
    """Inverse of :func:`pose_to_ba_params`
    (CeresBundleAdjustment.cpp:72-82)."""
    R = rodrigues(params[..., :3]).transpose(-1, -2)
    return R, -params[..., 3:6]


def ba_project(tr: Tensor, p3d: Tensor, K: Tensor) -> Tensor:
    """The BA residual's predicted pixel (ProjectionResidual.h:38-58):
    ``p = AngleAxisRotate(tr[:3], p3d + tr[3:6]); p.z *= -1;
    uv = f * p.xy / p.z + c`` — no magic_z guard, like the reference."""
    p = angle_axis_rotate(tr[..., :3], p3d + tr[..., 3:6])
    z = -p[..., 2]
    u = p[..., 0] / z * K[..., 0, 0] + K[..., 0, 2]
    v = p[..., 1] / z * K[..., 1, 1] + K[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def compose_delta(
    R_prev: Tensor, t_prev: Tensor, R_delta: Tensor, t_delta: Tensor
) -> tuple[Tensor, Tensor]:
    """Compose an accepted relative motion onto the trajectory
    (OdometryPipeline.cpp:180-181):
    ``t_new = R_prev @ t_delta + t_prev; R_new = R_delta @ R_prev``."""
    t_new = (R_prev @ t_delta[..., None])[..., 0] + t_prev
    R_new = R_delta @ R_prev
    return R_new, t_new


def huber_weight(r2: Tensor, delta: float = 1.0) -> Tensor:
    """IRLS weight rho'(s) of Ceres' HuberLoss(delta) on squared residual
    norm r2: 1 for s <= delta^2, delta/sqrt(s) beyond."""
    d2 = delta * delta
    safe = torch.clamp(r2, min=torch.finfo(r2.dtype).tiny)
    return torch.where(r2 <= d2, torch.ones_like(r2), delta / torch.sqrt(safe))


def triangulate_midpoint(
    R_rel: Tensor, t_rel: Tensor, x1: Tensor, x2: Tensor
) -> tuple[Tensor, Tensor]:
    """Closed-form midpoint triangulation, batched over N rays.

    Camera 1 is [I|0], camera 2 is [R_rel|t_rel] (x2_cam = R_rel X + t_rel),
    both in STANDARD camera coordinates (z > 0 in front); ``x1``/``x2`` are
    unit-plane coords (N, 2). Returns (X (N, 3) in the camera-1 frame,
    sin2 (N,) = squared sine of the ray parallax angle — the caller's
    low-parallax gate; at sin2 -> 0 the midpoint is meaningless). A 2x2
    closed form, cheap enough to run on every PnP frame
    (pipeline/steps.continuous_triangulate).
    """
    d1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    d1 = d1 / torch.linalg.norm(d1, dim=-1, keepdim=True)
    d2c = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    d2 = d2c @ R_rel  # R_rel^T rows -> direction in the camera-1 frame
    d2 = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
    o2 = -(t_rel[None, :] @ R_rel)[0]  # camera-2 centre in the camera-1 frame
    B = torch.sum(d1 * d2, dim=-1)
    sin2 = torch.clamp(1.0 - B * B, min=0.0)
    r1 = torch.sum(d1 * o2, dim=-1)  # d1 . (o2 - o1), o1 = 0
    r2 = torch.sum(d2 * o2, dim=-1)
    denom = torch.where(sin2 > 1e-12, -sin2, torch.full_like(sin2, -1e-12))
    a = (B * r2 - r1) / denom
    b = (r2 - B * r1) / denom
    X = (a[..., None] * d1 + o2 + b[..., None] * d2) * 0.5
    return X, sin2
