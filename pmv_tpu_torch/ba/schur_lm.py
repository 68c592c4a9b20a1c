"""Sliding-window bundle adjustment: Levenberg-Marquardt with Schur
complement reduction of the landmark blocks — PyTorch counterpart of
``pmv_tpu/ba/schur_lm.py``.

Replacement for CeresBundleAdjustment.cpp:5-89 (SPARSE_SCHUR, Huber(1.0),
``max_iterations`` from config). Parameterization is identical to the
reference: each window pose is the 6-vector ``[angle_axis(R^T), -t]``
(CeresBundleAdjustment.cpp:26-34), each landmark a world-frame 3-vector, and
the residual is ``observed - ba_project(tr, X)``
(include/ProjectionResidual.h:38-58).

Structure exploited as SPARSE_SCHUR does, but as dense batched tensor
algebra: landmark Hessian blocks V are (L, 3, 3) and inverted in closed
form; pose-landmark coupling W is a dense (L, P, 6, 3) tensor (P = window
size <= ~10); the reduced camera system S is a tiny (6P, 6P) dense solve.

Two solvers share the damped Schur solve and the LM loop:

- :func:`ba_solve_grid` (the default loop's, ``fused.ba_step``): observations
  laid out (P, N) pose-major. The JAX package's one-hot matrix products and
  their chunking were scatter workarounds of its target and are not carried
  over. On a CUDA device a call replays a CUDA graph of the eager body, one
  graph per window shape (:func:`_graph_key`): the loop is thousands of
  small kernels (about 32k at 50 iterations) whose launches, not their
  work, set its time, and it never reads a value back.
- :func:`ba_solve` (the modular loop's, ``OdometryPipeline.bundle_adjust``):
  flat observation arrays (O,), a :class:`BAProblem`; the pose blocks are
  summed the same way as the landmark blocks.

Both add every block of an observation into its (landmark, pose) row with
:func:`_sum_rows`, in an order that the inputs fix, and then sum the rows
over poses (and over landmarks) in a fixed order: the same inputs give the
same blocks bit for bit on every run, also where a window repeats a
(landmark, pose) pair. It can: ``MapState.insert`` is a ring, so once it
wraps, a slot that still carries a reused id names the same landmark as the
slot it was bound to anew. Masked observations add zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.core.linalg import gj_solve
from pmv_tpu_torch.utils.profiling import count

Tensor = torch.Tensor


class BAProblem(NamedTuple):
    """Window BA problem with flat observation arrays.

    tr:        (P, 6)  pose blocks [angle_axis(R^T), -t]
    lm:        (L, 3)  landmark positions (world frame)
    obs_uv:    (O, 2)  observed pixels
    obs_pose:  (O,)    int32 window-pose index per observation
    obs_lm:    (O,)    int32 landmark index per observation
    obs_mask:  (O,)    bool  observation is real
    pose_free: (P,)    bool  pose participates in optimization (the reference
                       skips global frame 0, CeresBundleAdjustment.cpp:22-23)
    K:         (3, 3)  intrinsics
    """

    tr: Tensor
    lm: Tensor
    obs_uv: Tensor
    obs_pose: Tensor
    obs_lm: Tensor
    obs_mask: Tensor
    pose_free: Tensor
    K: Tensor


def _residuals(tr, lm, p: BAProblem) -> Tensor:
    """Per-observation residual r = observed - predicted, (O, 2)."""
    pred = geo.ba_project(tr[p.obs_pose.long()], lm[p.obs_lm.long()], p.K)
    return p.obs_uv - pred


def _huber_cost(r2: Tensor, delta: float) -> Tensor:
    """Huber rho(s) on squared norms s (Ceres HuberLoss semantics)."""
    d2 = delta * delta
    return torch.where(
        r2 <= d2, r2, 2.0 * delta * torch.sqrt(torch.clamp(r2, min=1e-18)) - d2
    )


def _inv3x3(V: Tensor) -> Tensor:
    """Batched closed-form 3x3 inverse via adjugate; (L, 3, 3) -> (L, 3, 3).
    Singular blocks (landmarks with too few observations) return ~0 so their
    update vanishes instead of exploding."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def robust_cost(tr, lm, p: BAProblem, delta: float = 1.0) -> Tensor:
    """Huber cost of the flat problem's real observations."""
    r = _residuals(tr, lm, p)
    r2 = torch.sum(r * r, dim=-1)
    return torch.sum(torch.where(p.obs_mask, _huber_cost(r2, delta), 0.0))


def _sum_rows(key: Tensor, vals: Tensor, n_rows: int) -> Tensor:
    """``zeros(n_rows, C).index_add_(0, key, vals)`` for key (O,) and vals
    (O, C), summed in an order that the inputs fix on every device
    (``index_add_`` on a CUDA tensor adds the values of a repeated key with
    atomics, in no fixed order): the values are sorted stably by key, and
    ``segment_reduce`` adds the values of each row one after another in
    their input order, ((0 + x0) + x1) + x2. No host synchronisation (the
    row lengths are an integer sum, exact in any order)."""
    lengths = torch.zeros(n_rows, dtype=key.dtype, device=key.device).index_add_(
        0, key, torch.ones_like(key))
    return torch.segment_reduce(vals[torch.argsort(key, stable=True)], "sum",
                                lengths=lengths, unsafe=True)


def _residual_jacobians(tr: Tensor, lm_o: Tensor, obs_uv: Tensor, K: Tensor):
    """Residual ``uv - ba_project(tr, X)`` and its Jacobians with respect to
    the pose block and the landmark, per observation of a (P, N) grid: tr
    (P, 6), lm_o (P, N, 3) -> r (P, N, 2), Jp (P, N, 2, 6), Jl (P, N, 2, 3).
    (Flat observations come as N = 1: tr (O, 6), lm_o (O, 1, 3).) In closed
    form (the JAX package takes ``jacfwd`` of the same residual)."""
    q, dq_daa, R = geo.angle_axis_rotate_jac(tr[:, :3], lm_o + tr[:, None, 3:6])
    z = -q[..., 2]
    fx, fy = K[0, 0], K[1, 1]
    pred = torch.stack([q[..., 0] / z * fx + K[0, 2], q[..., 1] / z * fy + K[1, 2]], dim=-1)
    zero = torch.zeros_like(z)
    # d pred / d q, with z = -q_z
    dpred_dq = torch.stack(
        [
            torch.stack([fx / z, zero, fx * q[..., 0] / (z * z)], dim=-1),
            torch.stack([zero, fy / z, fy * q[..., 1] / (z * z)], dim=-1),
        ],
        dim=-2,
    )  # (P, N, 2, 3)
    # Forward-mode JAX takes d(q_i / z) as dq_i / z + (-dz * q_i) * z^-2. For a
    # point about 1e19 or farther the product overflows and z^-2 underflows,
    # so the JAX package's derivative is NaN (and its step is rejected); the
    # port's is NaN there too.
    z_inv2 = (1.0 / (z * z))[..., None]
    jvp_term = torch.stack([(dq_daa[..., 2, :] * q[..., i, None]) * z_inv2 for i in (0, 1)], dim=-2)
    Jl = -(dpred_dq @ R[:, None])  # dq/dX = dq/d(tr[3:6]) = R
    J_aa = torch.where(torch.isfinite(jvp_term), -(dpred_dq @ dq_daa), jvp_term)
    Jp = torch.cat([J_aa, Jl], dim=-1)
    return obs_uv - pred, Jp, Jl


def assemble_blocks_grid(tr, lm, obs_uv, local, obs_mask, pose_free, K, delta):
    """Assemble the Schur building blocks from (P, N)-grid observations.

    tr (P, 6), lm (L, 3), obs_uv (P, N, 2), local (P, N) landmark index of
    each observation, obs_mask (P, N), pose_free (P,). Returns (U (P,6,6),
    V (L,3,3), Wc (L,P,6,3), b_pose (P,6), b_lm (L,3), has_obs (L,)).
    """
    P, N = obs_mask.shape
    L = lm.shape[0]
    local = local.long()
    r, Jp, Jl = _residual_jacobians(tr, lm[local], obs_uv, K)
    # Masked observations must be inert even when their residual is NaN/Inf
    # (padded slots index arbitrary pose/landmark pairs, which can divide by
    # z = 0; NaN * 0-weight is still NaN).
    r = torch.where(obs_mask[..., None], r, 0.0)
    Jp = torch.where(obs_mask[..., None, None], Jp, 0.0)
    Jl = torch.where(obs_mask[..., None, None], Jl, 0.0)

    r2 = torch.sum(r * r, dim=-1)
    w = geo.huber_weight(r2, delta) * obs_mask  # IRLS weights (P, N)
    # A fixed pose contributes no pose Jacobian, but its observations still
    # constrain the landmarks.
    Jp = Jp * pose_free[:, None, None, None]
    wJp = Jp * w[..., None, None]
    wJl = Jl * w[..., None, None]

    U = torch.einsum("pnik,pnij->pkj", wJp, Jp)
    # Gradient (minimize 1/2 w r^2 with J = dr/dtheta -> solve
    # H delta = -J^T w r; the minus is folded into b).
    b_pose = -torch.einsum("pnik,pni->pk", wJp, r)
    VV = torch.einsum("pnik,pnij->pnkj", wJl, Jl).reshape(P * N, 9)
    WW = torch.einsum("pnik,pnij->pnkj", wJp, Jl).reshape(P * N, 18)
    bl = -torch.einsum("pnik,pni->pnk", wJl, r).reshape(P * N, 3)

    # One row per (landmark, pose): 9 of V, 18 of Wc, 3 of b_lm, 1 count.
    pose = torch.arange(P, device=tr.device).repeat_interleave(N)
    count = obs_mask.reshape(P * N, 1).to(tr.dtype)
    rows = _sum_rows(local.reshape(P * N) * P + pose, torch.cat([VV, WW, bl, count], dim=1),
                     L * P).reshape(L, P, 31)
    per_lm = rows.sum(dim=1)
    V, b_lm, n_obs = per_lm[:, :9], per_lm[:, 27:30], per_lm[:, 30]
    Wc = rows[:, :, 9:27]
    return U, V.reshape(L, 3, 3), Wc.reshape(L, P, 6, 3), b_pose, b_lm, n_obs > 0


def assemble_blocks(tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K, delta):
    """Assemble the Schur building blocks from flat observations (O,).

    Returns (U (P,6,6), V (L,3,3), Wc (L,P,6,3), b_pose (P,6), b_lm (L,3),
    has_obs (L,)).
    """
    P = tr.shape[0]
    L = lm.shape[0]
    O = obs_pose.shape[0]
    pose = obs_pose.long()
    r, Jp, Jl = (x[:, 0] for x in _residual_jacobians(
        tr[pose], lm[obs_lm.long()][:, None], obs_uv[:, None], K))
    # Masked observations must be inert even when their residual is NaN/Inf
    # (padded slots index arbitrary pose/landmark pairs, which can divide by
    # z = 0; NaN * 0-weight is still NaN).
    r = torch.where(obs_mask[:, None], r, 0.0)
    Jp = torch.where(obs_mask[:, None, None], Jp, 0.0)
    Jl = torch.where(obs_mask[:, None, None], Jl, 0.0)

    r2 = torch.sum(r * r, dim=-1)
    w = geo.huber_weight(r2, delta) * obs_mask  # IRLS weights (O,)
    # A fixed pose contributes no pose Jacobian, but its observations still
    # constrain the landmarks.
    Jp = Jp * pose_free[pose][:, None, None]
    wJp = Jp * w[:, None, None]
    wJl = Jl * w[:, None, None]

    # Per observation: 9 of V, 18 of Wc, 3 of b_lm, 1 count, 36 of U, 6 of
    # b_pose (the minus of b folded in: H delta = -J^T w r).
    vals = torch.cat([
        torch.einsum("oik,oij->okj", wJl, Jl).reshape(O, 9),
        torch.einsum("oik,oij->okj", wJp, Jl).reshape(O, 18),
        -torch.einsum("oik,oi->ok", wJl, r),
        obs_mask[:, None].to(tr.dtype),
        torch.einsum("oik,oij->okj", wJp, Jp).reshape(O, 36),
        -torch.einsum("oik,oi->ok", wJp, r),
    ], dim=1)
    rows = _sum_rows(obs_lm.long() * P + pose, vals, L * P).reshape(L, P, 73)
    per_lm = rows[:, :, :31].sum(dim=1)
    per_pose = rows[:, :, 31:].sum(dim=0)
    V, b_lm, n_obs = per_lm[:, :9], per_lm[:, 27:30], per_lm[:, 30]
    Wc = rows[:, :, 9:27]
    return (per_pose[:, :36].reshape(P, 6, 6), V.reshape(L, 3, 3), Wc.reshape(L, P, 6, 3),
            per_pose[:, 36:], b_lm, n_obs > 0)


def all_reduce_sum(tensors, group) -> list[torch.Tensor]:
    """Sum each of ``tensors`` (one dtype) over the process ``group`` in ONE
    all-reduce: they are flattened into one buffer, reduced, and split
    again. Returns new tensors of the inputs' shapes. Called through
    ``torch.distributed`` at call time, so that a wrapper installed there
    (``parallel.probe.count_collectives``) sees the call."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    parts = flat.split([t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


def schur_solve(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam, *, group=None):
    """Damped Schur-complement solve from assembled blocks. Returns
    (dp (P,6), dx (L,3)).

    With a process ``group`` (the ``lm`` axis of a mesh: landmark-sharded
    BA), U, b_pose and the reduced system's partials are summed over it in
    one all-reduce; the (6P, 6P) solve then runs redundantly on every rank,
    and the landmark back-substitution stays local."""
    P = b_pose.shape[0]
    dtype, dev = b_pose.dtype, b_pose.device
    eyeP = torch.eye(6, dtype=dtype, device=dev)
    eyeL = torch.eye(3, dtype=dtype, device=dev)
    # f32 gauge hygiene: the window often has NO pinned pose (reference
    # semantics, CeresBundleAdjustment.cpp:22-24 skips only global frame 0),
    # so the normal equations carry a 7-DOF null space. Ceres survives it in
    # double precision; in f32 the gradient's numerical null-space component
    # divided by a near-zero damped eigenvalue produces meter-scale gauge
    # jumps. A scale-aware absolute Tikhonov term caps the null-direction
    # step while staying ~1e-6 relative to the data directions.
    muV = (
        1e-6 * torch.mean(torch.diagonal(V, dim1=-2, dim2=-1).abs(), dim=-1) + 1e-9
    )[:, None, None]
    V_d = V + lam * (V * eyeL) + muV * eyeL

    V_inv = _inv3x3(V_d)  # (L, 3, 3)
    Y = torch.einsum("lpij,ljk->lpik", Wc, V_inv)  # (L, P, 6, 3)

    # Reduced camera system S = U_d - sum_l W V^-1 W^T. The correction terms
    # depend only on landmark-local blocks, so the sharded form defers the
    # U / b_pose reduction and ships all four in ONE all-reduce per LM
    # iteration (muV above is per landmark block, so sharded and one-device
    # damping agree; muP below comes from the reduced U, so every rank damps
    # alike).
    S_corr = torch.einsum("lpik,lqjk->piqj", Y, Wc)
    b_corr = torch.einsum("lpik,lk->pi", Y, b_lm)
    if group is not None:
        U, b_pose, S_corr, b_corr = all_reduce_sum((U, b_pose, S_corr, b_corr), group)
    muP = 1e-6 * torch.mean(torch.diagonal(U, dim1=-2, dim2=-1).abs()) + 1e-9
    U_d = U + lam * (U * eyeP) + muP * eyeP
    S = -S_corr
    ar = torch.arange(P, device=dev)
    S[ar, :, ar, :] += U_d
    b_red = b_pose - b_corr

    # Pin non-free poses: identity rows/cols, zero rhs.
    m6 = pose_free.repeat_interleave(6).to(dtype)  # (6P,)
    S_flat = S.reshape(6 * P, 6 * P)
    S_flat = S_flat * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
    b_flat = b_red.reshape(-1) * m6

    # Pivot-free Gauss-Jordan: S is Tikhonov+LM-damped SPD (pinned rows carry
    # an explicit unit diagonal).
    dp = gj_solve(S_flat, b_flat[:, None])[:, 0].reshape(P, 6)
    # Back-substitute landmarks: dx = V^-1 (b_lm - W^T dp).
    Wt_dp = torch.einsum("lpik,pi->lk", Wc, dp)
    dx = torch.einsum("ljk,lk->lj", V_inv, b_lm - Wt_dp)
    dx = dx * has_obs[:, None]
    return dp, dx


def _lm_loop(tr, lm, lam0, iters, step_fn, cost_fn):
    """The LM accept/damping loop.

    ``step_fn(tr, lm, lam) -> (tr_try, lm_try)`` proposes a damped step;
    ``cost_fn(tr, lm)`` evaluates the robust cost. Accept iff the cost
    decreases; on accept lam /= 3 (floored at 1e-6 — in f32 a near-zero lam
    lets the Schur solve amplify rounding noise along weakly-observed
    directions), on reject lam *= 4 (capped at 1e6). The accept test is a
    ``torch.where`` on device values, and ``lam0`` is filled in on the
    device: no host synchronisation, so a CUDA graph can hold the loop.
    """
    cost0 = cost_fn(tr, lm)
    cost = cost0
    lam = torch.full((), lam0, dtype=tr.dtype, device=tr.device)
    hist = []
    for _ in range(iters):
        tr_try, lm_try = step_fn(tr, lm, lam)
        cost_try = cost_fn(tr_try, lm_try)
        accept = cost_try < cost
        tr = torch.where(accept, tr_try, tr)
        lm = torch.where(accept, lm_try, lm)
        lam = torch.where(
            accept, torch.clamp(lam / 3.0, min=1e-6), torch.clamp(lam * 4.0, max=1e6)
        )
        cost = torch.where(accept, cost_try, cost)
        hist.append(cost)
    history = torch.stack(hist) if hist else cost0.new_zeros((0,))
    return tr, lm, {"cost0": cost0, "cost": cost, "history": history}


def _cost_grid(tr, lm, obs_uv, local, obs_mask, K, delta):
    """Huber cost over (P, N)-grid observations."""
    tr_o = tr[:, None, :].expand(obs_mask.shape + (6,))
    pred = geo.ba_project(tr_o, lm[local.long()], K)
    r = obs_uv - pred
    r2 = torch.sum(r * r, dim=-1)
    return torch.sum(torch.where(obs_mask, _huber_cost(r2, delta), 0.0))


def _ba_solve_grid_eager(
    tr,
    lm,
    obs_uv,
    local,
    obs_mask,
    pose_free,
    K,
    iters: int = 5,
    delta: float = 1.0,
    lam0: float = 1e-4,
    obs_gate_px: float = 0.0,
):
    """The body of :func:`ba_solve_grid`, run as PyTorch dispatches it
    (what a CUDA graph of it captures)."""
    if obs_gate_px > 0:
        pred = geo.ba_project(
            tr[:, None, :].expand(obs_mask.shape + (6,)), lm[local.long()], K
        )
        r0 = obs_uv - pred
        ok = torch.sum(r0 * r0, dim=-1) < obs_gate_px * obs_gate_px
        obs_mask = obs_mask & ok

    def step_fn(tr_c, lm_c, lam):
        U, V, Wc, b_pose, b_lm, has_obs = assemble_blocks_grid(
            tr_c, lm_c, obs_uv, local, obs_mask, pose_free, K, delta
        )
        dp, dx = schur_solve(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam)
        return tr_c + dp * pose_free[:, None], lm_c + dx

    def cost_fn(tr_c, lm_c):
        return _cost_grid(tr_c, lm_c, obs_uv, local, obs_mask, K, delta)

    return _lm_loop(tr, lm, lam0, iters, step_fn, cost_fn)


def ba_solve_grid(
    tr,
    lm,
    obs_uv,
    local,
    obs_mask,
    pose_free,
    K,
    iters: int = 5,
    delta: float = 1.0,
    lam0: float = 1e-4,
    obs_gate_px: float = 0.0,
):
    """Run ``iters`` LM iterations (the config's ``max_iterations``, matching
    CeresBundleAdjustment.cpp:59) over (P, N)-grid observations. Returns
    (tr, lm, stats).

    ``obs_gate_px`` > 0 drops observations whose INITIAL reprojection
    residual exceeds the gate before solving — the standard defense against
    corrupted associations, which Huber alone cannot contain when they are
    numerous. The reference has no such gate (0 for strict parity).

    On a CUDA device the call replays its window shape's CUDA graph of
    :func:`_ba_solve_grid_eager` (the same kernels in the same order, so the
    same bits) and returns copies of the graph's outputs; elsewhere it runs
    that body as it is."""
    args = (tr, lm, obs_uv, local, obs_mask, pose_free, K)
    kw = dict(iters=iters, delta=delta, lam0=lam0, obs_gate_px=obs_gate_px)
    if tr.device.type != "cuda":
        return _ba_solve_grid_eager(*args, **kw)
    with torch.cuda.device(tr.device):
        key = _graph_key(*args, **kw)
        g = _GRAPHS.get(key)
        if g is None:
            g = _GRAPHS[key] = _SolveGraph(args, kw)
        return g(args)


def _graph_key(tr, lm, obs_uv, local, obs_mask, pose_free, K, *, iters, delta, lam0, obs_gate_px):
    """What a captured solve is fixed to: device, dtype, window poses P,
    feature slots N, landmarks L_win, the iterations and the float
    arguments (kernel arguments in the graph), and the inputs' dtypes."""
    P, N = obs_mask.shape
    return (tr.device, tr.dtype, P, N, lm.shape[0], int(iters), float(delta), float(lam0),
            float(obs_gate_px), tuple(x.dtype for x in (lm, obs_uv, local, obs_mask, pose_free, K)))


class _SolveGraph:
    """One window shape's CUDA graph of :func:`_ba_solve_grid_eager`, with
    the static buffers it reads (copies of the first call's inputs) and
    writes (its outputs, in the graph's private memory pool)."""

    def __init__(self, args, kw):
        self.inputs = [a.clone() for a in args]
        # Warm up on a side stream (library handles and workspaces are made
        # outside the capture), then capture. Thread-local capture mode: a
        # CUDA call that another thread makes meanwhile (the caller's frame
        # prefetcher, a profiler's) does not invalidate the capture.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _ba_solve_grid_eager(*self.inputs, **kw)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = _ba_solve_grid_eager(*self.inputs, **kw)
        count("ba.graph.capture")

    def __call__(self, args):
        """Copy ``args`` into the static inputs, replay, and return copies of
        the outputs: a later replay overwrites the graph's own."""
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        count("ba.graph.replay")
        tr, lm, stats = self.outputs
        return tr.clone(), lm.clone(), {k: v.clone() for k, v in stats.items()}


# Captured solves by :func:`_graph_key`, kept for the process: a pipeline
# built later (each drive of the benchmark builds its own) replays the graph
# an earlier one captured.
_GRAPHS: dict[tuple, _SolveGraph] = {}


def _lm_step(tr, lm, p: BAProblem, lam, delta: float):
    """One damped LM step. Returns (tr_new, lm_new)."""
    U, V, Wc, b_pose, b_lm, has_obs = assemble_blocks(
        tr, lm, p.obs_uv, p.obs_pose, p.obs_lm, p.obs_mask, p.pose_free, p.K, delta
    )
    dp, dx = schur_solve(U, V, Wc, b_pose, b_lm, has_obs, p.pose_free, lam)
    return tr + dp * p.pose_free[:, None], lm + dx


def ba_solve(
    p: BAProblem,
    iters: int = 5,
    delta: float = 1.0,
    lam0: float = 1e-4,
    obs_gate_px: float = 0.0,
):
    """Run ``iters`` LM iterations over the flat problem (the config's
    ``max_iterations``, matching CeresBundleAdjustment.cpp:59). Returns (tr,
    lm, stats).

    ``obs_gate_px`` > 0 drops observations whose INITIAL reprojection
    residual exceeds the gate before solving (the reference has no such
    gate: 0 for strict parity)."""
    if obs_gate_px > 0:
        r0 = _residuals(p.tr, p.lm, p)
        ok = torch.sum(r0 * r0, dim=-1) < obs_gate_px * obs_gate_px
        p = p._replace(obs_mask=p.obs_mask & ok)

    def step_fn(tr, lm, lam):
        return _lm_step(tr, lm, p, lam, delta)

    def cost_fn(tr, lm):
        return robust_cost(tr, lm, p, delta)

    return _lm_loop(p.tr, p.lm, lam0, iters, step_fn, cost_fn)
