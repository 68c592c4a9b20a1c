"""Multi-window bundle adjustment — PyTorch counterpart of
``pmv_tpu/parallel/dist_ba.py``, on one device.

The JAX package decomposes windowed BA over a (dp, lm) device mesh: the
``lm`` axis shards the landmark blocks of one window (the reduced camera
system is all-reduced), the ``dp`` axis runs independent windows side by
side. On one device the ``lm`` axis has size 1, so every all-reduce is the
identity, and the windows run one after another, each with its own LM state
(damping, cost, accept/reject), as ``jax.vmap`` gives them there. A mesh of
several devices is ROADMAP Queue 1 item 5 and raises here.

Observations are laid out by landmark shard on the host
(:func:`partition_obs_by_landmark`); with one shard that is a compaction of
the masked observations. Padded observations (mask clear, landmark 0) add
nothing: the block assembly zeroes them.
"""

from __future__ import annotations

import numpy as np
import torch

from pmv_tpu_torch.ba import schur_lm
from pmv_tpu_torch.ba.schur_lm import assemble_blocks, schur_solve
from pmv_tpu_torch.core import geometry as geo

Tensor = torch.Tensor

MESH_NOT_PORTED = (
    "a device mesh is not ported yet (ROADMAP Queue 1 item 5: mesh, NCCL "
    "dist_ba, multi_seq with a mesh); pass mesh=None for one device"
)


def partition_obs_by_landmark(
    obs_uv: np.ndarray,
    obs_pose: np.ndarray,
    obs_lm: np.ndarray,
    obs_mask: np.ndarray,
    n_landmarks: int,
    n_shards: int,
):
    """Host-side layout: pad L to a multiple of ``n_shards`` and re-bucket
    the observations so shard s holds exactly the observations of landmarks
    [s*Ls, (s+1)*Ls), with shard-local indices. Returns (obs_uv', obs_pose',
    obs_lm_local', obs_mask', O_per_shard, Ls), the primed arrays of shape
    (n_shards * O_s, ...) laid out shard-major."""
    L_pad = -(-n_landmarks // n_shards) * n_shards
    Ls = L_pad // n_shards
    shard_of = obs_lm // Ls
    buckets = [np.where((shard_of == s) & obs_mask)[0] for s in range(n_shards)]
    O_s = max(max((len(b) for b in buckets), default=1), 1)
    uv = np.zeros((n_shards, O_s, 2), obs_uv.dtype)
    pose = np.zeros((n_shards, O_s), obs_pose.dtype)
    lml = np.zeros((n_shards, O_s), obs_lm.dtype)
    msk = np.zeros((n_shards, O_s), bool)
    for s, b in enumerate(buckets):
        k = len(b)
        uv[s, :k] = obs_uv[b]
        pose[s, :k] = obs_pose[b]
        lml[s, :k] = obs_lm[b] - s * Ls
        msk[s, :k] = True
    return (uv.reshape(n_shards * O_s, 2), pose.reshape(-1), lml.reshape(-1),
            msk.reshape(-1), O_s, Ls)


def _window_lm_loop(tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K,
                    iters: int, delta: float, mode: str = "schur"):
    """LM loop for ONE window. Returns (tr, lm, cost0, cost).

    ``mode="schur"``: the joint LM step through the Schur complement (the
    window needs its gauge fixed by pinned poses, or free landmarks can
    slide the whole solution).

    ``mode="alternate"``: block coordinate descent — a pose step against
    fixed landmarks (each free pose a damped 6x6 solve; the map anchors the
    gauge, so no pose needs pinning), then a landmark step against fixed
    poses (a 3x3 solve each), each accepted on its own cost decrease. The
    refinement mode: cost cannot trade off against gauge drift.

    Damping starts at 1e-4; an accept divides it by 3 (floor 1e-9), a
    reject multiplies it by 4 (cap 1e6). Accepts are ``torch.where`` on
    device values: no host synchronisation.
    """
    pose = obs_pose.long()
    lm_idx = obs_lm.long()

    def cost_of(tr_, lm_):
        r = obs_uv - geo.ba_project(tr_[pose], lm_[lm_idx], K)
        c = torch.where(obs_mask, schur_lm._huber_cost(torch.sum(r * r, dim=-1), delta), 0.0)
        return torch.sum(c)

    def blocks(tr_, lm_):
        return assemble_blocks(tr_, lm_, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K, delta)

    def damp(lam, accept):
        return torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                           torch.clamp(lam * 4.0, max=1e6))

    eye6 = torch.eye(6, dtype=tr.dtype, device=tr.device)
    eye3 = torch.eye(3, dtype=lm.dtype, device=lm.device)
    free = pose_free[:, None].to(tr.dtype)
    cost0 = cost_of(tr, lm)
    cost = cost0
    lam = torch.tensor(1e-4, dtype=tr.dtype, device=tr.device)
    for _ in range(iters):
        if mode == "schur":
            U, V, Wc, b_pose, b_lm, has_obs = blocks(tr, lm)
            dp, dx = schur_solve(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam)
            tr_try, lm_try = tr + dp * free, lm + dx
            cost_try = cost_of(tr_try, lm_try)
            accept = cost_try < cost
            tr = torch.where(accept, tr_try, tr)
            lm = torch.where(accept, lm_try, lm)
        else:
            # pose step (landmarks fixed): U is block-diagonal
            U, _, _, b_pose, _, _ = blocks(tr, lm)
            U_d = U + lam * (U * eye6) + 1e-9 * eye6
            dp = torch.linalg.solve(U_d, b_pose[..., None])[..., 0]
            tr_try = tr + dp * free
            cost_try = cost_of(tr_try, lm)
            accept = cost_try < cost
            tr = torch.where(accept, tr_try, tr)
            cost = torch.where(accept, cost_try, cost)
            # landmark step (poses fixed): a 3x3 solve per landmark
            _, V, _, _, b_lm, has_obs = blocks(tr, lm)
            V_d = V + lam * (V * eye3) + 1e-9 * eye3
            dx = (schur_lm._inv3x3(V_d) @ b_lm[..., None])[..., 0]
            lm_try = lm + dx * has_obs[:, None]
            cost_try = cost_of(tr, lm_try)
            accept = cost_try < cost
            lm = torch.where(accept, lm_try, lm)
        lam = damp(lam, accept)
        cost = torch.where(accept, cost_try, cost)
    return tr, lm, cost0, cost


def make_distributed_ba(mesh=None, iters: int = 5, delta: float = 1.0, mode: str = "schur"):
    """A multi-window BA solver. ``mesh=None`` means one device (the only
    form ported). ``mode``: "schur" (joint LM, needs per-window gauge pins)
    or "alternate" (pose/landmark block descent, gauge anchored by the map;
    see :func:`_window_lm_loop`).

    The solver takes D windows, L landmarks, O observations per window:

      tr (D, P, 6), lm (D, L, 3), obs_uv (D, O, 2), obs_pose (D, O),
      obs_lm (D, O) landmark indices, obs_mask (D, O), pose_free (D, P),
      K (3, 3)

    and returns (tr', lm', cost0 (D,), cost (D,)) on the inputs' device,
    every window with its own LM state.
    """
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    if mode not in ("schur", "alternate"):
        raise ValueError(f"unknown mode {mode!r}")

    @torch.no_grad()
    def solve(tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K):
        out = [
            _window_lm_loop(tr[d], lm[d], obs_uv[d], obs_pose[d], obs_lm[d], obs_mask[d],
                            pose_free[d], K, iters=iters, delta=delta, mode=mode)
            for d in range(tr.shape[0])
        ]
        return tuple(torch.stack(x) for x in zip(*out))

    return solve
