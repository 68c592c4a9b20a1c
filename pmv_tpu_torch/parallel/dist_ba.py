"""Distributed bundle adjustment over a (dp, lm) mesh — PyTorch counterpart
of ``pmv_tpu/parallel/dist_ba.py``.

- **lm axis:** the landmark blocks of one window are sharded across ranks.
  Each rank assembles its local V / W / b_lm and partial U / b_pose /
  reduced-system terms from its own observation shard; the (6P, 6P) reduced
  camera system is all-reduced over the ``lm`` group and solved redundantly
  on every rank; the landmark back-substitution stays local. Communication
  per LM iteration is O(P^2) numbers, whatever the landmark count.
- **dp axis:** independent BA windows run side by side, one block of them
  per dp coordinate (``pose_graph`` stitches the results).

The JAX package runs this as one ``shard_map`` over global arrays. Here
every rank runs :func:`make_distributed_ba`'s solver on the same global
arrays, takes its block as the JAX package's ``in_specs`` cut it, and
all-gathers the result as its ``out_specs`` assemble it, so that every rank
returns the same global result. ``mesh=None`` means one device: the windows
run one after another, each with its own LM state (damping, cost,
accept/reject), as ``jax.vmap`` gives them there.

Observations must be pre-partitioned by landmark shard: the observation
arrays are sharded along the same axis as the landmarks, and ``obs_lm``
holds *shard-local* landmark indices (:func:`partition_obs_by_landmark`;
with one shard that is a compaction of the masked observations). Padded
observations (mask clear, landmark 0) add nothing: the block assembly
zeroes them, and the cost masks them with ``torch.where`` (an all-pad shard
projects landmark 0 from pose 0, which may divide by zero, and one NaN would
reach every rank through the all-reduce).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from pmv_tpu_torch.ba import schur_lm
from pmv_tpu_torch.ba.schur_lm import all_reduce_sum, assemble_blocks, schur_solve
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def all_gather_cat(t: Tensor, group, dim: int = 0) -> Tensor:
    """The blocks of ``t`` of every rank of the process ``group``, in the
    group's coordinate order, concatenated along ``dim``."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


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
                    iters: int, delta: float, mode: str = "schur", group=None):
    """LM loop for ONE window. Returns (tr, lm, cost0, cost).

    With a process ``group`` (the ``lm`` axis) the arrays are this rank's
    landmark shard, and three things are summed over the group: the cost,
    the Schur step's blocks (``schur_solve(group=)``, one all-reduce) and
    the alternate pose step's (U, b_pose). The accept test and the damping
    read the reduced cost only, so every rank of the group takes the same
    branch.

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
        c = torch.sum(c)
        if group is not None:
            dist.all_reduce(c, group=group)
        return c

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
            dp, dx = schur_solve(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam, group=group)
            tr_try, lm_try = tr + dp * free, lm + dx
            cost_try = cost_of(tr_try, lm_try)
            accept = cost_try < cost
            tr = torch.where(accept, tr_try, tr)
            lm = torch.where(accept, lm_try, lm)
        else:
            # pose step (landmarks fixed): U is block-diagonal
            U, _, _, b_pose, _, _ = blocks(tr, lm)
            if group is not None:
                U, b_pose = all_reduce_sum((U, b_pose), group)
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


def make_distributed_ba(mesh: Mesh | None = None, iters: int = 5, delta: float = 1.0,
                        mode: str = "schur"):
    """A multi-window BA solver on ``mesh`` (``None``: one device). ``mode``:
    "schur" (joint LM, needs per-window gauge pins) or "alternate"
    (pose/landmark block descent, gauge anchored by the map; see
    :func:`_window_lm_loop`).

    The solver takes D windows, L landmarks, O observations per window
    (global arrays: every rank of a mesh is handed the same):

      tr (D, P, 6), lm (D, L, 3), obs_uv (D, O, 2), obs_pose (D, O),
      obs_lm (D, O) landmark indices, obs_mask (D, O), pose_free (D, P),
      K (3, 3)

    and returns (tr', lm', cost0 (D,), cost (D,)), every window with its own
    LM state: on the inputs' device without a mesh; on the mesh's device,
    the same on every rank, with one. On a (dp, lm) mesh D must divide by
    dp and L and O by lm: the rank at (d, s) solves windows [d*D/dp,
    (d+1)*D/dp) on landmarks [s*L/lm, (s+1)*L/lm) and observation block s
    (the shard-major layout of :func:`partition_obs_by_landmark`, with
    shard-local ``obs_lm``), then ``tr``, ``cost0`` and ``cost`` are
    all-gathered over dp and ``lm`` over lm and dp.
    """
    if mode not in ("schur", "alternate"):
        raise ValueError(f"unknown mode {mode!r}")
    if mesh is None:
        @torch.no_grad()
        def solve(tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K):
            out = [
                _window_lm_loop(tr[d], lm[d], obs_uv[d], obs_pose[d], obs_lm[d], obs_mask[d],
                                pose_free[d], K, iters=iters, delta=delta, mode=mode)
                for d in range(tr.shape[0])
            ]
            return tuple(torch.stack(x) for x in zip(*out))

        return solve
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh) or None, not {type(mesh).__name__}")
    n_dp, n_lm = mesh.shape["dp"], mesh.shape["lm"]
    d, s = mesh.coord["dp"], mesh.coord["lm"]
    dp_group, lm_group = mesh.group("dp"), mesh.group("lm")
    dev = mesh.device

    @torch.no_grad()
    def solve_sharded(tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K):
        D, L, O = tr.shape[0], lm.shape[1], obs_uv.shape[1]
        if D % n_dp or L % n_lm or O % n_lm:
            raise ValueError(f"{D} windows, {L} landmarks, {O} observations a window do not "
                             f"split over a {n_dp}x{n_lm} mesh")
        Dl, Ls, Os = D // n_dp, L // n_lm, O // n_lm
        lms, obs = slice(s * Ls, (s + 1) * Ls), slice(s * Os, (s + 1) * Os)
        K = K.to(dev)
        out = [
            _window_lm_loop(tr[w].to(dev), lm[w, lms].to(dev), obs_uv[w, obs].to(dev),
                            obs_pose[w, obs].to(dev), obs_lm[w, obs].to(dev),
                            obs_mask[w, obs].to(dev), pose_free[w].to(dev), K,
                            iters=iters, delta=delta, mode=mode, group=lm_group)
            for w in range(d * Dl, (d + 1) * Dl)
        ]
        tr_l, lm_l, cost0_l, cost_l = (torch.stack(x) for x in zip(*out))
        lm_l = all_gather_cat(lm_l, lm_group, dim=1)
        return tuple(all_gather_cat(x, dp_group) for x in (tr_l, lm_l, cost0_l, cost_l))

    return solve_sharded
