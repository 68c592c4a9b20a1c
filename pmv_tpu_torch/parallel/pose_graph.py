"""Pose-graph optimization — the window-stitching layer; PyTorch counterpart
of ``pmv_tpu/parallel/pose_graph.py``.

Many overlapping windows are bundle-adjusted independently
(:mod:`pmv_tpu_torch.parallel.dist_ba`) and reconciled here: each window
contributes relative-pose edges between its frames, and the graph is solved
for globally consistent absolute poses.

Pose convention matches the pipeline (reference composition semantics,
OdometryPipeline.cpp:180-181): an edge (i, j) measures (R_ij, t_ij) with
``R_j = R_ij R_i`` and ``t_j = R_i t_ij + t_i``.

Window edges form a pure chain, which :func:`stitch_chain` solves exactly in
float64 numpy on the host; :func:`optimize`, a dense damped Gauss-Newton
over all 6N parameters, remains for graphs with other edges.
"""

from __future__ import annotations

import numpy as np
import torch

from pmv_tpu_torch.ba.schur_lm import _sum_rows
from pmv_tpu_torch.core import geometry as geo

Tensor = torch.Tensor


def edge_residual(params_i: Tensor, params_j: Tensor, meas_R: Tensor, meas_t: Tensor) -> Tensor:
    """6-vector residual of edges; params are [angle_axis(R), t] per node,
    (..., 6) with (..., 3, 3) / (..., 3) measurements."""
    R_i = geo.rodrigues(params_i[..., :3])
    R_j = geo.rodrigues(params_j[..., :3])
    t_i = params_i[..., 3:]
    t_j = params_j[..., 3:]
    R_iT = R_i.transpose(-1, -2)
    pred_R = R_j @ R_iT
    pred_t = (R_iT @ (t_j - t_i)[..., None])[..., 0]
    dR = pred_R @ meas_R.transpose(-1, -2)
    # Rotation residual: vee of the skew part, ~= sin(theta) * axis (smooth
    # at the identity, where the full log map's arccos is not), equivalent
    # for the small edge errors of a VO pose graph.
    r_rot = 0.5 * torch.stack(
        [dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0], dR[..., 1, 0] - dR[..., 0, 1]],
        dim=-1,
    )
    return torch.cat([r_rot, pred_t - meas_t], dim=-1)


_jac = torch.func.vmap(torch.func.jacfwd(edge_residual, argnums=(0, 1)))


@torch.no_grad()
def optimize(
    poses_R: Tensor,  # (N, 3, 3)
    poses_t: Tensor,  # (N, 3)
    edges: Tensor,  # (E, 2) node indices (i, j)
    meas_R: Tensor,  # (E, 3, 3)
    meas_t: Tensor,  # (E, 3)
    edge_weight: Tensor,  # (E,)
    anchored: Tensor,  # (N,) bool — nodes held fixed (at least node 0)
    iters: int = 10,
    lam: float = 1e-6,
) -> tuple[Tensor, Tensor]:
    """Damped Gauss-Newton pose-graph solve in the inputs' dtype, on their
    device; forward-mode Jacobians. The dense (6N, 6N) normal matrix is
    summed block by block in an order the inputs fix. Returns (R (N,3,3),
    t (N,3))."""
    N = poses_t.shape[0]
    dtype = poses_t.dtype
    params = torch.cat([geo.rodrigues_inv(poses_R), poses_t], dim=1)
    ii, jj = edges[:, 0].long(), edges[:, 1].long()
    w = edge_weight.to(dtype)
    free = (~anchored).to(dtype)
    m6 = free.repeat_interleave(6)
    # (i, i), (j, j), (i, j), (j, i) blocks of every edge, rows of H (N*N, 36)
    h_key = torch.cat([ii * N + ii, jj * N + jj, ii * N + jj, jj * N + ii])
    b_key = torch.cat([ii, jj])
    for _ in range(iters):
        pi, pj = params[ii], params[jj]
        r = edge_residual(pi, pj, meas_R, meas_t) * w[:, None]
        Ji, Jj = _jac(pi, pj, meas_R, meas_t)
        Ji = Ji * w[:, None, None]
        Jj = Jj * w[:, None, None]
        blocks = torch.cat([
            Ji.transpose(1, 2) @ Ji, Jj.transpose(1, 2) @ Jj,
            Ji.transpose(1, 2) @ Jj, Jj.transpose(1, 2) @ Ji,
        ]).reshape(-1, 36)
        H = _sum_rows(h_key, blocks, N * N).reshape(N, N, 6, 6).permute(0, 2, 1, 3)
        g = torch.cat([(Ji.transpose(1, 2) @ r[..., None])[..., 0],
                       (Jj.transpose(1, 2) @ r[..., None])[..., 0]])
        b = -_sum_rows(b_key, g, N)
        Hf = H.reshape(6 * N, 6 * N) * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6 + lam)
        dp = torch.linalg.solve(Hf, (b.reshape(-1) * m6)[:, None])[:, 0].reshape(N, 6)
        params = params + dp * free[:, None]
    return geo.rodrigues(params[:, :3]), params[:, 3:]


def stitch_chain(n_nodes: int, edges, meas_R, meas_t, R0, t0):
    """Exact chain stitch: average the parallel edges of every consecutive
    pair (chordal rotation mean via SVD projection, arithmetic translation
    mean) and compose absolute poses from the node-0 anchor. O(N) host-side
    float64 numpy.

    ``edges`` (E, 2) must all be consecutive pairs (i, i+1): VO window edges
    form a pure chain (:func:`window_edges` emits only such pairs;
    overlapping windows contribute parallel edges). On a chain the dense
    Gauss-Newton :func:`optimize` is exactly edge averaging, but its float32
    normal solve has a chain-Laplacian condition number growing ~N^2 (the
    JAX package measured NaN at 596 nodes); this closed form has no
    conditioning limit. A pair with no edge carries the previous pose.
    """
    edges = np.asarray(edges)
    if not (edges[:, 1] - edges[:, 0] == 1).all():
        raise ValueError("stitch_chain needs a chain of (i, i+1) edges")
    mR = np.asarray(meas_R, np.float64)
    mt = np.asarray(meas_t, np.float64)
    sum_R = np.zeros((n_nodes - 1, 3, 3))
    sum_t = np.zeros((n_nodes - 1, 3))
    cnt = np.zeros(n_nodes - 1)
    np.add.at(sum_R, edges[:, 0], mR)
    np.add.at(sum_t, edges[:, 0], mt)
    np.add.at(cnt, edges[:, 0], 1.0)
    R_out = np.empty((n_nodes, 3, 3))
    t_out = np.empty((n_nodes, 3))
    R_out[0] = np.asarray(R0, np.float64)
    t_out[0] = np.asarray(t0, np.float64)
    for i in range(n_nodes - 1):
        if cnt[i] > 0:
            # Chordal mean: project the summed rotations back onto SO(3).
            U, _, Vt = np.linalg.svd(sum_R[i])
            D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
            R_ij = U @ D @ Vt
            t_ij = sum_t[i] / cnt[i]
        else:  # gap in coverage: identity edge
            R_ij = np.eye(3)
            t_ij = np.zeros(3)
        # Composition convention: R_j = R_ij R_i; t_j = R_i t_ij + t_i.
        R_out[i + 1] = R_ij @ R_out[i]
        t_out[i + 1] = R_out[i] @ t_ij + t_out[i]
    return R_out, t_out


def window_edges(window_frames: list[list[int]], window_R: list, window_t: list):
    """Pose-graph edges from per-window absolute poses: one edge per
    consecutive pair inside each window (windows overlap, so overlapping
    pairs contribute several edges). Returns (edges (E,2) int32, meas_R
    (E,3,3), meas_t (E,3)) as numpy arrays."""
    E_idx, E_R, E_t = [], [], []
    for frames, Rs, ts in zip(window_frames, window_R, window_t):
        for a in range(len(frames) - 1):
            Ra, Rb = np.asarray(Rs[a]), np.asarray(Rs[a + 1])
            E_idx.append((frames[a], frames[a + 1]))
            E_R.append(Rb @ Ra.T)
            E_t.append(Ra.T @ (np.asarray(ts[a + 1]) - np.asarray(ts[a])))
    return np.asarray(E_idx, np.int32), np.stack(E_R), np.stack(E_t)
