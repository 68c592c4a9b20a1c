"""Global trajectory refinement: windowed BA + pose-graph stitching —
PyTorch counterpart of ``pmv_tpu/parallel/global_refine.py``.

A finished run's trajectory is cut into overlapping windows; every window is
bundle-adjusted against the end-of-run map (:mod:`.dist_ba`: on one device,
or on a (dp, lm) mesh, windows over dp and landmark blocks over lm), and the
windows' relative motions are reconciled into one trajectory by the
pose-graph layer (:mod:`.pose_graph`): exactly, in float64 on the host, when
the edges form a chain, as window edges do. The reference has no
counterpart; it runs one sequential sliding window
(CeresBundleAdjustment.cpp).

Landmarks are duplicated per window (each window refines its own copy); the
output is the pose trajectory, which the error metrics read. The per-frame
feature tables come from any run mode: ``run()`` keeps them on the device
(``StepState.tbl_*_hist``) and hands them out after the run, as does
``run_modular()``.
"""

from __future__ import annotations

import numpy as np
import torch

from pmv_tpu_torch import resolve_device
from pmv_tpu_torch.core import geometry as geo
from pmv_tpu_torch.parallel import dist_ba, pose_graph


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)


def window_ranges(n: int, window: int, overlap: int) -> list[list[int]]:
    """The frames of each window over n poses: windows of ``window`` frames
    every ``window - overlap``, and one more ending at the last frame where
    the stride leaves frames out."""
    step = max(1, window - overlap)
    starts = list(range(0, max(1, n - window + 1), step))
    if starts and starts[-1] + window < n:
        starts.append(n - window)
    return [list(range(s, min(s + window, n))) for s in starts]


def build_window_problems(pipe, window: int = 8, overlap: int = 2, pin: int = 0,
                          obs_gate_px: float = 10.0, min_obs_per_pose: int = 12):
    """Slice a finished pipeline run (``pipe.R``, ``pipe.t``, ``pipe.K``,
    ``pipe.map``, ``pipe.tables``) into overlapping BA windows.

    ``pin`` — leading poses pinned per window: none for the alternate-mode
    solver (the map anchors each window's gauge), 2 for joint Schur (6-DOF
    gauge + monocular scale). Global frame 0 is always held.

    ``obs_gate_px`` — stale-binding gate: the historical tables are paired
    with the END-OF-RUN map, whose ring slots are recycled, so an early
    frame's landmark id can name another point by now. Observations whose
    residual against the frame's own pose exceeds the gate are dropped, and
    a pose left with fewer than ``min_obs_per_pose`` observations is held at
    its value (its chain edges then reproduce the run's relative motion).

    Returns (frame_ranges, tr list of (P, 6) float32, pose_free list of (P,)
    bool, obs list of (uv (O, 2) float32, pose (O,) int32, landmark (O,)
    int32), map_xyz (L, 3), L) as numpy. Per-frame quantities are computed on
    the map's device, once per frame.
    """
    ranges = window_ranges(len(pipe.t), window, overlap)
    dev = pipe.map.xyz.device
    map_xyz = pipe.map.xyz.cpu().numpy()
    map_alive = pipe.map.alive.cpu().numpy()
    K = _f32(pipe.K.cpu(), dev)

    frame: dict[int, tuple] = {}

    def of_frame(f):
        """(tr (6,), uv, landmark ids) of frame f's kept observations."""
        if f in frame:
            return frame[f]
        R, t = _f32(pipe.R[f], dev), _f32(pipe.t[f], dev)
        tr = geo.pose_to_ba_params(R, t).cpu().numpy()
        tbl = pipe.tables[f]
        xy = tbl.xy.cpu().numpy()
        lm = tbl.landmark.cpu().numpy()
        ok = tbl.valid.cpu().numpy() & (lm >= 0)
        ok[ok] &= map_alive[lm[ok]]
        if obs_gate_px > 0 and ok.any():
            pred = geo.project_points(_f32(map_xyz[lm[ok]], dev), R, t, K).cpu().numpy()
            keep = np.linalg.norm(pred - xy[ok], axis=1) < obs_gate_px
            ok[np.where(ok)[0][~keep]] = False
        frame[f] = (tr, xy[ok].astype(np.float32), lm[ok].astype(np.int32))
        return frame[f]

    tr_list, obs_list, free_list = [], [], []
    for frames in ranges:
        tr = np.zeros((window, 6), np.float32)
        free = np.zeros(window, bool)
        uv, pose, lms = [], [], []
        for i, f in enumerate(frames):
            tr[i], xy_f, lm_f = of_frame(f)
            free[i] = i >= pin and f != 0 and len(lm_f) >= min_obs_per_pose
            uv.append(xy_f)
            pose.append(np.full(len(lm_f), i, np.int32))
            lms.append(lm_f)
        tr_list.append(tr)
        free_list.append(free)
        obs_list.append((np.concatenate(uv), np.concatenate(pose), np.concatenate(lms)))
    return ranges, tr_list, free_list, obs_list, map_xyz, map_xyz.shape[0]


def _solve_windows(solver, batch: int, n_lm: int, tr_list, free_list, obs_list, map_xyz, L, K, dev):
    """Every window through ``solver`` (``dist_ba.make_distributed_ba``'s)
    on ``dev``, laid out as the JAX package lays them out: each window's
    observations partitioned by ``n_lm`` landmark shards and padded to one
    O_s, the map padded to a multiple of the shards, the windows in batches
    of ``batch`` (on a mesh its dp size; the last batch padded by repeats,
    whose duplicates are dropped). Returns tr (D, P, 6) on ``dev``."""
    D = len(tr_list)
    parts = [dist_ba.partition_obs_by_landmark(uv, pose, lm, np.ones(len(uv), bool), L, n_lm)
             for uv, pose, lm in obs_list]
    O_s = max(p[4] for p in parts)

    def repad(p):
        uv, pose, lml, msk, o_s, _ = p
        pad = ((0, 0), (0, O_s - o_s))
        return (np.pad(uv.reshape(n_lm, o_s, 2), pad + ((0, 0),)).reshape(-1, 2),
                *(np.pad(a.reshape(n_lm, o_s), pad).reshape(-1) for a in (pose, lml, msk)))

    lm_pad = np.zeros((parts[0][5] * n_lm, 3), np.float32)
    lm_pad[:L] = map_xyz

    def stack(arrays, dtype):
        return torch.from_numpy(np.stack(arrays)).to(dev, dtype)

    rows: list = [None] * D
    for b0 in range(0, D, batch):
        idx = list(range(b0, min(b0 + batch, D)))
        idx += idx[-1:] * (batch - len(idx))
        rep = [repad(parts[i]) for i in idx]
        tr_out, _, _, _ = solver(
            stack([tr_list[i] for i in idx], torch.float32),
            stack([lm_pad] * batch, torch.float32),
            stack([r[0] for r in rep], torch.float32), stack([r[1] for r in rep], torch.int32),
            stack([r[2] for r in rep], torch.int32), stack([r[3] for r in rep], torch.bool),
            stack([free_list[i] for i in idx], torch.bool), K,
        )
        for slot, i in enumerate(idx[: len(set(idx))]):
            if rows[i] is None:
                rows[i] = tr_out[slot]
    return torch.stack(rows)


def global_bundle_adjust(pipe, mesh=None, window: int = 8, overlap: int = 2, iters: int = 5,
                         mode: str = "alternate", device=None):
    """Refine the whole trajectory: windowed BA + pose-graph stitch. Returns
    (R_list, t_list), float64 numpy, and sets ``pipe.R`` / ``pipe.t`` to
    them.

    ``mesh=None`` runs the windows on ``device`` (``None``: the GPU, an
    error without one). With a mesh (``parallel.mesh.make_mesh``) they run
    on the mesh's device, windows over dp and landmark shards over lm; every
    rank calls this with the same ``pipe`` and returns the same trajectory.

    ``mode="alternate"`` (the default) alternates map-anchored pose steps
    with landmark steps: gauge-free per window, so a drifted trajectory is
    pulled back toward the map instead of the window fitting its own noise.
    """
    if mesh is None:
        dev = resolve_device(device)
    elif device is not None:
        raise ValueError("with a mesh the refinement runs on the mesh's device; pass device=None")
    else:
        dev = mesh.device
    ranges, tr_list, free_list, obs_list, map_xyz, L = build_window_problems(
        pipe, window, overlap, pin=0 if mode == "alternate" else 2
    )
    K = _f32(pipe.K.cpu(), dev)
    solver = dist_ba.make_distributed_ba(mesh, iters=iters, mode=mode)
    # One device: one landmark shard, all windows in one batch.
    batch, n_lm = (len(ranges), 1) if mesh is None else (mesh.shape["dp"], mesh.shape["lm"])
    tr_out = _solve_windows(solver, batch, n_lm, tr_list, free_list, obs_list, map_xyz, L, K, dev)
    R_w, t_w = geo.ba_params_to_pose(tr_out)
    R_w, t_w = R_w.cpu().numpy(), t_w.cpu().numpy()

    # Pose-graph stitch: edges from every window's consecutive pairs.
    E_idx, E_R, E_t = pose_graph.window_edges(
        ranges, [R_w[d][: len(r)] for d, r in enumerate(ranges)],
        [t_w[d][: len(r)] for d, r in enumerate(ranges)],
    )
    n = len(pipe.t)
    if len(E_idx) and (E_idx[:, 1] - E_idx[:, 0] == 1).all():
        R_out, t_out = pose_graph.stitch_chain(
            n, E_idx, E_R, E_t, np.asarray(pipe.R[0]), np.asarray(pipe.t[0])
        )
    else:
        anchored = torch.zeros(n, dtype=torch.bool, device=dev)
        anchored[0] = True
        R_t, t_t = pose_graph.optimize(
            torch.from_numpy(np.stack(pipe.R).astype(np.float64)).to(dev),
            torch.from_numpy(np.stack(pipe.t).astype(np.float64)).to(dev),
            torch.from_numpy(E_idx).to(dev),
            torch.from_numpy(E_R.astype(np.float64)).to(dev),
            torch.from_numpy(E_t.astype(np.float64)).to(dev),
            torch.ones(len(E_idx), dtype=torch.float64, device=dev),
            anchored, iters=10,
        )
        R_out, t_out = R_t.cpu().numpy(), t_t.cpu().numpy()
    pipe.R = [np.asarray(R_out[i]) for i in range(n)]
    pipe.t = [np.asarray(t_out[i]) for i in range(n)]
    return pipe.R, pipe.t
