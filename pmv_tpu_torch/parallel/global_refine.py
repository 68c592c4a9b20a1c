"""Global trajectory refinement: windowed BA + pose-graph stitching —
PyTorch counterpart of ``pmv_tpu/parallel/global_refine.py``, on one device.

A finished run's trajectory is cut into overlapping windows; every window is
bundle-adjusted against the end-of-run map (:mod:`.dist_ba`), and the
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


def global_bundle_adjust(pipe, mesh=None, window: int = 8, overlap: int = 2, iters: int = 5,
                         mode: str = "alternate", device=None):
    """Refine the whole trajectory: windowed BA on ``device`` (``None``: the
    GPU, an error without one) + pose-graph stitch. Returns (R_list,
    t_list), float64 numpy, and sets ``pipe.R`` / ``pipe.t`` to them.

    ``mode="alternate"`` (the default) alternates map-anchored pose steps
    with landmark steps: gauge-free per window, so a drifted trajectory is
    pulled back toward the map instead of the window fitting its own noise.
    ``mesh=None`` means one device; a mesh is ROADMAP Queue 1 item 5.
    """
    if mesh is not None:
        raise NotImplementedError(dist_ba.MESH_NOT_PORTED)
    dev = resolve_device(device)
    ranges, tr_list, free_list, obs_list, map_xyz, L = build_window_problems(
        pipe, window, overlap, pin=0 if mode == "alternate" else 2
    )
    D = len(ranges)
    # One landmark shard: the partition compacts each window's observations;
    # all windows are padded to the longest (padding is masked and inert).
    parts = [
        dist_ba.partition_obs_by_landmark(uv, pose, lm, np.ones(len(uv), bool), L, 1)
        for uv, pose, lm in obs_list
    ]
    O = max(p[4] for p in parts)

    def stack(i, dtype):
        rows = [np.pad(p[i], [(0, O - len(p[i]))] + [(0, 0)] * (p[i].ndim - 1)) for p in parts]
        return torch.from_numpy(np.stack(rows)).to(dev, dtype)

    solver = dist_ba.make_distributed_ba(None, iters=iters, mode=mode)
    tr_out, _, _, _ = solver(
        torch.from_numpy(np.stack(tr_list)).to(dev),
        torch.from_numpy(map_xyz).to(dev, torch.float32).expand(D, L, 3),
        stack(0, torch.float32), stack(1, torch.int32), stack(2, torch.int32),
        stack(3, torch.bool),
        torch.from_numpy(np.stack(free_list)).to(dev),
        _f32(pipe.K.cpu(), dev),
    )
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
