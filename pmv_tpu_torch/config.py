"""Configuration: reference-compatible INI parsing + typed config.

The reference parses a flat INI subset in its constructor
(OdometryPipeline.cpp:39-64): lines are trimmed, ``#``/``;``/``[section]``
lines skipped, ``key = value`` split on the first ``=``, all sections flattened
into one dict. :func:`parse_ini` reproduces that exactly, so reference config
files (README.md:21-45) are drop-in usable.

:class:`VOConfig` carries the reference's keys (same names, same required-ness:
``map_scale`` is required by the reference even though its README omits it)
plus the knobs that replace hard-coded module constants
(LK window 32 / 4 levels, include/OpenCVLucasKanadeFM.h:9-10; grid 255x255,
include/OdometryPipeline.h:31; RANSAC budgets, OpenCVEPnPSolver.cpp:35-36 and
OpenCVFivePointTri.cpp:24).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


class OdometryPipelineException(Exception):
    """Config/IO failure — mirrors the reference exception of the same name
    (include/OdometryPipeline.h, caught in main.cpp:25-29)."""


def parse_ini(path: str | Path) -> dict[str, str]:
    """Parse the reference's INI subset into a flat dict
    (OdometryPipeline.cpp:39-49 semantics)."""
    p = Path(path)
    if not p.is_file():
        raise OdometryPipelineException("Unable to open configuration file")
    cfg: dict[str, str] = {}
    for raw in p.read_text().splitlines():
        line = raw.strip()
        if not line or line[0] in "#;[":
            continue
        div = line.find("=")
        name = line[:div].strip()
        value = line[div + 1 :].strip()
        cfg[name] = value
    return cfg


@dataclasses.dataclass
class VOConfig:
    # --- reference keys (OdometryPipeline.cpp:50-64) ---
    fancy_video: int = 0
    verbose: int = 0
    min_tracked_features: int = 400
    tracked_features_tol: int = 150
    init_frames: int = 5
    frames: int = 600  # "stop" in the reference
    bundle_size: int = 5
    max_iterations: int = 5  # BA iterations ("ceres.max_iterations")
    video_path: str = ""
    map_scale: float = 1.0
    error_path: str = ""
    image_dir: str = ""
    camera: int = 0
    camera_calibration: str = ""
    poses: str = ""

    # --- knobs replacing reference hard-coded constants ---
    feature_capacity: int = 512    # N_max feature slots per frame
    map_capacity: int = 8192       # M_max landmark slots (ring buffer).
    # BA cost scales with this (landmark blocks are dense over the table);
    # ~2-5k landmarks are live at any time on KITTI-scale runs
    grid_rows: int = 255           # getGridROI tile size (OdometryPipeline.h:31)
    grid_cols: int = 255
    lk_window: int = 21            # LK window (reference uses 32,
    # OpenCVLucasKanadeFM.h:9; 21 tracks measurably better on KITTI-scale
    # scenes and is cheaper — set 32 for strict parity)
    lk_levels: int = 4             # LK pyramid levels (OpenCVLucasKanadeFM.h:10)
    lk_iters: int = 10             # LK iterations per level
    lk_search: int = 0             # search radius around the per-level guess;
    # 0 = max(4, lk_window // 2). With pyramid guess propagation a small
    # radius loses nothing and shrinks every LK block load and sampling matmul
    ba_cadence: int = 0            # frames between BA windows; 0 = reference
    # cadence bundle_size//3*2 (OdometryPipeline.cpp:407)
    min_distance: int = 5          # corner min-distance (OpenCVGoodFeatureExtractor.h)
    quality_level: float = 0.01    # corner quality (OpenCVGoodFeatureExtractor.h)
    ransac_e_hypos: int = 256      # essential-matrix RANSAC hypotheses
    ransac_e_thresh: float = 1.0   # E-matrix inlier threshold, px (FivePointTri :24)
    ransac_pnp_hypos: int = 128    # PnP RANSAC hypotheses (ref: 100 iters)
    ransac_pnp_thresh: float = 3.0  # PnP reprojection threshold, px. The
    # reference uses 8 px (OpenCVEPnPSolver.cpp:36); 3 px roughly halves the
    # trajectory drift in our sweeps — set 8 for strict parity
    ba_obs_gate_px: float = 0.0    # drop BA observations whose initial
    # reprojection residual exceeds this (px); 0 = off (reference parity).
    # Recommended ~4 px on scenes with moving objects/occlusions
    ba_window_obs: int = 4096      # max observations per BA window
    ba_lm_cap: int = 0             # max unique landmarks per fused-path BA
    # window (0 = bundle_size x feature_capacity — the true maximum, so no
    # observation is ever dropped). Lowering it shrinks the BA tensors but
    # risks a biased window when it saturates (the fused loop warns; see
    # pipeline/fused.StepConfig.ba_lm_cap)
    cont_tri: int = 0              # 1 = continuous triangulation: on PnP
    # frames, midpoint-triangulate tracked-but-unbound feature slots from
    # the accepted relative pose and insert them into the map
    # (pipeline/steps.continuous_triangulate). Keeps count3DPoints dense so
    # the five-point bootstrap branch becomes cold-start-only (it otherwise
    # re-fires every 6-18 frames). The
    # reference has no counterpart (landmarks are only born in the bootstrap
    # branch, OpenCVFivePointTri.cpp:36-53) — keep 0 for strict parity
    cont_tri_reproj_px: float = 2.0  # accept gate: reprojection error in
    # BOTH frames under this (px)
    cont_tri_max_depth: float = 120.0  # accept gate: camera-frame depth band
    cont_tri_min_depth: float = 1.0
    chunk_frames: int = 8          # frames per host->device image upload
    traj_cap: int = 2048           # device trajectory-history capacity. Runs
    # with frames + 2 > traj_cap fail loudly at startup; raise it explicitly
    # for longer sequences
    checkpoint_path: str = ""      # fused-state snapshot file ("" = off).
    # The reference persists nothing (SURVEY.md section 5); production runs
    # checkpoint the device-resident StepState for mid-sequence resume
    checkpoint_every: int = 0      # frames between snapshots (0 = off)
    resume: int = 0                # 1 = resume run() from checkpoint_path
    reseed_tol: int = 300          # reseed when tracked features fall below
    # this (0 = tracked_features_tol, the reference's coupled threshold,
    # OdometryPipeline.cpp:342 — set 0 for strict parity). The tuned default
    # 300 keeps the pool dense and the essential/PnP geometry
    # well-conditioned without changing the PnP-vs-triangulation branch
    # point: on the 600-frame bench it removed every seed-dependent heading
    # divergence (ATE 280-540 m -> 9-15 m; PERFORMANCE.md round 2)
    map_hist: int = 1              # 1 = snapshot landmark positions at BA
    # cadence on device so the video replay draws frame k's dots at their
    # THEN-current coordinates like the reference's drawMap
    # (OdometryPipeline.cpp:110-127); 0 = off. The rows are allocated on
    # the device (pipeline/fused.py, pipeline/odometry.py) and read back by
    # the video replay (viz/render.py) only when a video is asked for
    live_every: int = 0            # write a live trajectory map
    # (map_live.png next to error_path) every N processed frames during the
    # run — the headless analogue of the reference's during-run cv::imshow
    # map (OdometryPipeline.cpp:423-425). 0 = off
    lk_impl: str = "auto"          # LK tracker backend. The name is kept
    # from the JAX package; in this port every value means the same thing:
    # the hand-written CUDA kernels for CUDA tensors, the plain PyTorch
    # version for CPU tensors
    extractor: str = "good"        # good | shi_tomasi | fast
    essential_solver: str = "five_point"  # five_point (Nister, ref default) | eight_point
    matcher: str = "lk"            # lk | knn
    dtype: str = "float32"
    seed: int = 0

    def extractor_preset(self) -> dict:
        """Per-extractor response/quality defaults, mirroring the reference
        module constants: goodFeaturesToTrack quality .01 / min-dist 5
        (include/OpenCVGoodFeatureExtractor.h:9-11), Shi-Tomasi quality .4,
        no spreading (include/ShiTomasiFeatureExtractor.h:10), FAST threshold
        10 with 3x3 non-max (include/OpenCVFASTFeatureExtractor.h:10-11)."""
        if self.extractor == "shi_tomasi":
            return {"response": "min_eig", "quality": 0.4, "min_distance": 1}
        if self.extractor == "fast":
            return {"response": "fast", "quality": 0.0, "min_distance": 1}
        return {
            "response": "min_eig",
            "quality": self.quality_level,
            "min_distance": self.min_distance,
        }

    @classmethod
    def from_ini(cls, path: str | Path) -> "VOConfig":
        cfg = parse_ini(path)
        kwargs = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in cfg.items():
            if key not in fields:
                continue  # unknown keys are ignored, like the reference's map
            typ = fields[key].type
            if typ == "int":
                kwargs[key] = int(value)
            elif typ == "float":
                kwargs[key] = float(value)
            else:
                kwargs[key] = value
        # Required keys: the reference std::stoi/stod on missing keys throws.
        for required in ("map_scale",):
            if required not in cfg and required not in kwargs:
                raise OdometryPipelineException(
                    f"Missing required config key: {required}"
                )
        return cls(**kwargs)
