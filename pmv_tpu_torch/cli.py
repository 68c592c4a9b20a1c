"""Command-line entry point — counterpart of the reference binary
``OdometryPipeline <config-file>`` (main.cpp:5-31).

Usage:
    python -m pmv_tpu_torch.cli run <config.ini> [--device cuda|cpu]
    python -m pmv_tpu_torch.cli synth <out_dir> [--frames N]   # synthetic dataset

``run`` uses the GPU and fails when there is none; ``--device cpu`` asks for
the CPU explicitly. Config failures raise OdometryPipelineException and exit
with a message, like main.cpp:25-29.
"""

from __future__ import annotations

import argparse
import sys


def rebased_ate(pipe) -> float | None:
    """ATE RMSE after re-basing both trajectories at the init frame (the
    error file keeps the reference's un-rebased metric for parity)."""
    import numpy as np

    t_est = np.stack(pipe.t)
    gt = pipe.gt_t.copy()
    gt[:, 2] *= -1
    off = pipe.init_offset
    n = min(len(t_est), len(gt) - off)
    if n <= 1:
        return None
    rel = (t_est[1:n] - t_est[0]) - (gt[off + 1 : off + n] - gt[off])
    return float(np.sqrt(np.mean(np.sum(rel**2, axis=1))))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="vo-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run the odometry pipeline on a config")
    run_p.add_argument("config")
    run_p.add_argument("--device", default=None,
                       help="torch device; default: cuda (an error without a GPU)")

    synth_p = sub.add_parser("synth", help="generate a synthetic KITTI-layout dataset")
    synth_p.add_argument("out_dir")
    synth_p.add_argument("--frames", type=int, default=60)
    synth_p.add_argument("--height", type=int, default=192)
    synth_p.add_argument("--width", type=int, default=640)
    synth_p.add_argument("--density", type=float, default=60.0)
    synth_p.add_argument("--seed", type=int, default=0)

    args = ap.parse_args(argv)

    if args.cmd == "synth":
        from pmv_tpu_torch.io import synthetic

        seq = synthetic.make_sequence(
            n_frames=args.frames,
            shape=(args.height, args.width),
            density=args.density,
            seed=args.seed,
        )
        paths = synthetic.write_kitti_layout(seq, args.out_dir)
        print("\n".join(f"{k} = {v}" for k, v in paths.items()))
        return 0

    from pmv_tpu_torch.config import OdometryPipelineException
    from pmv_tpu_torch.pipeline.odometry import OdometryPipeline

    try:
        pipe = OdometryPipeline(args.config, device=args.device)
    except OdometryPipelineException as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    result = pipe.run()
    ate = rebased_ate(pipe)
    if ate is not None:
        print(f"ATE RMSE (rebased): {ate:.3f} m")
    print(
        f"Processed {result['frames']} poses in {result['runtime']:.2f}s "
        f"({result['frames'] / max(result['runtime'], 1e-9):.1f} fps) on "
        f"{pipe.device} | t total {result['t_total']:.1f} | "
        f"R total {result['R_total']:.3f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
