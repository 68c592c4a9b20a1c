"""How far an lm-sharded solve lands from the one-device one: the yardstick
of chip_smoke.py's bar for the refinement on a (2, 2) mesh against one
device (``MESH_REFINE_BAR``), and of tests/test_torch_mesh.py's float32 bars
for the sharded solver.

    JAX_PLATFORMS=cpu python3 scripts/torch_mesh_gap.py [--seeds 5 6 7]
    python3 scripts/torch_mesh_gap.py --card [--frames 45]

On the CPU, first the sharded solver on tests/test_torch_mesh.py's two
windows (its ``make_windows``) in float32, 6 iterations, each mode: the
largest pose difference, landmark relative difference and cost relative
difference between (2, 2) and one device, in ``pmv_tpu`` and in the port.
Then, for each data seed, tests/test_torch_mesh.py's scene (its
``make_finished``: the port's ``run()`` on 20 frames of 96x160, as it is
and with tests/test_parallel_flow.py's drift) refined (window 8, overlap 4,
8 iterations, float32 windows) by ``pmv_tpu`` on a (1, 1) and a (2, 2)
virtual CPU mesh and by the port with ``mesh=None`` and on a (2, 2) mesh of
4 gloo ranks (``parallel.mesh.launch``). Only the order of the sums differs
between a sharded and a one-device solve. JAX runs as the tests run it:
64-bit enabled.

With ``--card``, on one GPU: chip_smoke.py's main run (its ``phase_main``,
``--frames`` frames of the 370x1226 corridor), first as its ``refine``
phase takes it (drifted, refined on the card and on the CPU): the card's
refinement against the CPU's, against itself with the drifted poses scaled
by 1 + e (e = +-1e-6, ..., +-4e-6), and with each fault of ``ONE_FAULTS``
against the sound one; with ``--save DIR`` the run is written to
``DIR/main_run.npz`` for ``--reference``. Then as its ``mesh`` phase takes
it (``MainRun``: clean and drifted, the map slots spread over the landmark
shards, refined on one device on the card), then refined on a (2, 2) mesh
of 4 gloo ranks sharing the card, as that phase refines it: once sound, and
once with each sharding fault of ``FAULTS`` planted in the ranks by
wrapping ``torch.distributed.all_reduce`` (the code under test is not
changed). With ``--unspread`` the map slots stay as the run left them.
Each line gives the largest difference of R and t from the one-device
result, whether the 4 ranks agree bit for bit, and the rebased ATE before
and after.

With ``--reference DIR`` (CPU, JAX): ``pmv_tpu``'s one-device refinement of
that saved run, drifted, against itself with the poses scaled as above,
and the port's refinement on the CPU against it.

Prints one JSON line per measurement (on the card, with the card's name and
power limit from ``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pmv_tpu_torch import convert  # noqa: E402
from pmv_tpu_torch.parallel import dist_ba, global_refine, mesh  # noqa: E402

REFINE = dict(window=8, overlap=4, iters=8)

# Sharding faults planted on the card (see ``plant``):
# cost_unreduced — the cost's all-reduce skipped: each rank accepts on its
#   own shard's cost;
# blocks_unreduced — the pose step's (U, b_pose) all-reduce skipped: each
#   rank steps on its own shard's blocks;
# shard_lost — that all-reduce replaced by a broadcast from the group's
#   first rank: every rank steps on shard 0's blocks alone, so the ranks
#   agree and half the landmarks are lost.
FAULTS = ("cost_unreduced", "blocks_unreduced", "shard_lost")
# Faults of the one-device refinement, the settings it is run with changed:
# one and two LM iterations fewer.
ONE_FAULTS = {"one_iteration_fewer": dict(iters=7), "two_iterations_fewer": dict(iters=6)}
# The scalings of the drifted poses that measure a refinement's sensitivity
SCALES = [(-1) ** j * (j // 2 + 1) * 1e-6 for j in range(8)]


def gap(a, b) -> float:
    """The largest difference of R or t between two (R, t) pairs."""
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def scaled(run: dict, e: float) -> dict:
    return dict(run, t=(run["t"] * (1 + e)).astype(run["t"].dtype))


def port_rank(rank: int, run: dict):
    """One rank of the port's (2, 2) refinement on the CPU."""
    m = mesh.make_mesh(2, 2, device_type="cpu")
    R, t = global_refine.global_bundle_adjust(convert.run_from_reference(run, "cpu"), m, **REFINE)
    return np.stack(R), np.stack(t)


def ba_rank(rank: int, args: list, mode: str):
    """One rank of the port's (2, 2) solve of the two windows."""
    m = mesh.make_mesh(2, 2, device_type="cpu")
    out = dist_ba.make_distributed_ba(m, iters=6, mode=mode)(*[torch.from_numpy(a) for a in args])
    return [x.numpy() for x in out]


def plant(fault: str | None) -> None:
    """Wrap ``torch.distributed.all_reduce`` in this rank so that it commits
    ``fault`` (one of ``FAULTS``; None plants nothing). The refinement's
    all-reduces are the cost (a 0-d tensor) and the pose step's blocks (one
    flat buffer, ``schur_lm.all_reduce_sum``)."""
    if fault is None:
        return
    real = dist.all_reduce

    def faulty(t, *args, group=None, **kw):
        if fault == "cost_unreduced" and t.dim() == 0:
            return None
        if fault == "blocks_unreduced" and t.dim() == 1:
            return None
        if fault == "shard_lost" and t.dim() == 1:
            return dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return real(t, *args, group=group, **kw)

    dist.all_reduce = faulty


def card_rank(rank: int, tmp: str, refine: dict, refine_lm: int, fault: str | None) -> dict:
    """One rank of a (2, 2) refinement on the card with ``fault`` planted:
    main's run clean and drifted; returns (R, t) by form."""
    plant(fault)
    m = mesh.make_mesh(2, refine_lm)
    out = {}
    for form in ("clean", "drifted"):
        with np.load(Path(tmp) / f"run_{form}.npz") as z:
            run = convert.run_from_reference(dict(z), m.device)
        R, t = global_refine.global_bundle_adjust(run, m, **refine)
        out[form] = (np.stack(R), np.stack(t))
    return out


def one_device(smi: str, frames: int, run: dict) -> None:
    """chip_smoke.py's ``refine`` phase's comparison on the drifted main run:
    the card against the CPU, the card's sensitivity, its planted faults."""
    def refine(r, dev, **kw):
        R, t = global_refine.global_bundle_adjust(convert.run_from_reference(r, dev), None, device=dev,
                                                  **{**REFINE, **kw})
        return np.stack(R), np.stack(t)

    card = refine(run, "cuda")
    row = {"card": smi, "frames": frames, "form": "drifted", "refine": "one device"}
    print(json.dumps({**row, "sound": "card_vs_cpu", "max_abs": gap(card, refine(run, "cpu"))}), flush=True)
    for e in SCALES:
        print(json.dumps({**row, "sound": f"card_vs_card_poses_scaled_{e:+.0e}",
                          "max_abs": gap(card, refine(scaled(run, e), "cuda"))}), flush=True)
    for fault, kw in ONE_FAULTS.items():
        print(json.dumps({**row, "fault": fault, "max_abs_vs_sound": gap(card, refine(run, "cuda", **kw))}),
              flush=True)


def drifted_run(pipe) -> dict:
    """``pipe``'s run as numpy with chip_smoke.py's drift, as its ``refine``
    phase drifts it (the map slots as the run left them)."""
    import chip_smoke as smoke

    run = convert.run_to_numpy(pipe)
    holder = type("Run", (), {})()
    holder.R, holder.t = list(run["R"]), list(run["t"])
    smoke.inject_drift(holder)
    return dict(run, R=np.stack(holder.R), t=np.stack(holder.t))


def card(frames: int, spread: bool, save: str | None) -> int:
    """The card's refinement of chip_smoke.py's main run against the CPU's,
    its sensitivity and faults; then the sound and the faulty (2, 2)
    refinements of that run against its one-device refinement, on the card."""
    import chip_smoke as smoke  # exits without a card

    from pmv_tpu_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.library()
    with torch.no_grad(), tempfile.TemporaryDirectory(prefix="pmv_gap_") as tmp:
        paths = smoke.write_corridor(tmp, frames)
        _, pipe = smoke.phase_main(paths, tmp, frames, 0.0)
        if save:
            Path(save).mkdir(parents=True, exist_ok=True)
            np.savez(Path(save) / "main_run.npz", **convert.run_to_numpy(pipe))
        one_device(smi, frames, drifted_run(pipe))
        if not spread:
            smoke.spread_landmarks = lambda run, n: run
        main = smoke.MainRun(pipe)
        del pipe
        by_shard = smoke.table_entries_by_shard(main.runs["clean"], smoke.MESH_LM)
        for form, run in main.runs.items():
            np.savez(Path(tmp) / f"run_{form}.npz", **run)
        for fault in (None,) + FAULTS:
            ranks = mesh.launch(card_rank, 4, backend="gloo", device_type="cuda",
                                args=(tmp, smoke.REFINE, smoke.MESH_LM, fault),
                                timeout=smoke.MESH_TIMEOUT)
            for form, (R1, t1) in main.card.items():
                R, t = ranks[0][form]
                print(json.dumps({
                    "card": smi, "frames": frames, "mesh": [2, smoke.MESH_LM], "backend": "gloo",
                    "spread": spread, "table_entries_by_lm_shard": by_shard, "fault": fault, "form": form,
                    "max_abs_vs_one_device": max(float(np.abs(R - R1).max()), float(np.abs(t - t1).max())),
                    "ranks_bit_equal": all(np.array_equal(r[form][0], R) and np.array_equal(r[form][1], t)
                                           for r in ranks),
                    "ate_m": [main.ate(main.runs[form]["t"]), main.ate(t)],
                    "ate_one_device_m": main.ate(t1),
                }), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 6, 7], help="data seeds (CPU)")
    ap.add_argument("--card", action="store_true", help="the sound and faulty refinements on a GPU")
    ap.add_argument("--frames", type=int, default=45, help="frames of the main run (--card)")
    ap.add_argument("--unspread", action="store_true", help="keep the run's map slots (--card)")
    ap.add_argument("--save", help="write the main run here (--card)")
    ap.add_argument("--reference", help="a directory --save wrote: pmv_tpu's refinement of its run (CPU)")
    args = ap.parse_args()
    if args.card:
        return card(args.frames, not args.unspread, args.save)
    torch.set_num_threads(1)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4").strip()
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pmv_tpu.core.state import FeatureTable, MapState
    from pmv_tpu.parallel import global_refine as j_refine
    from pmv_tpu.parallel import mesh as j_mesh

    def jax_refine(run: dict, dp: int, lm: int):
        n = run["t"].shape[0]
        pipe = type("Run", (), {})()
        pipe.R, pipe.t, pipe.K = list(run["R"]), list(run["t"]), jnp.asarray(run["K"])
        pipe.map = MapState(*(jnp.asarray(run[f"map.{f}"]) for f in ("xyz", "alive", "head")))
        pipe.tables = [FeatureTable(*(jnp.asarray(run[f"tables.{f}"][i])
                                      for f in ("xy", "valid", "landmark", "score"))) for i in range(n)]
        m = j_mesh.make_mesh(dp=dp, lm=lm, devices=jax.devices()[: dp * lm])
        R, t = j_refine.global_bundle_adjust(pipe, m, **REFINE)
        return np.stack(R), np.stack(t)

    if args.reference:
        with np.load(Path(args.reference) / "main_run.npz") as z:
            clean = dict(z)
        holder = type("Run", (), {})()
        holder.R, holder.t = list(clean["R"]), list(clean["t"])
        sys.path.insert(0, str(ROOT / "tests"))
        from test_parallel_flow import TestGlobalRefine  # chip_smoke.inject_drift's drift

        TestGlobalRefine._inject_drift(holder)
        run = dict(clean, R=np.stack(holder.R), t=np.stack(holder.t))
        ref = jax_refine(run, 1, 1)
        R, t = global_refine.global_bundle_adjust(convert.run_from_reference(run, "cpu"), None,
                                                  device="cpu", **REFINE)
        row = {"run": args.reference, "form": "drifted"}
        print(json.dumps({**row, "port_cpu_vs_jax_1x1": gap((np.stack(R), np.stack(t)), ref)}), flush=True)
        for e in SCALES:
            print(json.dumps({**row, "sound": f"jax_vs_jax_poses_scaled_{e:+.0e}",
                              "max_abs": gap(jax_refine(scaled(run, e), 1, 1), ref)}), flush=True)
        return 0

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_mesh import make_finished, make_windows

    from pmv_tpu.parallel import dist_ba as j_dist_ba

    # tests/test_torch_mesh.py's two windows, in float32
    def f32(args):
        return [a.astype(np.float32) if a.dtype == np.float64 else a for a in args]

    built = make_windows()
    windows = {1: f32(built["f64_one_shard"]), 2: f32(built["f64"])}

    def ba_gap(sharded, single) -> dict:
        L = single[1].shape[1]
        return {"tr_max_abs": float(np.abs(sharded[0] - single[0]).max()),
                "lm_max_rel": float((np.abs(sharded[1][:, :L] - single[1]) / np.abs(single[1])).max()),
                "cost_max_rel": float((np.abs(sharded[3] - single[3]) / np.abs(single[3])).max())}

    for mode in ("schur", "alternate"):
        jax_gap = ba_gap(*[[np.asarray(x) for x in j_dist_ba.make_distributed_ba(
            j_mesh.make_mesh(dp=dp, lm=dp, devices=jax.devices()[: dp * dp]), iters=6, mode=mode)(
            *map(jnp.asarray, windows[dp]))] for dp in (2, 1)])
        one = [x.numpy() for x in dist_ba.make_distributed_ba(None, iters=6, mode=mode)(
            *[torch.from_numpy(a) for a in windows[1]])]
        port_gap = ba_gap(mesh.launch(ba_rank, 4, device_type="cpu", args=(windows[2], mode))[0], one)
        print(json.dumps({"solver": "dist_ba", "mode": mode, "dtype": "float32",
                          "jax_2x2_vs_1x1": jax_gap, "port_2x2_vs_none": port_gap}), flush=True)

    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="pmv_gap_") as tmp:
            scene = make_finished(tmp, seed)
        for form in ("clean", "drifted"):
            run = scene[form]
            j11, j22 = jax_refine(run, 1, 1), jax_refine(run, 2, 2)
            R, t = global_refine.global_bundle_adjust(convert.run_from_reference(run, "cpu"), None,
                                                      device="cpu", **REFINE)
            p1 = (np.stack(R), np.stack(t))
            p22 = mesh.launch(port_rank, 4, device_type="cpu", args=(run,))[0]
            print(json.dumps({
                "seed": seed, "form": form, "poses": int(run["t"].shape[0]),
                "jax_2x2_vs_1x1": gap(j22, j11), "port_2x2_vs_none": gap(p22, p1),
                "port_none_vs_jax_1x1": gap(p1, j11), "port_2x2_vs_jax_2x2": gap(p22, j22),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
