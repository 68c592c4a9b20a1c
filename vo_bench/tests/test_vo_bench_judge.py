"""The comparison of the bootstrap's essential matrix (``essential_support``)
on seeded two-view scenes at the cells' size (512 slots, 300 valid, 1 m of
forward motion at KITTI 07's intrinsics, 0.3 px of noise, a tenth of the
matches wrong): the reference's replay of the generator's draw, the limit of
the cells against the program, the TF32 control and an essential matrix
altered where it is made. The tiny cell's 49-85 correspondences are too few
for this number (tests/conftest.py)."""

from __future__ import annotations

import json

import pytest
import torch

from vo_bench import cells, judge
from vo_bench.reference import geometry as geo
from vo_bench.reference.ransac import draw

KITTI_K = torch.tensor([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]],
                       dtype=torch.float64)
LIMIT = json.loads((cells.HERE / "workloads" / "kitti07_ba5x5.corridor118.json").read_text())[
    "limits"]["essential_support"]


def two_views(seed: int, n: int = 512, n_valid: int = 300):
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi: torch.rand(n, generator=g, dtype=torch.float64) * (hi - lo) + lo  # noqa: E731
    X = torch.stack([u(-10, 10), u(-3, 3), u(5, 35)], -1)
    R = geo.rodrigues(torch.tensor([0.0, 0.004, 0.0], dtype=torch.float64))
    t = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64)

    def pixels(Xc):
        return torch.stack([Xc[:, 0] / Xc[:, 2] * KITTI_K[0, 0] + KITTI_K[0, 2],
                            Xc[:, 1] / Xc[:, 2] * KITTI_K[1, 1] + KITTI_K[1, 2]], -1)

    p1 = pixels(X) + 0.3 * torch.randn(n, 2, generator=g, dtype=torch.float64)
    p2 = pixels(X @ R.T + t) + 0.3 * torch.randn(n, 2, generator=g, dtype=torch.float64)
    wrong = torch.rand(n, generator=g) < 0.1
    p2[wrong] += 20.0 * torch.randn(int(wrong.sum()), 2, generator=g, dtype=torch.float64)
    valid = torch.zeros(n, dtype=torch.bool)
    valid[torch.randperm(n, generator=g)[:n_valid]] = True
    return p1.float(), p2.float(), valid


def recorded_call(seed: int, solve=None):
    """One recorded call of the program's five-point RANSAC, as the
    recorder keeps it."""
    from pmv_tpu_torch.solvers.five_point import find_essential_5pt_ransac

    p1, p2, valid = two_views(seed)
    gen = torch.Generator().manual_seed(seed + 1000)
    state = gen.get_state()
    E, inl = (solve or find_essential_5pt_ransac)(p1, p2, valid, KITTI_K.float(), gen, n_hypos=64,
                                                  thresh_px=1.0)
    args = {"p1": p1, "p2": p2, "valid": valid, "K": KITTI_K.float(), "n_hypos": 64,
            "thresh_px": 1.0, "gen_state": state}
    return {"n": 0, "args": args, "out": (E, inl)}


def test_the_reference_draws_the_programs_minimal_sets():
    from pmv_tpu_torch.solvers.ransac import sample_minimal_sets

    _, _, valid = two_views(1)
    state = torch.Generator().manual_seed(5).get_state()
    assert torch.equal(draw(state, valid, 64, 5),
                       sample_minimal_sets(torch.Generator().set_state(state), valid, 64, 5))


def test_the_reference_five_point_solver_finds_the_true_essential_matrix():
    from vo_bench.reference import F64, five_point

    g = torch.Generator().manual_seed(0)
    H = 32
    R = geo.rodrigues(0.2 * torch.randn(H, 3, generator=g, dtype=torch.float64))
    t = torch.nn.functional.normalize(torch.randn(H, 3, generator=g, dtype=torch.float64), dim=-1)
    X = torch.randn(H, 5, 3, generator=g, dtype=torch.float64) + torch.tensor([0.0, 0.0, 6.0],
                                                                               dtype=torch.float64)
    X2 = X @ R.transpose(-1, -2) + t[:, None]
    E, ok = five_point.solve(X[..., :2] / X[..., 2:], X2[..., :2] / X2[..., 2:], F64)
    true = geo.hat(t) @ R
    true = true / torch.linalg.norm(true.reshape(H, 9), dim=-1)[:, None, None]
    gap = torch.minimum(torch.linalg.norm((E - true[:, None]).reshape(H, 10, 9), dim=-1),
                        torch.linalg.norm((E + true[:, None]).reshape(H, 10, 9), dim=-1))
    assert torch.where(ok, gap, torch.inf).amin(dim=1).max() < 1e-9


def essential_support(recs, control: bool = False) -> float:
    """The number as :func:`vo_bench.judge.judge` takes it over all calls."""
    return judge.judge({"essential": recs}, None, {"essential": len(recs)}, 0, control=control)[
        "essential_support"]


@pytest.mark.parametrize("seeds", [range(0, 16), range(16, 32)], ids=["scenes_0-15", "scenes_16-31"])
def test_the_essential_support_passes_the_program_and_fails_the_control(seeds):
    recs = [recorded_call(s) for s in seeds]
    assert essential_support(recs) <= LIMIT
    assert essential_support(recs, control=True) > LIMIT


def _altered(solve):
    def altered(*a, **k):
        E, inl = solve(*a, **k)
        turn = geo.rodrigues(torch.tensor([0.0, 0.0, 0.01], dtype=E.dtype))
        return turn @ E, inl
    return altered


def test_an_essential_matrix_altered_where_made_is_not_correct():
    from pmv_tpu_torch.solvers.five_point import find_essential_5pt_ransac

    assert essential_support([recorded_call(s, _altered(find_essential_5pt_ransac)) for s in range(4)]) > LIMIT
