"""Lucas-Kanade level kernels — wrappers of the CUDA kernels in
``csrc/lk.cu`` and their plain versions.

Replace the two TPU kernels of ``pmv_tpu/frontend/pallas_lk.py``
(``_level_call``): ``_make_template_kernel`` -> :func:`lk_template`,
``_make_iter_kernel`` -> :func:`lk_iterate`.

Bound on this card: bytes for both. ``lk_template`` reads only the
(win+3)^2 floats of each cached block that its bilinear taps touch (it does
not stage the block) and writes T/Ix/Iy; ``lk_iterate`` reads the region and
T/Ix/Iy once and writes two floats per feature — its ``iters`` iterations run entirely
out of shared memory. One thread block per feature; block reductions in a
fixed order, so results repeat run to run but differ from the plain
version's summation order (hence a tolerance, not bit equality).
"""

from __future__ import annotations

import torch

from pmv_tpu_torch import build
from pmv_tpu_torch.frontend import lucas_kanade as lk

Tensor = torch.Tensor

# Plain PyTorch versions, used for CPU tensors and as the yardsticks the
# kernels are held against on the card.
lk_template_plain = lk.template_stats
lk_iterate_plain = lk._iterate


def lk_template(blk: Tensor, raw_r: Tensor, raw_c: Tensor, win: int):
    """Template statistics of one level: blk (N, Rg, Rg) cached blocks,
    raw_r/raw_c (N,) float offsets of the (win+2)^2 window inside the block
    (clipped inside). Returns (T, Ix, Iy (N, win, win), stats (N, 5) =
    [Gxx, Gxy, Gyy, inv_det, min_eig])."""
    if blk.device.type == "cpu":
        return lk_template_plain(blk, raw_r, raw_c, win)
    dev = blk.device
    N, Rg, _ = blk.shape
    if Rg < win + 3:
        raise ValueError(f"lk_template: block {Rg} too small for window {win}")
    build.check(blk, "blk", torch.float32, (N, Rg, Rg), dev)
    build.check(raw_r, "raw_r", torch.float32, (N,), dev)
    build.check(raw_c, "raw_c", torch.float32, (N,), dev)
    T = torch.empty((N, win, win), dtype=torch.float32, device=dev)
    Ix = torch.empty_like(T)
    Iy = torch.empty_like(T)
    stats = torch.empty((N, 5), dtype=torch.float32, device=dev)
    build.launch(
        "pmv_lk_template", dev,
        blk.data_ptr(), raw_r.data_ptr(), raw_c.data_ptr(), N, Rg, win,
        lk.template_limit(Rg, win),
        T.data_ptr(), Ix.data_ptr(), Iy.data_ptr(), stats.data_ptr(),
    )
    lk_template.launches += 1
    return T, Ix, Iy, stats


def lk_iterate(region: Tensor, T: Tensor, Ix: Tensor, Iy: Tensor, stats: Tensor,
               guess_padded: Tensor, reg_r0: Tensor, reg_c0: Tensor,
               win: int, iters: int) -> Tensor:
    """``iters`` LK updates of ``guess_padded`` (N, 2) (u, v), padded-level
    coords) inside ``region`` (N, Rg, Rg) with origins reg_r0/reg_c0 (N,)
    int32. Returns the refined guess (N, 2)."""
    if region.device.type == "cpu":
        return lk_iterate_plain(
            region, reg_r0, reg_c0, T, Ix, Iy, stats, guess_padded, win, iters
        )
    dev = region.device
    N, Rg, _ = region.shape
    if Rg < win + 2:
        raise ValueError(f"lk_iterate: region {Rg} too small for window {win}")
    build.check(region, "region", torch.float32, (N, Rg, Rg), dev)
    for name, t in (("T", T), ("Ix", Ix), ("Iy", Iy)):
        build.check(t, name, torch.float32, (N, win, win), dev)
    build.check(stats, "stats", torch.float32, (N, 5), dev)
    build.check(guess_padded, "guess_padded", torch.float32, (N, 2), dev)
    build.check(reg_r0, "reg_r0", torch.int32, (N,), dev)
    build.check(reg_c0, "reg_c0", torch.int32, (N,), dev)
    out = torch.empty((N, 2), dtype=torch.float32, device=dev)
    build.launch(
        "pmv_lk_iterate", dev,
        region.data_ptr(), T.data_ptr(), Ix.data_ptr(), Iy.data_ptr(),
        stats.data_ptr(), guess_padded.data_ptr(), reg_r0.data_ptr(),
        reg_c0.data_ptr(), N, Rg, win, iters, lk.iterate_limit(Rg, win),
        out.data_ptr(),
    )
    lk_iterate.launches += 1
    return out


lk_template.launches = 0
lk_iterate.launches = 0
