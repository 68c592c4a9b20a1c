"""The minimal sets a RANSAC of the configuration draws: a fixed batch of
hypotheses, each a uniform subset of the valid slots by the Gumbel-top-k
rule on float32 uniforms from the frame's generator."""

from __future__ import annotations

import torch


def draw(gen_state, valid, n_hypos: int, k: int):
    """The (n_hypos, k) minimal sets that a generator at ``gen_state`` draws,
    on ``valid``'s device."""
    gen = torch.Generator(device=valid.device)
    gen.set_state(gen_state)
    u = torch.rand((n_hypos, valid.shape[0]), generator=gen, device=valid.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log((-torch.log(u.clamp(min=tiny))).clamp(min=tiny))
    return torch.topk(torch.where(valid[None, :], g, -torch.inf), k, dim=1).indices
