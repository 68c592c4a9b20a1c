"""Precision of a reference computation: float64, or the TF32 control."""

from __future__ import annotations

from typing import NamedTuple

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties to even) at TF32's 10-bit
    mantissa; the exponent range is float32's, as TF32's is."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


class Prec(NamedTuple):
    name: str
    dtype: torch.dtype

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as this precision stores it."""
        x = x.to(self.dtype)
        return round_tf32(x) if self.name == "tf32" else x


F64 = Prec("float64", torch.float64)
TF32 = Prec("tf32", torch.float32)
