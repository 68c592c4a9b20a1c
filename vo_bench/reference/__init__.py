"""The plain reference that decides ``correct``: float64 PyTorch, written
for this benchmark (frozen copies of the algorithms the port states, with
no import of the port, of the JAX package or of JAX).

Each module recomputes one stage of a frame from that stage's inputs.
:class:`Prec` selects how: ``F64`` is the reference; ``TF32`` is the
control, the same computation in float32 with every stored value (inputs,
each iteration's state, outputs) rounded to TF32's 10-bit mantissa.
"""

from vo_bench.reference.prec import F64, TF32, Prec

__all__ = ["F64", "TF32", "Prec"]
