"""pmv_tpu_torch — PyTorch / CUDA port of the pmv_tpu monocular visual
odometry framework, written for an NVIDIA Hopper card.

Same sub-package and module names as ``pmv_tpu`` (the JAX reference), so the
counterpart of a module is found by its path. The package imports ``torch``
only; it shares no code with ``pmv_tpu``.

Numerics policy, set once here: float32 throughout, and every float32 matrix
product and convolution runs in full float32 (TF32 off) — the counterpart of
the ``precision=HIGHEST`` pins of the JAX package. Subpixel tracking and the
3x3 pose algebra lose visible accuracy at TF32's ~3 decimal digits.

Device policy: entry points resolve ``device=None`` to ``cuda`` and raise
when there is no CUDA device; the CPU is used only when the caller asks for
it. Kernel wrappers launch their hand-written CUDA kernel for a CUDA tensor
(or raise) and take their plain PyTorch version only for a CPU tensor.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU, and a missing GPU is an error — never a silent
    CPU run. Pass ``"cpu"`` explicitly to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pmv_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (CLI: --device cpu) to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
