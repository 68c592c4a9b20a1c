"""Build and load the hand-written CUDA kernels.

The sources in ``pmv_tpu_torch/csrc/*.cu`` have a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds. At first use every
source is compiled for ``sm_90a`` — one ``nvcc`` per source, all started
together — and the objects are linked into one shared library under
``pmv_tpu_torch/_build/<hash>/``, where ``<hash>`` covers the sources'
contents and the flags: an edited source gets a fresh build. The library is
loaded with ``ctypes`` with every ``argtypes`` set (a pointer passed as a
bare Python int would be cut to 32 bits).

Nothing here falls back: a missing ``nvcc``, a failed build or a failed
launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("capture.cu", "lk.cu", "min_eig.cu")
HEADERS = ("region.cuh",)  # included by the sources; part of the build's hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # every product and sum rounds on its own, as in the plain versions
    "--fmad=false",
    "-Xcompiler", "-fPIC",
)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes; every function returns the cudaError_t of its launch and
# takes the stream last.
SIGNATURES = {
    "pmv_capture_level": (_p, _i, _i, _i, _p, _i, _i, _i, _p, _p, _p, _p),
    "pmv_lk_template": (_p, _p, _p, _i, _i, _i, _f, _p, _p, _p, _p, _p),
    "pmv_lk_iterate": (_p, _i, _i, _i, _p, _p, _p, _p, _p, _i, _i, _i, _i, _f, _i,
                       _p, _p, _p, _p, _p),
    "pmv_min_eig_response": (_p, _i, _i, _p, _p),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process made
build_log: str = ""  # what nvcc printed (e.g. under -Xptxas -v)


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file():
            exe = str(cand)
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of pmv_tpu_torch are compiled "
            "at first use and need the CUDA toolkit"
        )
    return exe


def _digest(extra_flags: tuple[str, ...]) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra_flags).encode())
    return h.hexdigest()[:16]


def build(extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile the sources (in parallel) and link them; returns the path of
    the shared library. A library already built from these very sources and
    flags is reused."""
    global build_seconds, build_log
    out_dir = BUILD_ROOT / _digest(extra_flags)
    lib_path = out_dir / "libpmv_kernels.so"
    if lib_path.is_file():
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = out_dir / f"tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = tmp / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append(
            (name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        )
    logs, failed = [], []
    for name, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"--- {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp_lib = tmp / "libpmv_kernels.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_lib), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor of
    the given dtype and shape on ``device``."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry ``name`` on PyTorch's current stream of ``device``
    and raise if the launch was refused."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
