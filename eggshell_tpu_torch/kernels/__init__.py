"""Build and load the port's CUDA kernels.

The sources in `eggshell_tpu_torch/csrc/` are compiled at first use with
`nvcc` into one shared library with a plain C interface, loaded with
`ctypes`.  The library lands in `eggshell_tpu_torch/kernels/_build/`
(listed in `.gitignore`) under a name that carries a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("narrowphase.cu", "jacobi.cu")
# --fmad=false: every product and sum is rounded on its own, as in the
# plain torch versions (see the note in csrc/narrowphase.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    # p1, R1, hs1, p2, R2, hs2, pos, nrm, dep, act, code, idep, iax, n, stream
    "eggshell_narrowphase_f32": [_P] * 13 + [ctypes.c_int64, _P],
    # A, b, is_eq, lo, hi, x, B, m, m_pad, iters, omega, beta, stream
    "eggshell_jacobi_f32": [_P] * 6 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_float, ctypes.c_float, _P],
    "eggshell_cuda_error_string": [ctypes.c_int],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libeggshell_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists.
    The library is written to a temporary name and renamed, so a process
    never loads a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_char_p if name == "eggshell_cuda_error_string" else ctypes.c_int
    return lib


def check_arg(name: str, x, shape: tuple, dtype, device) -> None:
    """Raise unless tensor `x` is what a kernel takes: on `device`, of
    `dtype` and `shape`, contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} on CUDA, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def error_string(code: int) -> str:
    return f"{code} ({load().eggshell_cuda_error_string(code).decode()})"
