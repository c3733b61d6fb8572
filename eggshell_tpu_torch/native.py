"""ctypes binding of the native C++ box-LCP solver (`native/box_lcp.cc`),
counterpart of `eggshell_tpu.native`.

The solver runs on the host.  At first use the source is built with g++
into `eggshell_tpu_torch/kernels/_build/`, under a name that carries the
hash of the source and the flags; the library is written under a
temporary name and renamed, so a process never loads a half-written file.
Nothing is written into `native/`.  The entry points take NumPy arrays or
CPU tensors and return what they were given: NumPy arrays, or float64 CPU
tensors where A was a tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent.parent / "native" / "box_lcp.cc"
BUILD_DIR = Path(__file__).resolve().parent / "kernels" / "_build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_ALGORITHMS = {"murty": 0, "cottle_dantzig": 1}
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libeggshell_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        res = subprocess.run(["g++", *FLAGS, "-o", so, str(SOURCE)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} ({res.returncode}):\n{res.stderr}")
        os.replace(so, out)
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    i, d = ctypes.c_int, ctypes.c_double
    lib.egg_solve_box_lcp_stats.restype = i
    lib.egg_solve_box_lcp_stats.argtypes = [i, dp, dp, dp, dp, dp, dp, ip, i, d, i, dp, ip]
    lib.egg_solve_box_lcp_schur.restype = i
    lib.egg_solve_box_lcp_schur.argtypes = [i, dp, dp, dp, dp, dp, dp, i, d, i, d]
    lib.egg_solve_box_lcp_batch.restype = None
    lib.egg_solve_box_lcp_batch.argtypes = [i, i, dp, dp, dp, dp, dp, dp, ip, i, d]
    _LIB = lib
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _host(x) -> np.ndarray:
    """A contiguous float64 NumPy copy of an array or a CPU tensor."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"the native solver runs on the host: got a tensor on {x.device}")
        x = x.detach().numpy()
    return np.ascontiguousarray(x, dtype=np.float64)


def _inputs(A, b, lo, hi, shape):
    """A, b and the bounds as float64 host arrays, infinite bounds replaced
    by +-1e300 (the native clamp is finite); raises on a wrong shape."""
    A, b, lo, hi = (_host(x) for x in (A, b, lo, hi))
    if A.shape != shape + shape[-1:] or any(v.shape != shape for v in (b, lo, hi)):
        raise ValueError(f"box LCP shapes: A {A.shape}, b {b.shape}, lo {lo.shape}, "
                         f"hi {hi.shape}")
    lo = np.where(np.isinf(lo), -1e300, lo)
    hi = np.where(np.isinf(hi), 1e300, hi)
    return A, b, lo, hi


def _out(like, *arrays):
    """The arrays as NumPy, or as CPU tensors where `like` is a tensor."""
    if isinstance(like, torch.Tensor):
        return tuple(torch.from_numpy(a) for a in arrays)
    return arrays


def solve_box_lcp(A, b, lo, hi, max_iterations: int = 1000, tol: float = 1e-10,
                  algorithm: str = "murty", return_info: bool = False):
    """Principal-pivot box LCP, MURTY or COTTLE_DANTZIG: A (n, n), b, lo,
    hi (n,).  Returns (x, w, converged); when the budget is spent, (x, w) is
    the best iterate by KKT goodness.  With return_info=True the third
    element is {converged, iterations, goodness, fallback_used}."""
    n = np.shape(b)[0]
    A_, b_, lo_, hi_ = _inputs(A, b, lo, hi, (n,))
    x = np.zeros(n)
    w = np.zeros(n)
    side = np.zeros(n, dtype=np.int32)
    goodness = ctypes.c_double(0.0)
    iters = ctypes.c_int(0)
    ok = _load().egg_solve_box_lcp_stats(
        n, _dp(A_), _dp(b_), _dp(lo_), _dp(hi_), _dp(x), _dp(w), _ip(side), max_iterations,
        tol, _ALGORITHMS[algorithm], ctypes.byref(goodness), ctypes.byref(iters))
    x, w = _out(A, x, w)
    if not return_info:
        return x, w, bool(ok)
    return x, w, {"converged": bool(ok), "iterations": int(iters.value),
                  "goodness": float(goodness.value), "fallback_used": not bool(ok)}


def solve_box_lcp_schur(A, b, lo, hi, max_iterations: int = 1000, tol: float = 1e-10,
                        algorithm: str = "murty"):
    """The Schur-complement path: the unbounded variables (lo = -inf,
    hi = +inf) are eliminated exactly before pivoting.  Returns (x, w, ok);
    raises `np.linalg.LinAlgError` on a singular unbounded block."""
    n = np.shape(b)[0]
    A_, b_, lo_, hi_ = _inputs(A, b, lo, hi, (n,))
    x = np.zeros(n)
    w = np.zeros(n)
    ok = _load().egg_solve_box_lcp_schur(
        n, _dp(A_), _dp(b_), _dp(lo_), _dp(hi_), _dp(x), _dp(w), max_iterations, tol,
        _ALGORITHMS[algorithm], 1e250)
    if ok < 0:
        raise np.linalg.LinAlgError("singular unbounded block in Schur LCP")
    return (*_out(A, x, w), bool(ok))


def solve_box_lcp_batch(A, b, lo, hi, max_iterations: int = 1000, tol: float = 1e-10):
    """Batched solves: A (B, n, n), b, lo, hi (B, n).  Returns (x, w,
    status), status (B,) bool."""
    B, n = np.shape(b)
    A_, b_, lo_, hi_ = _inputs(A, b, lo, hi, (B, n))
    x = np.zeros((B, n))
    w = np.zeros((B, n))
    status = np.zeros(B, dtype=np.int32)
    _load().egg_solve_box_lcp_batch(
        B, n, _dp(A_), _dp(b_), _dp(lo_), _dp(hi_), _dp(x), _dp(w), _ip(status),
        max_iterations, tol)
    return _out(A, x, w, status.astype(bool))
