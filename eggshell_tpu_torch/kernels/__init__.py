"""Build and load the port's CUDA kernels.

The sources in `eggshell_tpu_torch/csrc/` are compiled at first use with
`nvcc`, one process per source, all started together, and linked into one
shared library with a plain C interface, loaded with `ctypes`.  The
library lands in `eggshell_tpu_torch/kernels/_build/` (listed in
`.gitignore`) under a name that carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("narrowphase.cu", "compact.cu", "jacobi.cu", "prep.cu", "jassembly.cu", "amat.cu",
           "jacobi_packed.cu", "jacobi_packed_stream.cu", "integrate.cu", "fdtd2d.cu")
# Headers the sources include; they count in the library's hash.
HEADERS = ("block3.cuh", "jacobi_rows.cuh", "rows_global.cuh", "rows_stream.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# --fmad=false: every product and sum is rounded on its own, as in the
# plain torch versions (see the note in csrc/narrowphase.cu).  -Xptxas -v:
# each kernel's registers, stack and spills, kept beside the library
# (`ptxas_usage`).
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler",
                 "-fPIC", "-c")

# Hopper: 227 KB of shared memory a block (232,448 bytes).  The launch
# plans keep a block within half of that where they can, so that two
# blocks share an SM and one block's barriers hide behind the other's work.
MAX_SHARED_BYTES = 232_448
SHARED_TARGET_BYTES = MAX_SHARED_BYTES // 2

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # p1, R1, hs1, p2, R2, hs2, pos, nrm, dep, act, code, idep, iax, n, lanes, threads, blocks,
    # shared_bytes, stream
    "eggshell_narrowphase_f32": [_P] * 13 + [_I64, _I, _I, _I64, _I, _P],
    # p, q, hs, pair_i, pair_j, gate, pos, nrm, dep, act, B, n, P, pair_stride, lanes, threads,
    # blocks, shared_bytes, stream
    "eggshell_narrowphase_packed_f32": [_P] * 10 + [_I64, _I, _I, _I64, _I, _I, _I64, _I, _P],
    # p, q, hs, gen, pp_pos, pp_nrm, pp_dep, pp_act, pair_i, pair_j, b0, b1, pos, nrm, dep, act,
    # B, n, P, pair_stride, K, eps2, cap, stream
    "eggshell_compact_f32": [_P] * 16 + [_I64, _I, _I, _I64, _I, _F, _F, _P],
    # A, b, is_eq, lo, hi, x, B, m, m_pad, iters, omega, beta, route, copy, reg_rows, cluster,
    # rows, threads, stages, chunk, inflight, stream
    "eggshell_jacobi_f32": [_P] * 6 + [_I64, _I, _I, _I, _F, _F] + [_I] * 9 + [_P],
    # A, b, is_eq, lo, hi, x, B, m, m_pad, iters, omega, route, copy, reg_rows, cluster, rows,
    # threads, stages, chunk, inflight, stream
    "eggshell_jacobi_block_f32": [_P] * 6 + [_I64, _I, _I, _I, _F] + [_I] * 9 + [_P],
    # q, v, w, ext, inv_mass, Ib, invIb, uhat, invIg, F, B, n, inv_dt, gx, gy, gz, tile, stream
    "eggshell_prep_f32": [_P] * 10 + [_I64, _I, _F, _F, _F, _F, _I, _P],
    # b0, b1, pos, pos1, nrm, dep, act, eq, p, uhat, Jc, rhs, B, K, n, erp_dt2, stream
    "eggshell_jassembly_f32": [_P] * 12 + [_I64, _I, _I, _F, _P],
    # Jc, b0, b1, act, inv_mass, invIg, A, diag, B, K, n, mp, cfm, rows, chunk, stream
    "eggshell_amat_f32": [_P] * 8 + [_I64, _I, _I, _I, _F, _I, _I, _P],
    # A, diag, rhs, act, eq, x, B, K, mp, iters, mu, omega, beta, pyramid_mu, reg_rows, stream
    "eggshell_jacobi_packed_f32": [_P] * 6 + [_I64, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    "eggshell_jacobi_packed_pyramid_f32": [_P] * 6 + [_I64, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    "eggshell_jacobi_packed_block_f32": [_P] * 6 + [_I64, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    # A, diag, rhs, act, eq, x, B, K, mp, iters, mu, omega, beta, reg_rows, cluster, rows, stream
    "eggshell_jacobi_packed_stream_f32": [_P] * 6 + [_I64, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P],
    # A, diag, rhs, act, eq, x, B, K, mp, iters, mu, omega, beta, cluster, rows, threads, stages,
    # chunk, inflight, stream
    "eggshell_jacobi_packed_streamed_f32": [_P] * 6 + [_I64, _I, _I, _I, _F, _F, _F] + [_I] * 6
    + [_P],
    # block, route, reg_rows, cluster, threads, shared_bytes, out
    "eggshell_jacobi_active_clusters": [_I] * 6 + [_P],
    # streamed, reg_rows, cluster, threads, shared_bytes, out
    "eggshell_jacobi_packed_active_clusters": [_I] * 5 + [_P],
    # A, diag, rhs, act, eq, x, B, K, mp, iters, mu, omega, beta, threads, stream
    "eggshell_jacobi_packed_rows_f32": [_P] * 6 + [_I64, _I, _I, _I, _F, _F, _F, _I, _P],
    # Jc, lam, b0, b1, p, q, v, w, inv_mass, invIg, F, p_out, q_out, v_out, w_out,
    # B, K, n, lam_stride, dt, scenarios, lanes, bodies, threads, shared_bytes, stream
    "eggshell_integrate_f32": [_P] * 15 + [_I64, _I, _I, _I, _F] + [_I] * 5 + [_P],
    # B, K, n, out (scenarios, lanes, bodies, threads, shared_bytes)
    "eggshell_integrate_plan": [_I64, _I, _I, _P],
    # ez, hx, hy, inv_eps, pec_free, ez_out, hx_out, hy_out, nx, ny, c, stream
    "eggshell_fdtd2d_f32": [_P] * 8 + [_I, _I, _F, _P],
    "eggshell_cuda_error_string": [_I],
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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libeggshell_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists.
    Each source is compiled by its own nvcc, all at once; the objects are
    linked into a temporary name that is then renamed, so a process never
    loads a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", obj, str(CSRC / s)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{s} ({p.returncode}):\n{log}"
                  for s, p, log in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        Path(tmp, "ptxas.txt").write_text("\n".join(logs))
        so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(os.path.join(tmp, "ptxas.txt"), _ptxas_log(out))
        os.replace(so, out)
    return out


def _ptxas_log(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_usage() -> dict:
    """Each kernel entry of the built library (mangled name) -> its
    `registers`, `stack`, `spill_stores` and `spill_loads` in bytes, as
    ptxas reported them when the library was built."""
    return parse_ptxas(_ptxas_log(build()).read_text())


def parse_ptxas(log: str) -> dict:
    """`ptxas_usage` of an `-Xptxas -v` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
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


# What to differentiate instead of a kernel's wrapper, by C entry: the
# kernels write into fresh tensors that autograd cannot see through.
_FUSED_ENTRY = ("differentiate through physics.stepper.step_ode_batched, whose fused step is "
                "a torch.autograd.Function (its backward recomputes the plain twin)")
_NO_BACKWARD = ("this kernel has no backward, nor has the JAX package's: differentiate the "
                "plain solve (SolverKind.JACOBI, PGS, SOR or DIRECT) instead")
DIFFERENTIABLE_ENTRY = {
    "eggshell_narrowphase_f32": "differentiate through ops.collision_kernel.collide_boxes_lanes_diff",
    "eggshell_jacobi_f32": _NO_BACKWARD,
    "eggshell_jacobi_block_f32": _NO_BACKWARD,
    "eggshell_fdtd2d_f32": ("this kernel has no backward, nor has the JAX package's: "
                            "differentiate the plain step fem.fdtd.step_2d instead"),
}


def grad_refusal(fn_name: str, args, grad_enabled: bool) -> Optional[str]:
    """Why launching the C entry `fn_name` on `args` would lose a gradient,
    or None: grad mode is on and a tensor argument requires grad.  The
    message names the kernel and says what to differentiate instead."""
    if not grad_enabled or not any(isinstance(a, torch.Tensor) and a.requires_grad
                                   for a in args):
        return None
    wrapper = fn_name.removeprefix("eggshell_").removesuffix("_f32")
    return (f"the {wrapper} kernel ({fn_name}) was called with a tensor that requires grad "
            f"while grad mode is on; its output would stop the gradient: "
            f"{DIFFERENTIABLE_ENTRY.get(fn_name, _FUSED_ENTRY)}")


def launch(fn_name: str, device, *args) -> None:
    """Call the C entry point `fn_name` on the current stream of `device`
    (tensors go as their data pointers, None as a null pointer) and raise
    if the launch was refused.  Raises RuntimeError, before launching,
    where a gradient would be lost (`grad_refusal`)."""
    refusal = grad_refusal(fn_name, args, torch.is_grad_enabled())
    if refusal is not None:
        raise RuntimeError(refusal)
    lib = load()
    raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*raw, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: {error_string(err)}")


def error_string(code: int) -> str:
    return f"{code} ({load().eggshell_cuda_error_string(code).decode()})"
