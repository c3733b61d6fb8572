#!/usr/bin/env python3
"""Device time of the integrate kernel B7 and the compaction kernels B3 and
B3g on the card.

    python tools/integrate_compact_probe.py                        # through the entries
    python tools/integrate_compact_probe.py --threads 64 128 256 512  # B7 at other tiles

On the first-step inputs of the bench step (box_stack4, B = 4096: B7 at
K = 20, n = 4; B3 on 104 candidates), box_stack8 (K = 32, n = 8; 400
candidates), living_room (K = 32, n = 7; 236 candidates) and box_drop (B7
at K = 8, n = 1; the ground-only B3g), each case is first held against
its plain version: B7 bit for bit, B3 and B3g with identical ids and
flags and geometry within 1e-6.

Without arguments each case goes through its entry (`integrate_step`,
`compact_contacts`): the time is that of every kernel whose name holds
"integrate" or "compact", whatever kernel the package in this checkout
launches, so the script times an older tree of the repo the same way when
copied into it (the parent comparison).

With --threads: `csrc/integrate.cu` is built alone once for each count
of threads a block named (its EGGSHELL_INTEGRATE_THREADS, which sets the
tile: 256 // 2K scenarios a block at the default; the package builds only
the default), all at once, into the package's build directory, and B7 is
launched through that library's C entry at the plan it reports.  Each
must return the entry's bits; prints each one's tile, time and registers.
These are the measurements behind `integrate_launch_plan`.

Each time is device time a call from one torch.profiler window of 20
calls, with L2 overwritten before each call (as `chip_smoke.timings`).
Prints one line a case and the card.  It needs a CUDA device and imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from eggshell_tpu_torch import kernels  # noqa: E402
from eggshell_tpu_torch.ops import compact_kernel as cpk  # noqa: E402
from eggshell_tpu_torch.ops import integrate_kernel as ik  # noqa: E402
from eggshell_tpu_torch.utils.profiling import device_window, l2_flush  # noqa: E402

REPS = 20
SCENES = ("box_stack4", "box_stack8", "living_room", "box_drop")


def kernel_ms(call, flush, word) -> float:
    """Device ms a call of the kernels whose name holds `word` in call()."""
    w = device_window(call, REPS, flush)
    return sum(ms for name, (ms, _) in w["by_name"].items() if word in name)


def checked(scene, args):
    """Hold B7 and B3/B3g against their plain versions on one scene's
    first step; return the lines' descriptions."""
    integ, comp = args["integrate"], args["compact"]
    got = ik.integrate_step(*integ)
    same = all(torch.equal(a, b) for a, b in zip(got, ik.integrate_step_plain(*integ)))
    chip_smoke.check(same, f"B7 on {scene}: not the plain version's bits")
    cs, want = cpk.compact_contacts(*comp), cpk.compact_contacts_plain(*comp)
    ids = all(torch.equal(getattr(cs, k), getattr(want, k)) for k in ("b0", "b1", "active"))
    err = max(float((getattr(cs, k) - getattr(want, k)).abs().max())
              for k in ("position", "normal", "depth"))
    chip_smoke.check(ids and err <= 1e-6, f"B3 on {scene}: ids {ids}, geometry {err}")
    B, K = integ[2].shape
    n = integ[4].shape[1]
    P = 0 if comp[4] is None else comp[5].shape[0]
    return (f"B7 {scene} first step (B={B}, K={K}, n={n})",
            f"{'B3' if P else 'B3g'} {scene} first step ({8 * n + 12 * P} candidates, K={K})")


def entries(dev, flush) -> None:
    for scene in SCENES:
        args = chip_smoke.fused_inputs(dev, scene)
        b7, b3 = checked(scene, args)
        t7 = kernel_ms(lambda: ik.integrate_step(*args["integrate"]), flush, "integrate")
        t3 = kernel_ms(lambda: cpk.compact_contacts(*args["compact"]), flush, "compact")
        print(f"{b7}, through the entry: {t7:.4f} ms, bits of the plain version", flush=True)
        print(f"{b3}, through the entry: {t3:.4f} ms, ids and flags of the plain version",
              flush=True)
    usage = getattr(kernels, "ptxas_usage", dict)()
    regs = {name: u.get("registers") for name, u in sorted(usage.items())
            if "integrate" in name or "compact" in name}
    print(f"registers: {regs if regs else 'not reported by this build'}")


def build_threads(counts) -> dict:
    """T -> (ctypes library of `csrc/integrate.cu` built at T threads a
    block, its kernel's registers), one nvcc each, all started together."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in kernels.COMPILE_FLAGS if f != "-c"]
    procs = {}
    for T in counts:
        so = kernels.BUILD_DIR / f"integrate_threads{T}.so"
        procs[T] = (so, subprocess.Popen(
            [kernels._nvcc(), *flags, "-shared", f"-DEGGSHELL_INTEGRATE_THREADS={T}", "-o",
             str(so), str(kernels.CSRC / "integrate.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for T, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc at {T} threads a block failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for name in ("eggshell_integrate_f32", "eggshell_integrate_plan"):
            getattr(lib, name).argtypes = kernels._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        regs = [use.get("registers") for name, use in kernels.parse_ptxas(log).items()
                if re.search(r"integrate_kernel", name)]
        out[T] = (lib, regs[0] if regs else "?")
    return out


def plan_of(lib, B, K, n) -> tuple:
    plan = (ctypes.c_int * 5)()
    if lib.eggshell_integrate_plan(B, K, n, plan) != 0:
        raise RuntimeError(f"no plan for B = {B}, K = {K}, n = {n}")
    return tuple(plan)


def launch_at(lib, args):
    """The entry's outputs, computed by `lib` at the plan it reports."""
    Jc, lam, b0, b1, p, q, v, w, inv_mass, invIg, F, dt = args
    B, K = b0.shape
    n = p.shape[1]
    outs = (torch.empty_like(p), torch.empty_like(q), torch.empty_like(v), torch.empty_like(w))
    raw = (*args[:11], *outs, B, K, n, lam.shape[-1], float(dt), *plan_of(lib, B, K, n))
    err = lib.eggshell_integrate_f32(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                                       for a in raw],
                                     torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"integrate refused: {err}")
    return outs


def threads(dev, flush, counts) -> None:
    libs = build_threads(counts)
    for scene in SCENES:
        args = chip_smoke.fused_inputs(dev, scene)["integrate"]
        B, K = args[2].shape
        n = args[4].shape[1]
        want = ik.integrate_step(*args)
        line = [f"B7 {scene} first step (B={B}, K={K}, n={n}):"]
        for T, (lib, regs) in libs.items():
            S = plan_of(lib, B, K, n)[0]
            got = launch_at(lib, args)
            chip_smoke.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                             f"B7 at {T} threads a block differs from the entry")
            t = kernel_ms(lambda: launch_at(lib, args), flush, "integrate")
            line.append(f"T={T} S={S} {t:.4f} ms ({regs} registers);")
        plan = ik.integrate_launch_plan(B, K, n)
        line.append(f"the entry's T={plan.threads} S={plan.scenarios}")
        print(" ".join(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("integrate_compact_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.load()
    flush = l2_flush(dev)
    argv = sys.argv[1:]
    if argv[:1] == ["--threads"]:
        threads(dev, flush, [int(a) for a in argv[1:]] or [64, 128, 256, 512])
    else:
        entries(dev, flush)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
