#!/usr/bin/env python3
"""Device time of the unfused Jacobi solves B6c and B6c' on the card.

    python tools/jacobi_probe.py            # resident against cluster form
    python tools/jacobi_probe.py --entry    # the entry `solve_lcp_jacobi`

Without arguments, on seeded SPD systems (`chip_smoke.random_spd_lcp`) at
B = 4096 and 16 sweeps: B6c at m = 96 and 128 and B6c' at m = 96 and 120
(m % 12 == 0: one tensor copy), each in its resident form (one block a
scenario) and its cluster form (the rows over the cluster
`jacobi_cluster_plan` picks), whatever `jacobi_launch_plan` would take
there; the two must return the same bits.  The cluster form alone at
m = 136, 160, 192 and 232 (B6c) and 132, 168, 192 and 228 (B6c').  Then
the cluster form at every cluster size from 2 to 16 (`MAX_CLUSTER`) that
`jacobi_cluster_plan` takes, at m = 192, 240 (B = 4096) and 480
(B = 512).  These are the measurements behind `JACOBI_RESIDENT_MAX_MP`
and the plan's cluster size.  First, the resident form at m = 32 and 60
with its rows copied by one tensor copy and by element loads (the copy of
an m that is not a multiple of 4).

With --entry: `solve_lcp_jacobi(block=False)` and `(block=True)` on the
seeded (4096, 60, 60) system and on the unfused slice's first LCP at
contact_capacity 80 ((4096, 240, 240), `chip_smoke.wide_unfused_lcp`),
whatever form the package in this checkout takes; the time is that of
every kernel whose name holds "jacobi", so the script times an older tree
of the repo the same way when copied into it.

Each time is device time a call from one torch.profiler window of 20
calls, with L2 overwritten before each call (as `chip_smoke.timings`).
Prints one line a case and the card.  It needs a CUDA device and imports
nothing of JAX.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from eggshell_tpu_torch import kernels  # noqa: E402
from eggshell_tpu_torch.ops import pgs_kernel  # noqa: E402
from eggshell_tpu_torch.utils.profiling import device_window, l2_flush  # noqa: E402

REPS = 20
SCALAR_M = (96, 128, 136, 160, 192, 232)
BLOCK_M = (96, 120, 132, 168, 192, 228)
CLUSTER_M = (192, 240, 480)


def jacobi_ms(call, flush) -> float:
    """Device ms a call of the kernels named *jacobi* inside call()."""
    w = device_window(call, REPS, flush)
    return sum(ms for name, (ms, _) in w["by_name"].items() if "jacobi" in name)


def forms(dev, flush) -> None:
    for block, ms in ((False, SCALAR_M), (True, BLOCK_M)):
        fn = "eggshell_jacobi_block_f32" if block else "eggshell_jacobi_f32"
        params = (16, 0.3) if block else (16, 0.3, 0.45)
        for m in ms:
            args = chip_smoke.random_spd_lcp(dev, B=4096, m=m)
            plans = {"resident": pgs_kernel.jacobi_resident_plan(m, block),
                     "cluster": pgs_kernel.jacobi_cluster_plan(m, block)}
            plans = {route: plan for route, plan in plans.items() if plan is not None}
            outs, line = {}, [f"{'B6c′' if block else 'B6c'} m={m} (mp={plans['cluster'].mp}):"]
            for route, plan in plans.items():
                def call(plan=plan):
                    return pgs_kernel.launch_jacobi_plan(fn, plan, *args, *params)

                outs[route] = call()
                t = jacobi_ms(call, flush)
                line.append(f"{route} {t:.4f} ms ({plan.reg_rows} columns in registers, "
                            f"{plan.copy}"
                            + (f", cluster of {plan.cluster}, {plan.rows} rows a block"
                               if route == "cluster" else "") + ");")
            torch.cuda.synchronize()
            same = "resident" not in outs or torch.equal(outs["resident"], outs["cluster"])
            line.append(("" if len(outs) == 1 else f"same bits {same}; ")
                        + f"plan {pgs_kernel.jacobi_launch_plan(m, block).route}")
            print(" ".join(line), flush=True)
            chip_smoke.check(same, f"m = {m}: the cluster form differs from the resident form")


def copies(dev, flush) -> None:
    """The resident B6c at m = 32 and 60 with its rows copied by one tensor
    copy (the plan) and by element loads (the copy m % 4 != 0 takes)."""
    for m in (32, 60):
        args = chip_smoke.random_spd_lcp(dev, B=4096, m=m)
        plan = pgs_kernel.jacobi_resident_plan(m)
        outs, line = [], [f"B6c m={m}, resident:"]
        for copy in ("tensor map", "element loads"):
            p = plan._replace(copy=copy)

            def call(p=p):
                return pgs_kernel.launch_jacobi_plan("eggshell_jacobi_f32", p, *args, 16, 0.3,
                                                     0.45)

            outs.append(call())
            line.append(f"{copy} {jacobi_ms(call, flush):.4f} ms;")
        torch.cuda.synchronize()
        print(" ".join(line + [f"same bits {torch.equal(*outs)}"]), flush=True)
        chip_smoke.check(torch.equal(*outs), f"m = {m}: the two copies differ")


def cluster_sizes(dev, flush) -> None:
    """The cluster form at every cluster size its plan takes, at m = 192,
    240 and 480."""
    for block in (False, True):
        fn = "eggshell_jacobi_block_f32" if block else "eggshell_jacobi_f32"
        params = (16, 0.3) if block else (16, 0.3, 0.45)
        for m in CLUSTER_M:
            args = chip_smoke.random_spd_lcp(dev, B=4096 if m < 480 else 512, m=m)
            line = [f"{'B6c′' if block else 'B6c'} m={m}, B={args[1].shape[0]}, cluster form:"]
            for c in range(2, pgs_kernel.MAX_CLUSTER + 1):
                plan = pgs_kernel.jacobi_cluster_plan(m, block, c)
                if plan is None:
                    continue
                t = jacobi_ms(lambda: pgs_kernel.launch_jacobi_plan(fn, plan, *args, *params),
                              flush)
                line.append(f"c={c} ({plan.rows} rows a block) {t:.4f} ms;")
            print(" ".join(line), flush=True)


def entry(dev, flush) -> None:
    cases = (("seeded SPD (4096, 60, 60)", chip_smoke.random_spd_lcp(dev)),
             ("unfused slice's first LCP at contact_capacity 80",
              chip_smoke.wide_unfused_lcp(dev)))
    for what, args in cases:
        for block in (False, True):
            t = jacobi_ms(lambda: pgs_kernel.solve_lcp_jacobi(*args, 16, 0.3, 0.45, block=block),
                          flush)
            print(f"solve_lcp_jacobi(block={block}) on {what}, A {tuple(args[0].shape)}: "
                  f"{t:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("jacobi_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.load()
    flush = l2_flush(dev)
    if "--entry" in sys.argv[1:]:
        entry(dev, flush)
    else:
        copies(dev, flush)
        forms(dev, flush)
        cluster_sizes(dev, flush)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
