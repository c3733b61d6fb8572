#!/usr/bin/env python3
"""Device time of the packed Jacobi kernels B6 and B6b at chosen launch plans.

    python tools/jacobi_packed_probe.py

On one GPU, on the seeded SPD systems of `chip_smoke.random_lcp` at
B = 4096 and 16 sweeps, for mp = 64, 96, 128, 136, 160, 168, 176, 184 and
192: the resident B6 (scalar form) with rows in registers where its plan
holds them and with rows read from shared memory, and B6b at every
cluster size from 2 to 8 that divides mp.  B6 against B6b at the plans'
settings is the measurement behind `PACKED_RESIDENT_MAX_MP`.  Each is
timed as `chip_smoke.timings` times a kernel (device time a call from one
torch.profiler window of 20 calls, L2 overwritten before each call), and
B6 and B6b at their plans' settings also with the L2 overwritten and then
read before each call, which leaves no dirty line to write back during
the kernel.  Prints one line per mp and the card.
It needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from eggshell_tpu_torch import kernels  # noqa: E402
from eggshell_tpu_torch.ops.pgs_kernel import packed_launch_plan  # noqa: E402
from eggshell_tpu_torch.utils.profiling import device_window  # noqa: E402

REPS = 20


def kernel_ms(name: str, call, flush) -> float:
    """Device ms a call of the kernel `name` inside call()."""
    pattern = re.compile(r"(^|[^A-Za-z0-9_])" + name + r"($|[^A-Za-z0-9_])")
    w = device_window(call, REPS, flush)
    return sum(ms for k, (ms, _) in w["by_name"].items() if pattern.search(k))


def main() -> int:
    if not torch.cuda.is_available():
        print("jacobi_packed_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.load()
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def dirty():
        buf.fill_(1)

    def clean():
        buf.fill_(1)
        buf.sum(dtype=torch.int32)

    for K in (20, 32, 42, 45, 53, 56, 58, 59, 64):
        A, diag, rhs, act, eq, K, mu, iters, omega, beta = chip_smoke.random_lcp(
            dev, 4096, K, chip_smoke.SEED + 7)
        B, mp = diag.shape
        plan = packed_launch_plan(mp)
        out = torch.empty((B, mp), device=dev)
        head = (A, diag, rhs, act, eq, out, B, K, mp, iters, mu, omega, beta)

        def resident(rl):
            return lambda: kernels.launch("eggshell_jacobi_packed_f32", dev, *head, 0.0, rl)

        def cluster(rl, c):
            return lambda: kernels.launch("eggshell_jacobi_packed_stream_f32", dev, *head, rl, c,
                                          mp // c)

        line = [f"mp={mp}:"]
        rl = plan.resident.reg_rows
        for flush_name, flush in (("overwritten", dirty), ("overwritten and read", clean)):
            r = kernel_ms("jacobi_packed_kernel", resident(rl), flush)
            s = kernel_ms("jacobi_packed_stream_kernel", cluster(rl, plan.cluster.cluster), flush)
            line.append(f"L2 {flush_name}: B6 {r:.4f} ms, B6b (c={plan.cluster.cluster}) "
                        f"{s:.4f} ms;")
        if rl:
            line.append(f"rows from shared memory: B6 "
                        f"{kernel_ms('jacobi_packed_kernel', resident(0), dirty):.4f} ms;")
        for c in range(2, 9):
            if mp % c == 0:
                ms = kernel_ms("jacobi_packed_stream_kernel", cluster(rl, c), dirty)
                line.append(f"B6b c={c} {ms:.4f}")
        print(" ".join(line), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
