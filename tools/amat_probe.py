#!/usr/bin/env python3
"""Device time of the A-formation kernel B5 at other launch plans.

    python tools/amat_probe.py

On one GPU, on the first-step inputs of box_stack4 (K = 20) and
box_stack8 (K = 32) at B = 4096 and on `chip_smoke.random_fused_inputs`
(K = 20): `csrc/amat.cu` with the whole of A as one item (the plan's
items at these K) and with slabs of about half of A's rows.  Each is timed as `chip_smoke.timings` times a kernel
(device time a call from one torch.profiler window of 20 calls, L2
overwritten before each call) and checked bit for bit against the plain
version.  Prints one line per case and the card.  It needs a CUDA device
and imports nothing of JAX.
"""

from __future__ import annotations

import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from eggshell_tpu_torch import kernels  # noqa: E402
from eggshell_tpu_torch.ops.amat_kernel import (amat_launch_plan,  # noqa: E402
                                                contact_system_matrix_plain, padded_rows)
from eggshell_tpu_torch.utils.profiling import device_window, l2_flush  # noqa: E402

REPS = 20


def kernel_ms(call, flush) -> float:
    """Device ms a call of `amat_kernel` inside call()."""
    pattern = re.compile(r"(^|[^A-Za-z0-9_])amat_kernel($|[^A-Za-z0-9_])")
    w = device_window(call, REPS, flush)
    return sum(ms for k, (ms, _) in w["by_name"].items() if pattern.search(k))


def launch(args, rows: int):
    """A and diag from `csrc/amat.cu` with slabs of `rows` rows (all of
    Jc one chunk)."""
    Jc, b0, b1, act, inv_mass, invIg, K, cfm = args
    B, n, mp = Jc.shape[0], inv_mass.shape[0], padded_rows(K)
    A = torch.empty((B, mp, mp), device=Jc.device)
    diag = torch.empty((B, mp), device=Jc.device)
    kernels.launch("eggshell_amat_f32", Jc.device, Jc, b0, b1, act, inv_mass, invIg, A, diag,
                   B, K, n, mp, float(cfm), rows, K)
    return A, diag


def main() -> int:
    if not torch.cuda.is_available():
        print("amat_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.load()
    flush = l2_flush(dev)
    cases = [("box_stack4 first step", chip_smoke.fused_inputs(dev, "box_stack4")["amat"]),
             ("box_stack8 first step", chip_smoke.fused_inputs(dev, "box_stack8")["amat"]),
             ("seeded random", chip_smoke.random_fused_inputs(dev)["amat"])]
    for what, args in cases:
        K = args[6]
        plan = amat_launch_plan(K)
        want = contact_system_matrix_plain(*args)
        out = []
        for rows in (plan.rows, 3 * (-(-K // 2))):
            same = all(torch.equal(g, w) for g, w in zip(launch(args, rows), want))
            ms = kernel_ms(lambda: launch(args, rows), flush)
            out.append(f"rows {rows}: {ms:.4f} ms (bit for bit {same})")
        print(f"[amat_probe] {what}, K={K}, plan: rows {plan.rows}; "
              + "; ".join(out))
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
