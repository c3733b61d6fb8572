#!/usr/bin/env python3
"""Device time of the body-prep kernel B1 on the card, through its entry.

    python tools/prep_probe.py

On the first-step inputs of the bench step (box_stack4, B = 4096, n = 4),
box_stack8 (n = 8), living_room (n = 7, four static bodies), box_drop
(n = 1), and the bench step's with seeded control wrenches ext_forces
(B, n, 6) (the MPC input), B1 is first compared with its plain version
(whether it gave its bits is printed), then timed through `prep_bodies`:
the time is that of every kernel whose name holds "prep", whatever kernel
the package in this checkout launches, so the script times an older tree of the repo the same way when copied
into it (the parent comparison).  Each time is device time a call from one
torch.profiler window of 20 calls, with L2 overwritten before each call
(as `chip_smoke.timings`); beside it the bound from the case's bytes
(`chip_smoke.bound`).  Prints one line a case and the card.  It needs a
CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from eggshell_tpu_torch.ops import prep_kernel as pk  # noqa: E402
from eggshell_tpu_torch.utils.profiling import device_window, l2_flush  # noqa: E402

REPS = 20
SCENES = ("box_stack4", "box_stack8", "living_room", "box_drop")


def main() -> int:
    if not torch.cuda.is_available():
        print("prep_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    flush = l2_flush(dev)
    cases = [(scene, chip_smoke.fused_inputs(dev, scene)["prep"]) for scene in SCENES]
    bench = cases[0][1]
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    ext = torch.as_tensor(rng.normal(size=tuple(bench[0].shape[:2]) + (6,)),
                          dtype=torch.float32, device=dev)
    cases.append(("box_stack4 with ext_forces", bench[:8] + (ext,)))
    for what, args in cases:
        got, want = pk.prep_bodies(*args), pk.prep_bodies_plain(*args)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        w = device_window(lambda: pk.prep_bodies(*args), REPS, flush)
        ms = sum(t for name, (t, _) in w["by_name"].items() if "prep" in name)
        b = chip_smoke.bound(chip_smoke.moved_bytes(args, got), 250.0 * args[0].shape[0]
                             * args[0].shape[1])
        B, n = args[0].shape[:2]
        print(f"[prep_probe] {what} (B={B}, n={n}): {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bytes']} bytes), {ms / b['bound_ms']:.2f}x; the plain version's bits: {same}")
    print(f"[card] {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
