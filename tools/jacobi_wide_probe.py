#!/usr/bin/env python3
"""Device time of the Jacobi solves past 664 rows (B6c, B6c' and B6b) on the card.

    python tools/jacobi_wide_probe.py            # through the entries
    python tools/jacobi_wide_probe.py --sizes    # every cluster size and ring
    python tools/jacobi_wide_probe.py --out DIR  # also write the rows as JSON

Without arguments, through the entries `solve_lcp_jacobi(block=False)`,
`(block=True)` and `solve_lcp_jacobi_packed_stream` on the seeded SPD
systems of `chip_smoke.random_spd_lcp` and `chip_smoke.random_lcp`, 16
sweeps: B6c and B6c' at m = 672, B = 64, B6b at mp = 888, B = 256, and all
three at m = mp = 1,200, B = 64, whatever route the package in this
checkout takes there: so the script times an older tree of the repo the
same way when copied into it (the parent comparison).  Each line gives the
device time of every kernel whose name holds "jacobi" and of the plain
version, the bytes of one read of A and of `iters` reads, the rate each
gives, the SMs with work (one block a scenario for the global-rows route;
the cluster size times the clusters that fit, from
`cudaOccupancyMaxActiveClusters`, for the cluster and streamed routes),
the waves of scenarios, and the cycles a sweep of one wave takes at the SM
clock nvidia-smi reads just after the window.  It also times B6c at
m = 240 and B6b at mp = 192 (B = 4096), below 664 rows, whose cluster
forms share the row sums.

With --sizes (this tree only): B6c and B6c' at m = 672, B = 64 in the
cluster form at every size from 9 to 16 that holds the rows, and in the
streamed form; B6b at mp = 888, B = 256 likewise; and the streamed form at
m = mp = 1,200 (and B6c at 1,400), B = 64, at cluster sizes 12 and 16,
each with every cluster that fits in flight and with 4 to 7 at most.  These are the
measurements behind the plans' wide-cluster rule, `*_CLUSTER_MAX_MP`,
`STREAM_CLUSTER` and `STREAM_INFLIGHT`.  Every form must return the
entry's bits.

Each time is device time a call from one torch.profiler window of 20
calls, L2 overwritten before each (as `chip_smoke.timings`).  Prints one
line a case and the card; with `--out DIR`, also writes the rows as JSON
to DIR/jacobi_wide_probe_<tag>.json (<tag>: $PROBE_TAG, else the mode;
DIR relative to the directory it is run from, so an older tree copied
elsewhere writes beside this one's).  It needs a CUDA device and imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from eggshell_tpu_torch import kernels  # noqa: E402
from eggshell_tpu_torch.ops import pgs_kernel  # noqa: E402
from eggshell_tpu_torch.utils.profiling import device_window, l2_flush  # noqa: E402

REPS = 20
ITERS, OMEGA, BETA = 16, 0.3, 0.45
SMS = 132


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def jacobi_ms(call, flush) -> float:
    """Device ms a call of the kernels named *jacobi* inside call()."""
    w = device_window(call, REPS, flush)
    return sum(ms for name, (ms, _) in w["by_name"].items() if "jacobi" in name)


def active_clusters(packed: bool, plan, block: bool) -> int | None:
    """Clusters of `plan` that fit the card at once, or None where this
    tree has no such query (an older tree) or the plan has no cluster."""
    lib = kernels.load()
    out = ctypes.c_int(0)
    if packed:
        if not hasattr(lib, "eggshell_jacobi_packed_active_clusters"):
            return None
        streamed = isinstance(plan, pgs_kernel.StreamedPlan)
        err = lib.eggshell_jacobi_packed_active_clusters(
            int(streamed), 0 if streamed else plan.reg_rows, plan.cluster, plan.threads,
            plan.shared_bytes, ctypes.byref(out))
    else:
        if not hasattr(lib, "eggshell_jacobi_active_clusters") or plan.route not in (
                "cluster", "streamed"):
            return None
        err = lib.eggshell_jacobi_active_clusters(
            int(block), pgs_kernel.JACOBI_ROUTES[plan.route], plan.reg_rows, plan.cluster,
            plan.threads, plan.shared_bytes, ctypes.byref(out))
    chip_smoke.check(err == 0, f"active clusters query failed: {kernels.error_string(err)}")
    return out.value


def describe(packed: bool, B: int, block: bool, n: int, plan=None) -> dict:
    """Route, SMs with work and waves of the plan the tree takes (or `plan`)."""
    if packed:
        p = pgs_kernel.packed_launch_plan(n)
        if plan is None:
            plan = (getattr(p, "cluster", None) or getattr(p, "streamed", None)
                    or getattr(p, "rows", None))
        route = type(plan).__name__
        cluster = getattr(plan, "cluster", 1) if route != "RowsPlan" else 1
    else:
        plan = plan or pgs_kernel.jacobi_launch_plan(n, block)
        route = plan.route
        cluster = plan.cluster
    if route in ("global rows", "RowsPlan"):
        # one block a scenario, spread over the SMs first
        per_sm = max(1, min(2048 // plan.threads, kernels.MAX_SHARED_BYTES // plan.shared_bytes))
        return {"route": "global rows", "sms": min(B, SMS), "waves": -(-B // (per_sm * SMS))}
    nc = active_clusters(packed, plan, block)
    if nc is None:
        return {"route": str(route), "sms": None, "waves": None}
    nc = min(nc, getattr(plan, "inflight", 0) or nc)
    ring = f", ring {plan.stages} x {plan.chunk}" if getattr(plan, "stages", 0) else ""
    cap = f", at most {plan.inflight} in flight" if getattr(plan, "inflight", 0) else ""
    return {"route": f"{route}, c={cluster}, {plan.rows} rows a block{ring}{cap}",
            "blocks": min(B, nc) * cluster, "sms": min(SMS, min(B, nc) * cluster),
            "clusters": nc, "waves": -(-B // nc)}


def record(what: str, t: float, plain: float | None, a_bytes: int, one_read: int, info: dict,
           clock: float) -> dict:
    row = {"case": what, "ms": t, "plain_ms": plain, "one_read_bytes": one_read,
           "a_bytes": a_bytes, "one_read_tb_s": one_read / t * 1e-9,
           "iters_reads_tb_s": ITERS * a_bytes / t * 1e-9,
           "bound_ms": one_read / chip_smoke.PEAK_BYTES_PER_S * 1e3,
           "iters_reads_floor_ms": ITERS * a_bytes / chip_smoke.PEAK_BYTES_PER_S * 1e3,
           "sm_clock_mhz": clock, **info}
    if info.get("waves"):
        row["cycles_a_sweep"] = t * 1e-3 * clock * 1e6 / (ITERS * info["waves"])
    print(f"{what}: {t:.4f} ms" + (f", plain {plain:.4f} ms" if plain is not None else "")
          + f"; {info['route']}; SMs with work {info.get('sms')} (blocks in flight "
          f"{info.get('blocks', info.get('sms'))}), waves {info.get('waves')}, "
          f"cycles a sweep {row.get('cycles_a_sweep', float('nan')):.0f} at {clock:.0f} MHz; "
          f"A {a_bytes} bytes: one read {row['one_read_tb_s']:.3f} TB/s "
          f"(bound {row['bound_ms']:.4f} ms), {ITERS} reads {row['iters_reads_tb_s']:.3f} TB/s "
          f"(floor {row['iters_reads_floor_ms']:.4f} ms)", flush=True)
    return row


def unfused_case(dev, B, m, block):
    args = chip_smoke.random_spd_lcp(dev, B=B, m=m)
    call = lambda: pgs_kernel.solve_lcp_jacobi(*args, ITERS, OMEGA, BETA, block=block)
    plain = ((lambda: pgs_kernel.solve_lcp_jacobi_plain(*args, ITERS, OMEGA, block=True)) if block
             else (lambda: pgs_kernel.solve_lcp_jacobi_plain(*args, ITERS, OMEGA, BETA)))
    return args, call, plain


def packed_case(dev, B, mp):
    args = chip_smoke.random_lcp(dev, B, mp // 3, chip_smoke.SEED + mp)
    call = lambda: pgs_kernel.solve_lcp_jacobi_packed_stream(*args)
    plain = lambda: pgs_kernel.solve_lcp_jacobi_packed_plain(*args)
    return args, call, plain


CASES = (("B6c", False, False, 64, 672), ("B6c'", False, True, 64, 672),
         ("B6b", True, False, 256, 888), ("B6c", False, False, 64, 1200),
         ("B6c'", False, True, 64, 1200), ("B6b", True, False, 64, 1200))
# Below 664 rows, the shapes whose row sums share the code (the cluster
# forms' stage-read tails): the entry mode times them too.
BELOW = (("B6c", False, False, 4096, 240), ("B6b", True, False, 4096, 192))


def entry(dev, flush) -> list:
    rows = []
    for name, packed, block, B, n in CASES + BELOW:
        args, call, plain = packed_case(dev, B, n) if packed else unfused_case(dev, B, n, block)
        out = call()
        t = jacobi_ms(call, flush)
        clock = sm_clock_mhz()
        p = jacobi_ms_plain(plain, flush)
        rows.append(record(f"{name} n={n} B={B}, entry", t, p, args[0].numel() * 4,
                           chip_smoke.moved_bytes(args, out),
                           describe(packed, B, block, n), clock))
    return rows


def jacobi_ms_plain(plain, flush) -> float:
    return device_window(plain, REPS, flush)["device_ms"]


def forced(dev, flush, name, packed, block, B, n, plans) -> list:
    """Each plan in `plans` timed against the entry's bits."""
    rows = []
    args, call, _ = packed_case(dev, B, n) if packed else unfused_case(dev, B, n, block)
    want = call()
    fn = "eggshell_jacobi_block_f32" if block else "eggshell_jacobi_f32"
    params = (ITERS, OMEGA) if block else (ITERS, OMEGA, BETA)
    for plan in plans:
        if packed:
            run = lambda plan=plan: pgs_kernel.launch_packed_plan(plan, *args)
        else:
            run = lambda plan=plan: pgs_kernel.launch_jacobi_plan(fn, plan, *args[:5], *params)
        got = run()
        torch.cuda.synchronize()
        chip_smoke.check(torch.equal(got, want), f"{name} n={n}: {plan} differs from the entry")
        t = jacobi_ms(run, flush)
        clock = sm_clock_mhz()
        rows.append(record(f"{name} n={n} B={B}", t, None, args[0].numel() * 4,
                           chip_smoke.moved_bytes(args, want),
                           describe(packed, B, block, n, plan), clock))
    return rows


def sizes(dev, flush) -> list:
    rows = []
    for name, packed, block, B, n in CASES + (("B6c", False, False, 64, 1400),):
        plans = []
        if n < 1000:
            for c in range(pgs_kernel.PORTABLE_CLUSTER + 1, pgs_kernel.MAX_CLUSTER + 1):
                p = (pgs_kernel.packed_cluster_plan(n, c) if packed
                     else pgs_kernel.jacobi_cluster_plan(n, block, c))
                if p is not None:
                    plans.append(p)
        for c in ((16,) if n < 1000 else (12, 16)):
            sp = pgs_kernel.streamed_plan(n, block, c)
            if sp is None:
                continue
            for inflight in ((0,) if n < 1000 else (0, 4, 5, 6, 7)):
                s = sp._replace(inflight=inflight)
                if packed:
                    plans.append(s)
                else:
                    plans.append(pgs_kernel.jacobi_streamed_plan(n, block, c)._replace(
                        inflight=inflight))
        rows += forced(dev, flush, name, packed, block, B, n, plans)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("jacobi_wide_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.load()
    flush = l2_flush(dev)
    mode = "sizes" if "--sizes" in sys.argv[1:] else "entry"
    rows = sizes(dev, flush) if mode == "sizes" else entry(dev, flush)
    card = chip_smoke.card_line()
    if "--out" in sys.argv[1:]:
        out = sys.argv[sys.argv.index("--out") + 1]
        os.makedirs(out, exist_ok=True)
        tag = os.environ.get("PROBE_TAG", mode)
        with open(os.path.join(out, f"jacobi_wide_probe_{tag}.json"), "w") as f:
            json.dump({"card": card, "mode": mode, "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
