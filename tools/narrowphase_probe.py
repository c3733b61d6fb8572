#!/usr/bin/env python3
"""Device time of the SAT narrowphase kernels B2p and B2 on the card.

    python tools/narrowphase_probe.py                  # through the entries
    python tools/narrowphase_probe.py --lanes 2 4 8 16 # at other group sizes

B2p (`collide_boxes_lanes_packed`) on the first-step inputs of the bench
step (box_stack4, B = 4096, 24,576 pairs), box_stack8 (114,688 pairs) and
living_room (61,440 pairs), and B2 (`collide_boxes_lanes`) on the unfused
slice's first-step pairs (N = 24,576).

Without arguments each case goes through its entry: the time is that of
every kernel whose name holds "narrowphase", whatever kernel the package in
this checkout launches, so the script times an older tree of the repo the
same way when copied into it (the parent comparison).  Where the
checkout's build reports them, the registers ptxas gave each narrowphase
kernel are printed too.

With --lanes: `csrc/narrowphase.cu` is built alone once for each group size
G named (its EGGSHELL_NARROWPHASE_LANES; the package builds only the
default), all at once, into the package's build directory, and each case
is launched through that library's C entries at G lanes a pair.  Every G
must return the entry's bits; prints each G's time and registers.  These
are the measurements behind the default.

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
from eggshell_tpu_torch.ops import collision_kernel as ck  # noqa: E402
from eggshell_tpu_torch.utils.profiling import device_window, l2_flush  # noqa: E402

REPS = 20
SCENES = ("box_stack4", "box_stack8", "living_room")


def narrowphase_ms(call, flush) -> float:
    """Device ms a call of the kernels named *narrowphase* inside call()."""
    w = device_window(call, REPS, flush)
    return sum(ms for name, (ms, _) in w["by_name"].items() if "narrowphase" in name)


def cases(dev):
    """(what, packed, args): B2p on each scene's first step, B2 on the
    unfused slice's."""
    out = [(f"B2p {name} first step", True, chip_smoke.fused_inputs(dev, name)["narrowphase"])
           for name in SCENES]
    return out + [("B2 unfused slice first step", False, chip_smoke.main_path_inputs(dev)[0])]


def pairs_of(packed, args) -> int:
    return args[0].shape[0] * (args[3].shape[0] if packed else 1)


def build_lanes(group_sizes) -> dict:
    """G -> (ctypes library of `csrc/narrowphase.cu` built at G lanes a
    pair, its registers by kernel), one nvcc each, all started together."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in kernels.COMPILE_FLAGS if f != "-c"]
    procs = {}
    for G in group_sizes:
        so = kernels.BUILD_DIR / f"narrowphase_lanes{G}.so"
        procs[G] = (so, subprocess.Popen(
            [kernels._nvcc(), *flags, "-shared", f"-DEGGSHELL_NARROWPHASE_LANES={G}", "-o",
             str(so), str(kernels.CSRC / "narrowphase.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for G, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc at {G} lanes a pair failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for name in ("eggshell_narrowphase_f32", "eggshell_narrowphase_packed_f32"):
            getattr(lib, name).argtypes = kernels._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        regs = {}
        for name, use in kernels.parse_ptxas(log).items():
            m = re.search(r"(?<=\d)(narrowphase(?:_packed)?_kernel)ILi", name)
            if m:
                regs[m.group(1)] = use.get("registers")
        out[G] = (lib, regs)
    return out


def launch_at(lib, G, packed, args):
    """The entry's outputs, computed by `lib` at G lanes a pair."""
    N = pairs_of(packed, args)
    pairs = ck.NARROWPHASE_THREADS // G
    plan = (G, ck.NARROWPHASE_THREADS, -(-N // pairs), pairs * ck.GROUP_BYTES)
    dev = args[0].device
    f32 = dict(dtype=torch.float32, device=dev)
    lead = (args[0].shape[0], args[3].shape[0]) if packed else (N,)
    pos, nrm = torch.empty(lead + (12, 3), **f32), torch.empty(lead + (3,), **f32)
    dep = torch.empty(lead + (12,), **f32)
    act = torch.empty(lead + (12,), dtype=torch.bool, device=dev)
    if packed:
        p, q, hs, pi, pj = args
        outs = (pos, nrm, dep, act)
        raw = (p, q, hs, pi, pj, *outs, p.shape[0], p.shape[1], pi.shape[0], *plan)
        fn = lib.eggshell_narrowphase_packed_f32
    else:
        code = torch.empty((N,), dtype=torch.int32, device=dev)
        idep, iax = torch.empty((N,), **f32), torch.empty((N, 3), **f32)
        outs = (pos, nrm, dep, act, code, idep, iax)
        raw = (*args, *outs, N, *plan)
        fn = lib.eggshell_narrowphase_f32
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in raw],
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"narrowphase at {G} lanes a pair refused: {err}")
    return outs


def entry_outputs(packed, args):
    if packed:
        return ck.collide_boxes_lanes_packed(*args)
    o = ck.collide_boxes_lanes(*args)
    return (o.position, o.normal[:, 0], o.depth, o.active, o.code, o.info_depth,
            o.separating_axis)


def group_sizes(dev, flush, sizes) -> None:
    libs = build_lanes(sizes)
    for what, packed, args in cases(dev):
        want = entry_outputs(packed, args)
        line = [f"{what} ({pairs_of(packed, args)} pairs):"]
        for G, (lib, regs) in libs.items():
            same = all(torch.equal(a, b) for a, b in zip(launch_at(lib, G, packed, args), want))
            chip_smoke.check(same, f"{what}: {G} lanes a pair differ from the entry")
            t = narrowphase_ms(lambda: launch_at(lib, G, packed, args), flush)
            kernel = "narrowphase_packed_kernel" if packed else "narrowphase_kernel"
            line.append(f"G={G} {t:.4f} ms ({regs.get(kernel, '?')} registers);")
        line.append(f"the entry's G={ck.LANES_PER_PAIR}")
        print(" ".join(line), flush=True)


def entries(dev, flush) -> None:
    for what, packed, args in cases(dev):
        fn = ck.collide_boxes_lanes_packed if packed else ck.collide_boxes_lanes
        t = narrowphase_ms(lambda: fn(*args), flush)
        print(f"{what} ({pairs_of(packed, args)} pairs), through the entry: {t:.4f} ms",
              flush=True)
    usage = getattr(kernels, "ptxas_usage", dict)()
    regs = {name: u.get("registers") for name, u in sorted(usage.items()) if "narrowphase" in name}
    print(f"registers: {regs if regs else 'not reported by this build'}")


def main() -> int:
    if not torch.cuda.is_available():
        print("narrowphase_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.load()
    flush = l2_flush(dev)
    argv = sys.argv[1:]
    if argv[:1] == ["--lanes"]:
        group_sizes(dev, flush, [int(a) for a in argv[1:]] or [2, 4, 8, 16])
    else:
        entries(dev, flush)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
