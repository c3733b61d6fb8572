"""Batched projected-Jacobi LCP solves: the hand-written CUDA kernels and
their wrappers.

- `solve_lcp_jacobi`: counterpart of
  `eggshell_tpu.ops.pgs_kernel.solve_lcp_jacobi_pallas`, with bounds given
  per row.  Scalar heavy-ball sweeps (B6c); with `block=True`,
  `solve_lcp_jacobi_block` (B6c'): exact 3x3 block-Jacobi.  Both in
  `csrc/jacobi.cu`, in the form `jacobi_launch_plan` names: resident (one
  block a scenario's A, rows in registers behind a TMA stage, on a
  persistent grid: `jacobi_kernel`, `block_jacobi_kernel`), cluster (A's
  rows split over a thread-block cluster of up to 8 blocks, or past
  mp = 664 of 9 to 16, read once: `jacobi_cluster_kernel`,
  `block_jacobi_cluster_kernel`), streamed (past what 16 blocks hold, the
  cluster's split with each block streaming its rows every sweep through
  a ring of stages: `jacobi_streamed_kernel`,
  `block_jacobi_streamed_kernel`) or, past what that ring leaves room for
  (6,560 rows), global rows (one block a scenario, A read from device
  memory every sweep: `jacobi_global_kernel`,
  `block_jacobi_global_kernel`, also the tests' reference for the others'
  bits).  All four return the same bits.
- `solve_lcp_jacobi_packed`: counterpart of
  `eggshell_tpu.ops.pgs_kernel.solve_lcp_jacobi_packed`, the fused chain's
  solve, with box or Coulomb-pyramid bounds built from the lane masks.
  Resident (B6), `csrc/jacobi_packed.cu`, A read once by TMA and each
  thread's row held in registers: scalar sweeps with box bounds
  (`jacobi_packed_kernel`), scalar sweeps with pyramid bounds
  (`solve_lcp_jacobi_packed_pyramid`, `jacobi_packed_pyramid_kernel`) or
  3x3 block sweeps with either (`solve_lcp_jacobi_packed_block`,
  `jacobi_packed_block_kernel` and `jacobi_packed_block_pyramid_kernel`).
  Cluster (B6b, scalar sweeps with box bounds only; the JAX package's
  "streamed" solve): `solve_lcp_jacobi_packed_stream`, kernel
  `csrc/jacobi_packed_stream.cu`, which holds one scenario's A across a
  thread-block cluster (up to 8 blocks, 9 to 16 past mp = 664), read
  once, and returns the resident kernel's bits; past what 16 blocks hold
  (mp above 944) it streams each block's rows every sweep
  (`jacobi_packed_streamed_kernel`), and past 6,560 rows it reads them in
  global-rows form (`jacobi_packed_rows_kernel`), with the same bits.
  `packed_launch_plan` picks how both run at a given row count and
  `packed_streams` which of the two the solve takes: the crossing measured
  on the card.  What the solve refuses follows the JAX package's rule
  (`streams_a`).

On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it runs
its plain version.  A CUDA input that the kernel does not take raises;
there is no fallback.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from eggshell_tpu_torch.ops import lcp
from eggshell_tpu_torch.kernels import MAX_SHARED_BYTES
from eggshell_tpu_torch.ops.amat_kernel import ROW_BLOCK, padded_rows, round_rows

# Stand-in for hi = inf, as the TPU kernel has it.
HI_INF = 3.4e38
# The JAX package's switch to the streamed solve (`pgs_kernel.py:343`,
# `:523-524`): the double-buffered A of 128 scenarios over 5 MiB of TPU
# VMEM, i.e. mp >= 72 (K >= 22 lanes, joints counted).  It is a TPU budget:
# the port keeps it only for what the solve refuses (block sweeps and
# pyramid bounds where the JAX package streams), and takes B6 or B6b by
# the crossing measured on the card (`packed_streams`).
_TPU_LANES = 128
_VMEM_A_BUDGET = 5 * 1024 * 1024


def streams_a(mp: int) -> bool:
    """Whether the JAX package's `solve_lcp_jacobi_packed` streams A for mp
    rows: where it does, the port refuses block sweeps and pyramid bounds."""
    return mp * mp * _TPU_LANES * 4 * 2 > _VMEM_A_BUDGET


# The largest mp at which the resident B6 beats the cluster B6b (0.4165
# against 0.5744 ms at mp = 160, 0.7625 against 0.5343 at 168, where B6's
# stage leaves one block an SM), and the largest mp (m rounded up to 8) at
# which B6c / B6c' take their resident form: a row of up to 128 floats in
# registers.  Past that the cluster form holds them (B6c 0.3140 ms against
# 0.3876 for a resident form with rows longer than 128 at mp = 136;
# tools/jacobi_packed_probe.py, tools/jacobi_probe.py, B = 4096, on an
# H100 SXM at 700 W; PERF.md section 6).
PACKED_RESIDENT_MAX_MP = 160
JACOBI_RESIDENT_MAX_MP = 128


def packed_streams(mp: int) -> bool:
    """Whether `solve_lcp_jacobi_packed(stream=None)` takes B6b (the
    cluster, "streamed" in the JAX package's words) for mp rows: past the
    measured crossing, or where B6 does not fit one block."""
    return mp > PACKED_RESIDENT_MAX_MP or packed_launch_plan(mp).resident is None


# Row lengths for which the packed kernels hold a row of A in registers
# (their template instantiations); longer rows are read from shared memory.
REGISTER_ROW_LENGTHS = (32, 64, 96, 128)
# Blocks of a cluster: up to the portable size 8 while 8 blocks hold a
# scenario's rows (mp <= 664), and past that up to Hopper's non-portable 16
# (`cudaFuncAttributeNonPortableClusterSizeAllowed`); a B6b block of the
# portable sizes holds at most CLUSTER_BLOCK_ROWS rows.
PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16
CLUSTER_BLOCK_ROWS = 64
# Past the portable sizes, the cluster sizes in the order the plans try
# them: on the H100, 9 such clusters of 9 blocks fit at once and 7 of any
# size from 10 to 16, so 9 wherever it holds the rows (B6c 0.4254 ms at
# m = 672, B = 64, against 0.5192-0.5253 for 10 to 16), else the largest,
# whose blocks load the fewest rows each (B6b 2.2937 ms at c = 16 against
# 2.4492 at 15, mp = 888, B = 256; tools/jacobi_wide_probe.py --sizes,
# PERF.md section 6).
WIDE_CLUSTERS = (9, 16, 15, 14, 13, 12, 11, 10)
# The largest mp at which the cluster forms of 9 to 16 blocks are taken;
# past it the streamed route.  Their reach: the streamed route measured
# slower at every mp the cluster holds (0.4932 against 0.3838 ms at
# m = 672; 3.2123 against 2.2937 at mp = 888).
JACOBI_CLUSTER_MAX_MP = 944
PACKED_CLUSTER_MAX_MP = 944


class ResidentPlan(NamedTuple):
    """How B6 (`csrc/jacobi_packed.cu`) runs: `threads` a block (one a row),
    `reg_rows` the row length held in registers (0: rows read from shared
    memory), and the dynamic shared memory of its block forms (the scalar
    and pyramid forms take 4 * threads bytes less: no residual vector)."""
    threads: int
    reg_rows: int
    shared_bytes: int


class ClusterPlan(NamedTuple):
    """How B6b (`csrc/jacobi_packed_stream.cu`) runs: `cluster` blocks a
    scenario, `rows` = mp / cluster rows of A a block, `threads` a block,
    `reg_rows` and `shared_bytes` as for B6."""
    cluster: int
    rows: int
    threads: int
    reg_rows: int
    shared_bytes: int


class RowsPlan(NamedTuple):
    """How a "global rows" form runs (`csrc/rows_global.cuh`): one block a
    scenario of `threads` threads, A's rows read from device memory every
    sweep in tiles of `threads` rows by 32 columns, double-buffered, and
    `shared_bytes` of shared memory: the tiles and a few floats a row."""
    threads: int
    shared_bytes: int


class StreamedPlan(NamedTuple):
    """How a streamed form runs (`csrc/rows_stream.cuh`): `cluster` blocks a
    scenario of `rows` rows each (the last block fewer), `threads` a block
    (the rows rounded up to a warp, and the copy warp), a ring of `stages`
    chunks of `chunk` columns, at most `inflight` clusters at once (0: as
    many as fit), and `shared_bytes` of shared memory."""
    cluster: int
    rows: int
    threads: int
    stages: int
    chunk: int
    inflight: int
    shared_bytes: int


class PackedPlan(NamedTuple):
    """`resident` is None where B6 does not fit in one block's shared memory;
    B6b runs on `cluster`, or, past what a cluster of 16 holds (or the
    measured crossing), on `streamed`, or, past what that ring leaves room
    for, on `rows` (exactly one of the three is set)."""
    resident: ResidentPlan | None
    cluster: ClusterPlan | None
    streamed: StreamedPlan | None
    rows: RowsPlan | None


# Threads a block of the global-rows forms, and the columns of their tiles
# (csrc/rows_global.cuh: two tiles of threads x 33 floats).
ROWS_THREADS = 256
_TILE_COLS = 32
# The streamed forms: rows a block at most (512 threads), the chunk
# widths and ring depths tried in this order (the first that fits), and
# the cluster size, measured on the card (PERF.md section 6).  The
# clusters in flight are capped at the most scenarios whose A fits in
# STREAM_L2_BYTES of the 50 MB L2, so that A is read from L2 after the
# first sweep, where that leaves at least STREAM_MIN_INFLIGHT; otherwise as
# many as fit the card run.  At m = 1,200, B = 64 (5.76 MB a scenario):
# 1.3892 ms with 6 in flight (34.6 MB), 1.5336 with 7 (40.3 MB), 1.6201
# with 5; at 1,400 (7.84 MB): 2.0638 with 5 (39.2 MB), 2.4868 with 6,
# 2.6807 uncapped (c = 16; tools/jacobi_wide_probe.py --sizes).
STREAM_MAX_ROWS = 480
STREAM_CHUNKS = (128, 64, 32)
STREAM_STAGES = (4, 3)
STREAM_CLUSTER = 16
STREAM_L2_BYTES = 40_000_000
STREAM_MIN_INFLIGHT = 4


def _streamed_shared_bytes(rows: int, n: int, chunk: int, stages: int, block: bool) -> int:
    """`rows_stream::shared_bytes`: the ring (a stage of more than 256 rows
    filled by boxes of equal rows, a multiple of 8, rounded up), 2 stages +
    2 mbarriers, two iterates and the block form's residuals."""
    boxes = -(-rows // 256)
    box_rows = rows if boxes == 1 else -(-(-(-rows // boxes)) // 8) * 8
    stage = -(-boxes * box_rows * (chunk + 4) * 4 // 128) * 128
    residual = 4 * _warps(rows) if block else 0
    return stages * stage + 8 * (2 * stages + 2) + 8 * _warps(n) + residual


def streamed_plan(n: int, block: bool = False, c: int | None = None) -> StreamedPlan | None:
    """The streamed form at n rows (B6c's m, B6b's mp) over c blocks
    (default STREAM_CLUSTER), or None where that does not fit: every block
    holds a row, at most STREAM_MAX_ROWS (the block form splits at
    multiples of 3), and a ring of at least 3 stages, two iterates and the
    block form's residuals fit a block's shared memory.  The widest chunk
    and then the deepest ring that fit; the clusters in flight capped
    where at least STREAM_MIN_INFLIGHT scenarios' A fit STREAM_L2_BYTES."""
    c = STREAM_CLUSTER if c is None else c
    g = 3 if block else 1
    R = g * -(-n // (g * c))
    if not 1 <= c <= MAX_CLUSTER or (c - 1) * R >= n or R > STREAM_MAX_ROWS:
        return None
    inflight = STREAM_L2_BYTES // (n * n * 4)
    inflight = inflight if inflight >= STREAM_MIN_INFLIGHT else 0
    for chunk in STREAM_CHUNKS:
        for stages in STREAM_STAGES:
            need = _streamed_shared_bytes(R, n, chunk, stages, block)
            if need <= MAX_SHARED_BYTES:
                return StreamedPlan(c, R, _warps(R) + 32, stages, chunk, inflight, need)
    return None


def rows_plan(mp: int, vectors: int) -> RowsPlan:
    """The plan of a global-rows form at mp rows with `vectors` floats a
    row in shared memory.  Raises ValueError where those do not fit one
    block (mp above about 13,700 for the packed solve, whose A is then
    755 MB a scenario)."""
    T = min(ROWS_THREADS, _warps(mp))
    need = (2 * T * (_TILE_COLS + 1) + vectors * mp) * 4
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"mp = {mp}: the global-rows form needs {need} bytes of shared memory a block "
            f"(the iterate and row sums), more than the {MAX_SHARED_BYTES} an H100 block has")
    return RowsPlan(T, need)


def _warps(n: int) -> int:
    return -(-n // 32) * 32


def _stage_shared_bytes(rows: int, mp: int, barriers: int, vectors: int) -> int:
    """A stage of `rows` rows of stride mp + 4 floats rounded up to 128
    bytes, `barriers` bytes of mbarriers and `vectors` floats of iterates
    and residuals (the layouts of csrc/jacobi_packed.cu and
    csrc/jacobi_packed_stream.cu)."""
    return -(-rows * (mp + 4) * 4 // 128) * 128 + barriers + 4 * vectors


@functools.lru_cache(maxsize=None)
def packed_launch_plan(mp: int) -> PackedPlan:
    """The launch plan of the packed Jacobi kernels at mp rows (a multiple
    of 8): row lengths up to 128 held in registers, else read from shared
    memory; B6b's cluster is the smallest c >= 2 that divides mp and leaves
    at most 64 rows a block, else 8; where 8 blocks cannot hold mp / 8
    rows each (mp > 664), `packed_wide_cluster` (9 to 16 blocks, up to
    mp = PACKED_CLUSTER_MAX_MP), then the streamed route, then, past what
    its ring leaves room for, global rows.  Raises ValueError for an mp
    that is not a positive multiple of 8."""
    if mp < ROW_BLOCK or mp % ROW_BLOCK:
        raise ValueError(f"mp = {mp} is not a positive multiple of {ROW_BLOCK}")
    T = _warps(mp)
    reg_rows = T if T in REGISTER_ROW_LENGTHS else 0
    resident = ResidentPlan(T, reg_rows, _stage_shared_bytes(mp, mp, 16, 3 * T))
    if resident.shared_bytes > MAX_SHARED_BYTES:
        resident = None

    c = next((c for c in range(2, PORTABLE_CLUSTER + 1)
              if mp % c == 0 and mp // c <= CLUSTER_BLOCK_ROWS), PORTABLE_CLUSTER)
    R = mp // c
    need = _stage_shared_bytes(R, mp, 32, 2 * T)
    if need <= MAX_SHARED_BYTES:
        return PackedPlan(resident, ClusterPlan(c, R, _warps(R), reg_rows, need), None, None)
    wide = packed_wide_cluster(mp)
    if wide is not None:
        return PackedPlan(resident, wide, None, None)
    streamed = streamed_plan(mp)
    if streamed is not None:
        return PackedPlan(resident, None, streamed, None)
    return PackedPlan(resident, None, None, rows_plan(mp, 3))


def packed_cluster_plan(mp: int, c: int) -> ClusterPlan | None:
    """B6b's cluster of c blocks at mp rows, R = mp / c rounded up (the
    last block fewer), or None where that does not fit: every block holds
    a row, at most 96 (the kernel's launch bound past register rows), and
    its stage, mbarriers and two iterates fit a block."""
    R = -(-mp // c)
    T = _warps(mp)
    reg_rows = T if T in REGISTER_ROW_LENGTHS else 0
    need = _stage_shared_bytes(R, mp, 32, 2 * T)
    if (not 1 <= c <= MAX_CLUSTER or (c - 1) * R >= mp or _warps(R) > (64 if reg_rows else 96)
            or need > MAX_SHARED_BYTES):
        return None
    return ClusterPlan(c, R, _warps(R), reg_rows, need)


def packed_wide_cluster(mp: int) -> ClusterPlan | None:
    """B6b's cluster past the portable sizes, up to mp =
    PACKED_CLUSTER_MAX_MP: the first size of WIDE_CLUSTERS that fits (the
    measured rule), or None."""
    if mp > PACKED_CLUSTER_MAX_MP:
        return None
    return next((p for c in WIDE_CLUSTERS if (p := packed_cluster_plan(mp, c)) is not None),
                None)


class JacobiPlan(NamedTuple):
    """How B6c and B6c' (`csrc/jacobi.cu`) run at m rows (mp = m rounded up
    to 8): `route` "resident" (one block a scenario), "cluster" (`cluster`
    blocks a scenario of at most `rows` rows each) or "global rows" (A's
    rows read from device memory every sweep); `copy`, how an on-chip
    route fills its stage: "tensor map" (one TMA copy, m % 4 == 0 and
    mp + 4 <= 256), "bulk rows" (one bulk copy a row, m % 4 == 0) or
    "element loads" (4-byte `cp.async` by every thread); `reg_rows`, the
    columns of a row held in registers (mp rounded up to a warp, at most
    128: a cluster form's longer row has its tail read from the stage; 0
    for global rows);
    `threads` a block and `shared_bytes` of dynamic shared memory.  Route
    "streamed" (`cluster` blocks of `rows` rows streaming them every sweep)
    copies by "tensor map" (m % 4 == 0) or "element loads", and sets the
    ring, `stages` chunks of `chunk` columns, and `inflight`, the clusters
    at most at once (0: as many as fit)."""
    route: str
    mp: int
    copy: str
    reg_rows: int
    cluster: int
    rows: int
    threads: int
    shared_bytes: int
    stages: int = 0
    chunk: int = 0
    inflight: int = 0


# The C entries' codes of a route and a copy, and the cluster kernels'
# launch bound (`csrc/jacobi.cu`).
JACOBI_ROUTES = {"resident": 0, "cluster": 1, "global rows": 2, "streamed": 3}
JACOBI_COPIES = {"tensor map": 0, "bulk rows": 1, "element loads": 2}
CLUSTER_MAX_THREADS = 96
# A tensor copy's box is at most 256 floats wide; the stage's rows are mp + 4.
_BOX_COLS = 256


def jacobi_copy(m: int) -> str:
    """How an on-chip form of B6c / B6c' fills its stage at m rows: a tensor
    map needs a row stride that is a multiple of 16 bytes and a box of at
    most 256 columns."""
    if m % 4:
        return "element loads"
    return "tensor map" if round_rows(m) + 4 <= _BOX_COLS else "bulk rows"


def jacobi_resident_plan(m: int, block: bool = False) -> JacobiPlan | None:
    """The resident form at m rows, or None past JACOBI_RESIDENT_MAX_MP,
    where a row no longer fits registers.  Shared memory: the stage (m rows
    of stride mp + 4), an mbarrier, two iterates and the block form's
    residual."""
    mp = round_rows(m)
    if mp > JACOBI_RESIDENT_MAX_MP:
        return None
    T = _warps(mp)
    need = _stage_shared_bytes(m, mp, 16, (3 if block else 2) * T)
    return JacobiPlan("resident", mp, jacobi_copy(m), T, 1, m, T, need)


def _register_columns(mp: int) -> int:
    """Columns of a row B6c and B6c' hold in registers at mp rows."""
    return min(_warps(mp), max(REGISTER_ROW_LENGTHS))


def jacobi_cluster_rows(m: int, c: int, block: bool) -> int:
    """Rows a block of a c-block cluster holds: m / c rounded up, to a
    multiple of 3 in the block form, so that no 3-row block straddles two
    blocks (the last block holds fewer)."""
    g = 3 if block else 1
    return g * -(-m // (g * c))


def jacobi_cluster_plan(m: int, block: bool = False, c: int | None = None) -> JacobiPlan | None:
    """The cluster form at m rows, or None where c blocks cannot hold them:
    every block needs at least one row, at most 96 threads, and its stage,
    three mbarriers, two whole iterates and the block form's residual.  By
    default c is the size from 2 to 8 that leaves the fewest idle threads
    over the cluster (c T - m), and of those the largest: the fastest size
    at every m measured (m = 192, 240 and 480, both forms;
    tools/jacobi_probe.py, H100 SXM at 700 W).  Where no portable size
    holds the rows (mp above 664), the first size of WIDE_CLUSTERS that
    does, up to mp = JACOBI_CLUSTER_MAX_MP (the measured rule)."""
    if c is None:
        fits = [p for c in range(2, PORTABLE_CLUSTER + 1)
                if (p := jacobi_cluster_plan(m, block, c))]
        if fits:
            return min(fits, key=lambda p: (p.cluster * p.threads - m, -p.cluster))
        if round_rows(m) > JACOBI_CLUSTER_MAX_MP:
            return None
        return next((p for c in WIDE_CLUSTERS if (p := jacobi_cluster_plan(m, block, c))), None)
    mp = round_rows(m)
    R = jacobi_cluster_rows(m, c, block)
    T = _warps(R)
    need = _stage_shared_bytes(R, mp, 32, 2 * _warps(mp) + (T if block else 0))
    if (not 1 <= c <= MAX_CLUSTER or (c - 1) * R >= m or T > CLUSTER_MAX_THREADS
            or need > MAX_SHARED_BYTES):
        return None
    return JacobiPlan("cluster", mp, jacobi_copy(m), _register_columns(mp), c, R, T, need)


@functools.lru_cache(maxsize=None)
def jacobi_launch_plan(m: int, block: bool = False) -> JacobiPlan:
    """The form of B6c (or with `block`, B6c') at m rows: resident up to
    mp = JACOBI_RESIDENT_MAX_MP, then the cluster (up to 8 blocks while
    they hold the rows, mp 664; then 9 to 16, up to mp = 944 in the
    scalar form and somewhat less in the block form, whose rows split at
    multiples of 3 and which keeps a residual); past that the streamed
    route, and past what its ring leaves room for (6,560 rows; 6,384 in the
    block form), global rows (the block form keeps 5 floats a row on chip,
    the scalar form 3)."""
    if m < 1:
        raise ValueError(f"m = {m}: the solve needs at least one row")
    return (jacobi_resident_plan(m, block) or jacobi_cluster_plan(m, block)
            or jacobi_streamed_plan(m, block) or jacobi_global_plan(m, block))


def jacobi_streamed_plan(m: int, block: bool = False, c: int | None = None) -> JacobiPlan | None:
    """The streamed form at m rows (`streamed_plan`), copying its stages by
    one tensor copy where rows are 16-byte aligned, else by element loads;
    None where it does not fit."""
    sp = streamed_plan(m, block, c)
    if sp is None:
        return None
    return JacobiPlan("streamed", round_rows(m), "element loads" if m % 4 else "tensor map", 0,
                      sp.cluster, sp.rows, sp.threads, sp.shared_bytes, sp.stages, sp.chunk,
                      sp.inflight)


def jacobi_global_plan(m: int, block: bool = False) -> JacobiPlan:
    """The global-rows form at m rows: no stage, `copy` "none".  The launch
    plan takes it only past the streamed form's reach; below that the
    tests force it as the reference for the other forms' bits."""
    mp = round_rows(m)
    rows = rows_plan(mp, 5 if block else 3)
    return JacobiPlan("global rows", mp, "none", 0, 1, 0, rows.threads, rows.shared_bytes)


def solve_lcp_jacobi_plain(A, b, is_eq, lo, hi, iters: int, omega: float,
                           beta: float = 0.0, block: bool = False):
    """Plain torch version of the kernels: rows padded to a multiple of 8
    (unit diagonal, zero rhs, equality), hi = inf replaced by 3.4e38,
    x0 = proj(b), then `iters` heavy-ball sweeps; with `block` (m % 3 == 0)
    `iters` block-Jacobi sweeps x <- proj((1 - omega) x + omega y), y of
    `lcp.block_update`, and `beta` unused.  Returns x (B, m)."""
    B, m = b.shape
    if block and m % 3:
        raise ValueError(f"block-Jacobi needs 3-row constraint blocks, got m = {m}")
    mp = round_rows(m)
    if mp != m:
        pad = mp - m
        A = torch.nn.functional.pad(A, (0, pad, 0, pad))
        unit = torch.cat([torch.zeros(m, dtype=A.dtype, device=A.device),
                          torch.ones(pad, dtype=A.dtype, device=A.device)])
        A = A + torch.diag(unit)
        b = torch.nn.functional.pad(b, (0, pad))
        is_eq = torch.nn.functional.pad(is_eq, (0, pad), value=True)
        lo = torch.nn.functional.pad(lo, (0, pad))
        hi = torch.nn.functional.pad(hi, (0, pad))
    hi = torch.where(torch.isinf(hi), torch.full_like(hi, HI_INF), hi)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    inv_diag = 1.0 / diag
    x = lcp.project(b, is_eq, lo, hi)
    if block:
        Bc = lcp.block_rows(A, m)
        for _ in range(iters):
            y = lcp.block_update(A, b, x, Bc, inv_diag, m)
            x = lcp.project((1.0 - omega) * x + omega * y, is_eq, lo, hi)
        return x[:, :m]
    xp = x
    for _ in range(iters):
        x, xp = lcp.jacobi_momentum_sweep(A, b, diag, inv_diag, x, xp, is_eq,
                                          lo, hi, omega, beta)
    return x[:, :m]


def _check_lcp_args(A, b, is_eq, lo, hi):
    from eggshell_tpu_torch import kernels

    B, m = b.shape
    for name, x, shape, dtype in (
        ("A", A, (B, m, m), torch.float32), ("b", b, (B, m), torch.float32),
        ("is_eq", is_eq, (B, m), torch.bool), ("lo", lo, (B, m), torch.float32),
        ("hi", hi, (B, m), torch.float32),
    ):
        kernels.check_arg(name, x, shape, dtype, A.device)


def launch_jacobi_plan(fn_name, plan: JacobiPlan, A, b, is_eq, lo, hi, *params):
    """Launch B6c or B6c' (`fn_name`) in the form `plan` names, which need
    not be the one `jacobi_launch_plan` picks, and return x (B, m)."""
    from eggshell_tpu_torch import kernels

    _check_lcp_args(A, b, is_eq, lo, hi)
    if plan.copy in ("tensor map", "bulk rows") and A.data_ptr() % 16:
        raise ValueError("A must be 16-byte aligned: its rows are copied by TMA")
    B, m = b.shape
    out = torch.empty((B, m), dtype=torch.float32, device=A.device)
    kernels.launch(fn_name, A.device, A, b, is_eq, lo, hi, out, B, m, plan.mp, *params,
                   JACOBI_ROUTES[plan.route], JACOBI_COPIES.get(plan.copy, -1), plan.reg_rows,
                   plan.cluster, plan.rows, plan.threads, plan.stages, plan.chunk, plan.inflight)
    return out


def solve_lcp_jacobi_block(A, b, is_eq, lo, hi, iters: int, omega: float):
    """B6c': batched exact 3x3 block-Jacobi, x <- proj((1 - omega) x +
    omega y) with y from every constraint block's exact solve (no
    momentum); A (B, m, m) with m % 3 == 0, b / lo / hi (B, m), is_eq
    (B, m) bool -> x (B, m)."""
    m = b.shape[-1]
    if m % 3:
        raise ValueError(f"block-Jacobi needs 3-row constraint blocks, got m = {m}")
    if A.device.type == "cpu":
        return solve_lcp_jacobi_plain(A, b, is_eq, lo, hi, iters, omega, block=True)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    out = launch_jacobi_plan("eggshell_jacobi_block_f32", jacobi_launch_plan(m, True), A, b,
                             is_eq, lo, hi, int(iters), float(omega))
    solve_lcp_jacobi_block.launches += 1
    return out


solve_lcp_jacobi_block.launches = 0


def solve_lcp_jacobi(A, b, is_eq, lo, hi, iters: int, omega: float,
                     beta: float = 0.0, block: bool = False):
    """Batched under-relaxed heavy-ball projected Jacobi:
    A (B, m, m), b / lo / hi (B, m), is_eq (B, m) bool -> x (B, m).
    `block=True` (m % 3 == 0) goes to `solve_lcp_jacobi_block`, which has no
    momentum: `beta` is ignored there, as the JAX package's kernel does."""
    if block:
        return solve_lcp_jacobi_block(A, b, is_eq, lo, hi, iters, omega)
    if A.device.type == "cpu":
        return solve_lcp_jacobi_plain(A, b, is_eq, lo, hi, iters, omega, beta)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    out = launch_jacobi_plan("eggshell_jacobi_f32", jacobi_launch_plan(b.shape[-1]), A, b, is_eq,
                             lo, hi, int(iters), float(omega), float(beta))
    solve_lcp_jacobi.launches += 1
    return out


solve_lcp_jacobi.launches = 0


def _packed_bounds(act, eq, K: int, mp: int, mu: float, dtype):
    """Per-row (active, lo, hi), each (B, mp), of the fused chain's LCP:
    equality lanes free, tangential rows (row % 3 < 2) in [-mu, mu], normal
    rows in [0, 3.4e38]; inactive lanes and padding rows inactive."""
    B = act.shape[0]
    dev = act.device
    m = 3 * K
    pad = mp - m
    active = torch.nn.functional.pad(act.repeat_interleave(3, dim=1), (0, pad))
    tangential = (torch.arange(m, device=dev) % 3 < 2).expand(B, m)
    lo = torch.where(tangential, torch.full((), -mu, dtype=dtype, device=dev),
                     torch.zeros((), dtype=dtype, device=dev))
    hi = torch.where(tangential, torch.full((), mu, dtype=dtype, device=dev),
                     torch.full((), HI_INF, dtype=dtype, device=dev))
    if eq is not None:
        eq3 = eq.repeat_interleave(3, dim=1)
        lo = torch.where(eq3, torch.full((), -HI_INF, dtype=dtype, device=dev), lo)
        hi = torch.where(eq3, torch.full((), HI_INF, dtype=dtype, device=dev), hi)
    lo = torch.nn.functional.pad(lo, (0, pad))
    hi = torch.nn.functional.pad(hi, (0, pad))
    return active, lo, hi


def solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                                  omega: float, beta: float, block: bool = False,
                                  pyramid_mu: float = 0.0):
    """Plain torch version of the kernels.  A (B, mp, mp) with its diagonal
    diag (B, mp), rhs (B, 3K), act (B, K) bool, eq None or (B, K) bool.
    x0 = proj(b), then `iters` sweeps
    x <- proj((1 - omega) x + omega y + beta (x - x_prev)): scalar,
    y = (b - A x + D x) / D, or with `block`, y of `lcp.block_update`.
    With pyramid_mu > 0, x0 pins the tangential rows of non-equality lanes
    to 0 and every sweep bounds them by +-pyramid_mu * max(x_n, 0) of the
    pre-sweep iterate, x_n their lane's normal row (`lcp._bounds`).
    Returns x (B, mp)."""
    B, mp = diag.shape
    m3 = 3 * K
    pyramid = pyramid_mu > 0.0
    active, lo, hi = _packed_bounds(act, eq, K, mp, 0.0 if pyramid else mu, A.dtype)
    b = torch.nn.functional.pad(rhs, (0, mp - m3))
    not_eq = torch.zeros_like(active)
    couple = None
    if pyramid:
        row = torch.arange(mp, device=A.device)
        coupled = ((row < m3) & (row % 3 < 2)).expand(B, mp)
        if eq is not None:
            coupled = coupled & ~torch.nn.functional.pad(eq.repeat_interleave(3, dim=1),
                                                         (0, mp - m3))
        couple = torch.where(coupled, 3 * (row // 3) + 2, -1)

    def proj(x, lo_, hi_):
        return torch.where(active, lcp.project(x, not_eq, lo_, hi_), x)

    inv_diag = 1.0 / diag
    Bc = lcp.block_rows(A, m3) if block else None
    x = proj(b, lo, hi)
    xp = x
    for _ in range(iters):
        if block:
            y = lcp.block_update(A, b, x, Bc, inv_diag, m3)
            xn = (1.0 - omega) * x + omega * y + beta * (x - xp)
        else:
            r = b - torch.einsum("bij,bj->bi", A, x) + diag * x
            xn = (1.0 - omega) * x + omega * r * inv_diag + beta * (x - xp)
        x, xp = proj(xn, *lcp._bounds(x, lo, hi, couple, pyramid_mu)), x
    return x


def _check_packed_args(A, diag, rhs, act, eq, K: int) -> None:
    from eggshell_tpu_torch import kernels

    B, mp = diag.shape
    if mp != padded_rows(K):
        raise ValueError(f"diag has {mp} rows, expected 3K = {3 * K} rounded up to {ROW_BLOCK}")
    args = [("A", A, (B, mp, mp), torch.float32), ("diag", diag, (B, mp), torch.float32),
            ("rhs", rhs, (B, 3 * K), torch.float32), ("act", act, (B, K), torch.bool)]
    if eq is not None:
        args.append(("eq", eq, (B, K), torch.bool))
    for name, x, shape, dtype in args:
        kernels.check_arg(name, x, shape, dtype, A.device)
    if A.data_ptr() % 16:
        raise ValueError("A must be 16-byte aligned: its rows are copied by TMA")


def _launch_packed(fn_name, A, diag, rhs, act, eq, K, mu, iters, omega, beta, pyramid_mu):
    """Launch one resident B6 variant `fn_name` and return x (B, mp)."""
    from eggshell_tpu_torch import kernels

    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    _check_packed_args(A, diag, rhs, act, eq, K)
    B, mp = diag.shape
    plan = packed_launch_plan(mp).resident
    if plan is None:
        raise ValueError(f"K = {K}: the resident solve does not fit one block at mp = {mp}")
    out = torch.empty((B, mp), dtype=torch.float32, device=A.device)
    kernels.launch(fn_name, A.device, A, diag, rhs, act, eq, out, B, K, mp, int(iters),
                   float(mu), float(omega), float(beta), float(pyramid_mu), plan.reg_rows)
    return out


def launch_packed_plan(plan, A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                       omega: float, beta: float):
    """Launch B6b in the form `plan` names (a ClusterPlan, StreamedPlan or
    RowsPlan), which need not be the one `packed_launch_plan` picks, and
    return x (B, mp)."""
    from eggshell_tpu_torch import kernels

    _check_packed_args(A, diag, rhs, act, eq, K)
    B, mp = diag.shape
    out = torch.empty((B, mp), dtype=torch.float32, device=A.device)
    head = (A.device, A, diag, rhs, act, eq, out, B, K, mp, int(iters), float(mu), float(omega),
            float(beta))
    if isinstance(plan, ClusterPlan):
        kernels.launch("eggshell_jacobi_packed_stream_f32", *head, plan.reg_rows, plan.cluster,
                       plan.rows)
    elif isinstance(plan, StreamedPlan):
        kernels.launch("eggshell_jacobi_packed_streamed_f32", *head, plan.cluster, plan.rows,
                       plan.threads, plan.stages, plan.chunk, plan.inflight)
    else:
        kernels.launch("eggshell_jacobi_packed_rows_f32", *head, plan.threads)
    return out


def solve_lcp_jacobi_packed_stream(A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                                   omega: float, beta: float):
    """B6b: x (B, mp) of the fused chain's LCP with A held across a cluster
    of blocks (the JAX package streams it), or, where the plan has no
    cluster, its rows streamed from device memory every sweep (the
    streamed route, or past it global rows); the arguments and the plain
    version are those of `solve_lcp_jacobi_packed_plain` (box friction,
    scalar sweeps)."""
    if A.device.type == "cpu":
        return solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K, mu, iters, omega, beta)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    plan = packed_launch_plan(diag.shape[1])
    out = launch_packed_plan(plan.cluster or plan.streamed or plan.rows, A, diag, rhs, act, eq, K,
                             mu, iters, omega, beta)
    solve_lcp_jacobi_packed_stream.launches += 1
    return out


solve_lcp_jacobi_packed_stream.launches = 0


def solve_lcp_jacobi_packed_block(A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                                  omega: float, beta: float, pyramid_mu: float = 0.0):
    """B6 with `block=True`, resident A: 3x3 block sweeps, box bounds, or
    pyramid bounds for pyramid_mu > 0; see `solve_lcp_jacobi_packed_plain`."""
    if A.device.type == "cpu":
        return solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K, mu, iters, omega, beta,
                                             True, pyramid_mu)
    out = _launch_packed("eggshell_jacobi_packed_block_f32", A, diag, rhs, act, eq, K, mu, iters,
                         omega, beta, pyramid_mu)
    solve_lcp_jacobi_packed_block.launches += 1
    return out


solve_lcp_jacobi_packed_block.launches = 0


def solve_lcp_jacobi_packed_pyramid(A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                                    omega: float, beta: float, pyramid_mu: float):
    """B6 with pyramid_mu > 0 and scalar sweeps, resident A; see
    `solve_lcp_jacobi_packed_plain`."""
    if not pyramid_mu > 0.0:
        raise ValueError(f"pyramid_mu must be positive, got {pyramid_mu}")
    if A.device.type == "cpu":
        return solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K, mu, iters, omega, beta,
                                             False, pyramid_mu)
    out = _launch_packed("eggshell_jacobi_packed_pyramid_f32", A, diag, rhs, act, eq, K, mu,
                         iters, omega, beta, pyramid_mu)
    solve_lcp_jacobi_packed_pyramid.launches += 1
    return out


solve_lcp_jacobi_packed_pyramid.launches = 0


def solve_lcp_jacobi_packed(A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                            omega: float, beta: float, block: bool = False,
                            pyramid_mu: float = 0.0, stream=None):
    """x (B, mp) of the fused chain's LCP; see `solve_lcp_jacobi_packed_plain`
    for the arguments.  `stream` None takes the card's rule
    (`packed_streams`) and refuses `block=True` and `pyramid_mu > 0` where
    the JAX package streams (`streams_a`); True goes to
    `solve_lcp_jacobi_packed_stream` and refuses them too.  Resident,
    `block` goes to `solve_lcp_jacobi_packed_block` and pyramid_mu > 0
    alone to `solve_lcp_jacobi_packed_pyramid`; this function launches the
    scalar box-bounds kernel itself."""
    refuse = stream
    if stream is None:
        mp = padded_rows(K)
        refuse, stream = streams_a(mp), packed_streams(mp)
    if refuse:
        if block:
            raise ValueError(
                "solve_lcp_jacobi_packed: block-Jacobi (jacobi_block=True) is not available on "
                f"the streamed-A path (contact capacity {K}); use jacobi_block=False or reduce "
                "contact_capacity")
        if pyramid_mu > 0.0:
            raise ValueError(
                "solve_lcp_jacobi_packed: COULOMB_PYRAMID bounds are not available on the "
                "streamed-A path; reduce contact_capacity below the stream threshold")
    if stream:
        return solve_lcp_jacobi_packed_stream(A, diag, rhs, act, eq, K, mu, iters, omega, beta)
    if block:
        return solve_lcp_jacobi_packed_block(A, diag, rhs, act, eq, K, mu, iters, omega, beta,
                                             pyramid_mu)
    if pyramid_mu > 0.0:
        return solve_lcp_jacobi_packed_pyramid(A, diag, rhs, act, eq, K, mu, iters, omega, beta,
                                               pyramid_mu)
    if A.device.type == "cpu":
        return solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K, mu, iters, omega, beta)
    out = _launch_packed("eggshell_jacobi_packed_f32", A, diag, rhs, act, eq, K, mu, iters, omega,
                         beta, 0.0)
    solve_lcp_jacobi_packed.launches += 1
    return out


solve_lcp_jacobi_packed.launches = 0
