"""The launch plans of the Jacobi kernels (B6, B6b, B6c, B6c') and of the
A-formation kernel B5, on the CPU.

`packed_launch_plan(mp)` picks how the CUDA kernels of
`csrc/jacobi_packed.cu` and `csrc/jacobi_packed_stream.cu` run and
`packed_streams(mp)` which of the two the fused solve takes,
`jacobi_launch_plan(m)` the form of `csrc/jacobi.cu`, `amat_launch_plan(K)`
the tiles of `csrc/amat.cu`; the kernels refuse a plan they do not take.
These checks need no card.
"""

import pytest

from eggshell_tpu_torch.ops.amat_kernel import (AMAT_THREADS,
                                                MAX_SHARED_BYTES as AMAT_MAX_SHARED,
                                                amat_launch_plan, amat_shared_bytes, padded_rows)
from eggshell_tpu_torch.ops.pgs_kernel import (JACOBI_CLUSTER_MAX_MP, JACOBI_RESIDENT_MAX_MP,
                                               MAX_CLUSTER, MAX_SHARED_BYTES,
                                               PACKED_CLUSTER_MAX_MP, PACKED_RESIDENT_MAX_MP,
                                               PORTABLE_CLUSTER, REGISTER_ROW_LENGTHS,
                                               STREAM_MAX_ROWS, jacobi_cluster_plan,
                                               jacobi_launch_plan, packed_launch_plan,
                                               packed_streams, streams_a)
from torch_limits import time_limit  # noqa: F401

# The largest mp of each kernel: B6 holds a scenario's A in one block;
# B6b spreads it over at most 8 blocks up to CLUSTER_LIMIT, over 9 to 16
# up to WIDE_LIMIT, and past that streams each block's rows every sweep,
# up to STREAM_LIMIT; past that global rows.
RESIDENT_LIMIT, CLUSTER_LIMIT, WIDE_LIMIT, STREAM_LIMIT = 232, 664, 944, 6560
# The fused chain's lanes: past K = 1,608, where 4 scenarios' compaction
# stages (9K words and a drop mask each) pass 232,448 bytes and the
# compaction kernel's blocks take fewer, with room for joint lanes.
FUSED_MAX_K = 2048


def _first_design_bytes(mp: int) -> int:
    """Shared memory of the first design of B6 and B6c: A with a row stride
    of mp + 1 floats, the iterate and the block sweeps' residual."""
    return (mp * (mp + 1) + 2 * mp) * 4


def test_every_row_count_up_to_the_limit_gets_a_plan():
    for mp in range(8, CLUSTER_LIMIT + 1, 8):
        plan = packed_launch_plan(mp)
        assert (plan.resident is not None) == (mp <= RESIDENT_LIMIT), mp
    # every mp the first design of B6 took (A with a row stride of mp + 1)
    first = [mp for mp in range(8, 1024, 8) if _first_design_bytes(mp) <= MAX_SHARED_BYTES]
    assert max(first) == RESIDENT_LIMIT
    assert all(packed_launch_plan(mp).resident is not None for mp in first)


def test_rows_are_held_in_registers_exactly_up_to_the_instantiated_lengths():
    for mp in range(8, WIDE_LIMIT + 1, 8):
        plan = packed_launch_plan(mp)
        warp_rows = -(-mp // 32) * 32
        want = warp_rows if warp_rows <= max(REGISTER_ROW_LENGTHS) else 0
        assert want == 0 or want in REGISTER_ROW_LENGTHS
        assert plan.cluster.reg_rows == want, mp
        if plan.resident is not None:
            r = plan.resident
            assert (r.reg_rows, r.threads) == (want, warp_rows), mp
            assert r.shared_bytes <= MAX_SHARED_BYTES


def test_cluster_size_and_rows_a_block_fit():
    for mp in range(8, CLUSTER_LIMIT + 1, 8):
        c = packed_launch_plan(mp).cluster
        assert 2 <= c.cluster <= PORTABLE_CLUSTER and mp % c.cluster == 0, mp
        assert c.rows * c.cluster == mp and c.rows <= c.threads and c.threads % 32 == 0, mp
        assert c.shared_bytes <= MAX_SHARED_BYTES, mp
    # the fewest blocks of at most 64 rows each
    assert [packed_launch_plan(mp).cluster.cluster for mp in (64, 96, 136, 192)] == [2, 2, 4, 3]
    # past the portable sizes, 9 to 16 blocks of mp / c rows rounded up, the
    # last block fewer: 9 where they hold the rows (9 such clusters fit the
    # H100 at once, 7 of 10 to 16), else 16; at mp = 888 at least 15 blocks
    # (14 of 64 rows pass 232,448 bytes)
    for mp in range(CLUSTER_LIMIT + 8, WIDE_LIMIT + 1, 8):
        c = packed_launch_plan(mp).cluster
        assert PORTABLE_CLUSTER < c.cluster <= MAX_CLUSTER, mp
        assert c.cluster * c.rows >= mp > (c.cluster - 1) * c.rows, mp   # every block a row
        assert c.rows <= c.threads <= 96 and c.threads % 32 == 0, mp
        assert c.shared_bytes <= MAX_SHARED_BYTES and c.reg_rows == 0, mp
    assert [packed_launch_plan(mp).cluster.cluster for mp in (672, 704, 712, 888)] == [9, 9, 16, 16]
    c = packed_launch_plan(888).cluster
    assert c.rows * c.cluster > 888 > c.rows * (c.cluster - 1)   # a shorter last block


@pytest.mark.parametrize("mp", [0, 12, 100, 676, 1028])
def test_row_counts_past_the_limit_or_off_the_row_block_raise(mp):
    # past the cluster's limit, B6b reads its rows from device memory
    # (test_the_packed_solve_takes_every_multiple_of_8): only an mp off the
    # row block raises
    with pytest.raises(ValueError):
        packed_launch_plan(mp)


def test_the_packed_solve_takes_every_multiple_of_8():
    """Exactly one route a row count: the cluster up to its reach (or the
    measured crossing), then the streamed route, whose blocks each hold a
    row, at most 256, behind a ring of at least 3 stages; global rows only
    past what that ring leaves room for."""
    for mp in list(range(8, 2048 + 1, 8)) + [STREAM_LIMIT, STREAM_LIMIT + 8]:
        plan = packed_launch_plan(mp)
        assert sum(p is not None for p in (plan.cluster, plan.streamed, plan.rows)) == 1, mp
        assert (plan.cluster is None) == (mp > min(WIDE_LIMIT, PACKED_CLUSTER_MAX_MP)), mp
        assert (plan.rows is not None) == (mp > STREAM_LIMIT), mp
        if plan.rows is not None:
            assert plan.rows.threads % 32 == 0 and plan.rows.threads <= 1024, mp
            assert plan.rows.shared_bytes <= MAX_SHARED_BYTES, mp
        if plan.streamed is not None:
            s = plan.streamed
            assert 1 <= s.cluster <= MAX_CLUSTER, mp
            assert s.cluster * s.rows >= mp > (s.cluster - 1) * s.rows, mp
            assert s.rows <= STREAM_MAX_ROWS and s.threads == -(-s.rows // 32) * 32 + 32, mp
            assert s.stages >= 3 and s.chunk in (32, 64, 128), mp
            assert s.shared_bytes <= MAX_SHARED_BYTES, mp
    assert packed_launch_plan(664).cluster.cluster == 8
    assert packed_launch_plan(672).cluster.cluster > 8
    assert packed_launch_plan(1200).streamed is not None


@pytest.mark.parametrize("m,block,route,copy", [
    (30, False, "resident", "element loads"), (30, True, "resident", "element loads"),
    (60, False, "resident", "tensor map"), (60, True, "resident", "tensor map"),
    (128, False, "resident", "tensor map"), (129, True, "cluster", "element loads"),
    (136, False, "cluster", "tensor map"), (232, False, "cluster", "tensor map"),
    (228, True, "cluster", "tensor map"), (240, False, "cluster", "tensor map"),
    (240, True, "cluster", "tensor map"), (480, True, "cluster", "bulk rows"),
    (664, False, "cluster", "bulk rows"), (672, False, "cluster", "bulk rows"),
    (672, True, "cluster", "bulk rows"), (1200, False, "streamed", "tensor map"),
    (1200, True, "streamed", "tensor map"), (1203, True, "streamed", "element loads"),
    (6625, False, "global rows", "none"),
])
def test_the_unfused_solve_takes_its_route_by_row_count(m, block, route, copy):
    """The joints slice's m = 30 copies its rows by element loads (m % 4 !=
    0), the unfused slice's m = 60 by one tensor copy; the cluster takes
    over past 128 rows and rows wider than a tensor box (mp + 4 > 256)
    arrive one bulk copy a row; past what 8 blocks hold (m = 672, the
    unfused slice at contact_capacity 224), a cluster of 9 to 16; past what
    16 hold (m = 1,200), the streamed route, a tensor copy a stage or, for
    m % 4 != 0, element loads; past 6,560 rows, global rows."""
    plan = jacobi_launch_plan(m, block)
    assert (plan.route, plan.copy) == (route, copy)
    assert plan.mp == -(-m // 8) * 8
    assert plan.shared_bytes <= MAX_SHARED_BYTES
    if route in ("cluster", "streamed"):
        assert plan.cluster * plan.rows >= m > (plan.cluster - 1) * plan.rows
        assert plan.cluster <= (PORTABLE_CLUSTER if m <= CLUSTER_LIMIT else MAX_CLUSTER)


def test_the_unfused_solve_takes_every_row_count_up_to_2048():
    """For every m from 1 to 2048 and both forms: the route (resident up
    to mp = 128, the cluster while 8 blocks hold the rows, then 9 to 16
    blocks, then the streamed route), the copy by m % 4, shared memory that
    fits, and a split in which every block holds a row and, in the block
    form, no 3-row block straddles two blocks."""
    last_cluster = {}
    for block in (False, True):
        for m in range(3 if block else 1, 2049, 3 if block else 1):
            plan = jacobi_launch_plan(m, block)
            mp = -(-m // 8) * 8
            assert plan.mp == mp and plan.shared_bytes <= MAX_SHARED_BYTES, m
            assert (plan.route == "resident") == (mp <= 128), m
            assert plan.route != "global rows", m
            c, R = plan.cluster, plan.rows
            if plan.route == "streamed":
                # only past what a cluster holds, or the measured crossing
                assert jacobi_cluster_plan(m, block) is None, m
                assert (mp > JACOBI_CLUSTER_MAX_MP
                        or all(jacobi_cluster_plan(m, block, k) is None
                               for k in range(2, MAX_CLUSTER + 1))), m
                assert plan.copy == ("element loads" if m % 4 else "tensor map"), m
                assert 1 <= c <= MAX_CLUSTER and c * R >= m > (c - 1) * R, m
                assert R <= STREAM_MAX_ROWS and plan.threads == -(-R // 32) * 32 + 32, m
                assert plan.stages >= 3 and plan.chunk in (32, 64, 128), m
                if block:
                    assert R % 3 == 0, m
                continue
            want = ("element loads" if m % 4 else
                    "tensor map" if mp + 4 <= 256 else "bulk rows")
            assert plan.copy == want, m
            # a row's first 128 columns at most in registers, the tail in the stage
            assert plan.reg_rows == min(-(-mp // 32) * 32, 128), m
            if plan.route == "resident":
                assert (plan.rows, plan.threads) == (m, -(-mp // 32) * 32), m
                continue
            last_cluster[block] = m
            assert 2 <= c <= (PORTABLE_CLUSTER if mp <= CLUSTER_LIMIT else MAX_CLUSTER), m
            assert c * R >= m > (c - 1) * R, m
            assert plan.threads % 32 == 0 and R <= plan.threads <= 96, m
            if block:
                # block k's rows 3k..3k+2 lie in the block of rank 3k // R
                assert R % 3 == 0, m
                assert all((3 * k) // R == (3 * k + 2) // R for k in range(m // 3)), m
    # 16 blocks hold rows up to mp = 944 (m = 927 in the block form, whose
    # rows split at multiples of 3 and which keeps a residual)
    assert last_cluster == {False: min(944, JACOBI_CLUSTER_MAX_MP),
                            True: min(927, JACOBI_CLUSTER_MAX_MP)}


@pytest.mark.parametrize("mp,stream,refused", [
    (32, False, False), (64, False, False), (72, False, True), (96, False, True),
    (160, False, True), (168, True, True), (192, True, True), (672, True, True),
])
def test_the_packed_solve_takes_its_route_by_row_count(mp, stream, refused):
    """The fused solve takes B6 up to mp = 160 and B6b past it (every
    scene's mp, 32 to 96, on B6; box_stack8 at contact_capacity 64, mp =
    192, on B6b); what it refuses, block sweeps and pyramid bounds, still
    follows the JAX package's rule, mp >= 72."""
    assert packed_streams(mp) == stream == (mp > PACKED_RESIDENT_MAX_MP)
    assert streams_a(mp) == refused
    assert (packed_launch_plan(mp).resident is None) <= stream


def test_the_resident_unfused_form_holds_its_rows_in_registers():
    """The resident form of B6c and B6c' holds every row whole in registers
    (the kernel has no stage-read tail): it stops at the longest register
    row, and past it the cluster takes every m of both forms."""
    assert JACOBI_RESIDENT_MAX_MP == max(REGISTER_ROW_LENGTHS)
    for block in (False, True):
        for m in range(3 if block else 1, 2 * JACOBI_RESIDENT_MAX_MP, 3 if block else 1):
            plan = jacobi_launch_plan(m, block)
            if plan.route == "resident":
                assert plan.reg_rows == plan.threads >= plan.mp, m
                assert plan.reg_rows in REGISTER_ROW_LENGTHS, m
            else:
                assert plan.route == "cluster" and plan.mp > JACOBI_RESIDENT_MAX_MP, m


def test_amat_tiles_fit_a_block_at_every_k_of_the_fused_chain():
    assert AMAT_MAX_SHARED == MAX_SHARED_BYTES
    for K in range(1, FUSED_MAX_K + 1):
        plan = amat_launch_plan(K)
        mp = padded_rows(K)
        assert (plan.shared_bytes == amat_shared_bytes(K, plan.rows, plan.chunk)
                <= MAX_SHARED_BYTES), K
        assert 1 <= plan.chunk <= K, K
        assert plan.rows == mp or (plan.rows % 3 == 0 and 3 <= plan.rows < mp), K
        assert -(-plan.rows // 3) <= AMAT_THREADS, K      # a slab's lanes, one thread each
    # the scenes' K (4, 8, 20, 32; 22 at mp = 72): the whole of A in one
    # tile and all of Jc in one bulk copy
    for K in (4, 8, 20, 22, 32):
        plan = amat_launch_plan(K)
        assert (plan.rows, plan.chunk) == (padded_rows(K), K)


def amat_route(K: int) -> str:
    """B5's route at K lanes: the whole of A as one item, slabs of whole
    lanes' rows with all of Jc, or one lane's rows with Jc in chunks."""
    plan = amat_launch_plan(K)
    if plan.rows == padded_rows(K):
        return "whole"
    return "slab" if plan.chunk == K else "chunk"


@pytest.mark.parametrize("K,route", [(48, "whole"), (49, "slab"), (64, "slab"), (343, "slab"),
                                     (344, "chunk"), (400, "chunk")])
def test_amat_takes_slabs_past_k_48_and_jc_chunks_past_k_343(K, route):
    """The routes' edges, and the K at which `test_torch_kernels.py` holds
    each route against the plain version on the card."""
    assert amat_route(K) == route
    plan = amat_launch_plan(K)
    if route == "chunk":
        assert plan.rows == 3 and plan.chunk < K < 2 * plan.chunk


@pytest.mark.parametrize("bodies,tile", [(16_384, 32), (32_768, 64), (28_672, 64),
                                         (4_096, 32), (1 << 20, 128), (1, 32)],
                         ids=["bench", "box_stack8", "living_room", "box_drop", "large", "one"])
def test_prep_tile_gives_every_sm_two_blocks(bodies, tile):
    """B1's tile (`prep_launch_plan`) on the H100's 132 SMs: the largest of
    128, 64, 32 bodies a block that still gives every SM two blocks, else
    32 (the bench's 16,384 bodies: 512 blocks)."""
    from eggshell_tpu_torch.ops.prep_kernel import TILES, prep_launch_plan

    got = prep_launch_plan(bodies, 132)
    assert got == tile and got in TILES
    assert -(-bodies // got) >= 2 * 132 or got == min(TILES)
