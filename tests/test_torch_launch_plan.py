"""The launch plans of the Jacobi kernels (B6, B6b, B6c, B6c') and of the
A-formation kernel B5, on the CPU.

`packed_launch_plan(mp)` picks how the CUDA kernels of
`csrc/jacobi_packed.cu` and `csrc/jacobi_packed_stream.cu` run,
`jacobi_launch_plan(m)` the form of `csrc/jacobi.cu`, `amat_launch_plan(K)`
the tiles of `csrc/amat.cu`; the kernels refuse a plan they do not take.
These checks need no card.
"""

import pytest

from eggshell_tpu_torch.ops.amat_kernel import (AMAT_THREADS,
                                                MAX_SHARED_BYTES as AMAT_MAX_SHARED,
                                                amat_launch_plan, amat_shared_bytes, padded_rows)
from eggshell_tpu_torch.ops.pgs_kernel import (MAX_CLUSTER, MAX_SHARED_BYTES,
                                               REGISTER_ROW_LENGTHS, _shared_bytes,
                                               jacobi_launch_plan, packed_launch_plan)

# The largest mp of each kernel: B6 holds a scenario's A in one block;
# B6b spreads it over at most 8 blocks, and past that reads its rows from
# device memory.
RESIDENT_LIMIT, CLUSTER_LIMIT = 232, 664
# The fused chain's lanes: past the compaction kernel's limit (4
# scenarios' K lanes of 9 words in 232,448 bytes: K up to 1,614), with
# room for a scene's joint lanes.
FUSED_MAX_K = 2048


def test_every_row_count_up_to_the_limit_gets_a_plan():
    for mp in range(8, CLUSTER_LIMIT + 1, 8):
        plan = packed_launch_plan(mp)
        assert (plan.resident is not None) == (mp <= RESIDENT_LIMIT), mp
    # every mp the first design of B6 took (A with a row stride of mp + 1)
    first = [mp for mp in range(8, 1024, 8) if _shared_bytes(mp) <= MAX_SHARED_BYTES]
    assert max(first) == RESIDENT_LIMIT
    assert all(packed_launch_plan(mp).resident is not None for mp in first)


def test_rows_are_held_in_registers_exactly_up_to_the_instantiated_lengths():
    for mp in range(8, CLUSTER_LIMIT + 1, 8):
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
        assert 2 <= c.cluster <= MAX_CLUSTER and mp % c.cluster == 0, mp
        assert c.rows * c.cluster == mp and c.rows <= c.threads and c.threads % 32 == 0, mp
        assert c.shared_bytes <= MAX_SHARED_BYTES, mp
    # the fewest blocks of at most 64 rows each
    assert [packed_launch_plan(mp).cluster.cluster for mp in (64, 96, 136, 192)] == [2, 2, 4, 3]


@pytest.mark.parametrize("mp", [0, 12, 100, 676, 1028])
def test_row_counts_past_the_limit_or_off_the_row_block_raise(mp):
    # past the cluster's limit, B6b reads its rows from device memory
    # (test_the_packed_solve_takes_every_multiple_of_8): only an mp off the
    # row block raises
    with pytest.raises(ValueError):
        packed_launch_plan(mp)


def test_the_packed_solve_takes_every_multiple_of_8():
    for mp in range(8, 2048 + 1, 8):
        plan = packed_launch_plan(mp)
        assert (plan.cluster is None) == (plan.rows is not None), mp
        assert (plan.cluster is None) == (mp > CLUSTER_LIMIT), mp
        if plan.rows is not None:
            assert plan.rows.threads % 32 == 0 and plan.rows.threads <= 1024, mp
            assert plan.rows.shared_bytes <= MAX_SHARED_BYTES, mp
    assert packed_launch_plan(664).cluster.cluster == 8
    assert packed_launch_plan(672).rows is not None


@pytest.mark.parametrize("m,block,route", [
    (192, False, "shared"), (192, True, "shared"), (232, False, "shared"),
    (240, False, "global rows"), (240, True, "global rows"), (480, True, "global rows"),
])
def test_the_unfused_solve_reads_rows_from_device_memory_past_232(m, block, route):
    plan = jacobi_launch_plan(m, block)
    assert plan.route == route
    assert plan.mp == -(-m // 8) * 8
    if route == "shared":
        assert plan.rows is None and _shared_bytes(plan.mp) <= MAX_SHARED_BYTES
    else:
        assert _shared_bytes(plan.mp) > MAX_SHARED_BYTES
        assert plan.rows.threads % 32 == 0 and plan.rows.shared_bytes <= MAX_SHARED_BYTES


def test_the_unfused_solve_takes_every_row_count_up_to_2048():
    for m in range(1, 2049):
        for block in (False, True):
            plan = jacobi_launch_plan(m, block)
            assert (plan.route == "shared") == (plan.mp <= RESIDENT_LIMIT), m


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
