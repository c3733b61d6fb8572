"""The launch plan of the packed Jacobi kernels (B6 and B6b), on the CPU.

`packed_launch_plan(mp)` is the one host function that picks how the CUDA
kernels of `csrc/jacobi_packed.cu` and `csrc/jacobi_packed_stream.cu` run;
the kernels refuse a plan they do not take.  These checks need no card.
"""

import pytest

from eggshell_tpu_torch.ops.pgs_kernel import (MAX_CLUSTER, MAX_SHARED_BYTES,
                                               REGISTER_ROW_LENGTHS, _shared_bytes,
                                               packed_launch_plan)

# The largest mp of each kernel: B6 holds a scenario's A in one block;
# B6b spreads it over at most 8 blocks.
RESIDENT_LIMIT, CLUSTER_LIMIT = 232, 664


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


@pytest.mark.parametrize("mp", [0, 12, 100, CLUSTER_LIMIT + 8, 1024])
def test_row_counts_past_the_limit_or_off_the_row_block_raise(mp):
    with pytest.raises(ValueError):
        packed_launch_plan(mp)
