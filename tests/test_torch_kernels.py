"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no interpret mode, so these tests need a CUDA device and
skip without one.  Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest -o addopts=""

The kernels are float32; tolerances are those of float32 arithmetic
summed in a different order (relative 1e-4 for the Jacobi solves, absolute
1e-4 for narrowphase positions and depths of O(1) boxes).  The fused
chain's straight-line kernels (prep, Jacobian blocks, A, integrate) keep
their plain versions' order of operations and are built with
--fmad=false, so they are held to 1e-5 relative to the output's scale
(sinf, cosf and the reduction order of A's sums differ by an ulp or so).
The packed narrowphase runs the lanes entry's device function and must
agree with it bit for bit; the compaction kernel must give the plain
version's ids and flags exactly and its geometry within 1e-6; the streamed
Jacobi must agree bit for bit with the resident one (the same sums in the
same order) and within 1e-4 relative with the plain version.  The block
and pyramid forms of the packed Jacobi and the block-Jacobi B6c' keep the
plain versions' expressions except for A x, whose sums torch orders
otherwise: 1e-5 relative to max |x|.  The FDTD step has no sums and is
held to 1e-6 of max |ez| (bit for bit expected).
"""

import numpy as np
import pytest
import torch

from eggshell_tpu_torch.ops.amat_kernel import (amat_launch_plan, contact_system_matrix,
                                                contact_system_matrix_plain, padded_rows)
from eggshell_tpu_torch.ops.collision import collide_boxes
from eggshell_tpu_torch.ops.collision_kernel import (collide_boxes_lanes,
                                                    collide_boxes_lanes_packed,
                                                    collide_boxes_lanes_packed_plain, gather_pairs,
                                                    narrowphase_launch_plan)
from eggshell_tpu_torch.ops.collision_poses import (DEGENERATE_FLAG_AGREEMENT, class_agreement,
                                                    degenerate_args, pair_list, random_bodies)
from eggshell_tpu_torch.ops.compact_kernel import compact_contacts, compact_contacts_plain
from eggshell_tpu_torch.ops.integrate_kernel import (integrate_launch_plan, integrate_step,
                                                     integrate_step_plain)
from eggshell_tpu_torch.ops.jassembly_kernel import (contact_jacobian_blocks,
                                                     contact_jacobian_blocks_plain)
from eggshell_tpu_torch.fem.fdtd import fused_grids, init_2d, step_2d_fused, step_2d_fused_plain
from eggshell_tpu_torch.ops.pgs_kernel import (solve_lcp_jacobi, solve_lcp_jacobi_block,
                                               packed_launch_plan, solve_lcp_jacobi_packed,
                                               solve_lcp_jacobi_packed_block,
                                               solve_lcp_jacobi_packed_plain,
                                               solve_lcp_jacobi_packed_pyramid,
                                               solve_lcp_jacobi_packed_stream,
                                               solve_lcp_jacobi_plain)
from eggshell_tpu_torch.ops.quaternion import quat_to_mat
from eggshell_tpu_torch.ops.prep_kernel import prep_bodies, prep_bodies_plain
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics import scenes
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import BENCH, SimConfig, SolverKind
from test_torch_integrate_compact_plan import (COMPACT_CASES, INTEGRATE_CASES, PLAN_SHAPES,
                                               _compact_inputs, _integrate_inputs)
from torch_limits import time_limit  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def _pairs(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    from eggshell_tpu_torch.ops.quaternion import quat_to_mat

    R = quat_to_mat(torch.tensor(q, dtype=torch.float32))
    R[:, ::4] = torch.eye(3)                      # aligned pairs, as in a stack
    c1 = rng.uniform(-1, 1, (n, 3))
    c2 = c1 + rng.uniform(-0.6, 0.6, (n, 3))
    h = rng.uniform(0.05, 0.5, (2, n, 3))
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    return f(c1), f(R[0]), f(h[0]), f(c2), f(R[1]), f(h[1])


def test_narrowphase_kernel_matches_plain(dev):
    args = _pairs(4096, dev)
    before = collide_boxes_lanes.launches
    got = collide_boxes_lanes(*args)
    want = collide_boxes(*args)
    torch.cuda.synchronize()
    assert collide_boxes_lanes.launches == before + 1
    same = got.code == want.code
    assert float(same.float().mean()) >= 0.99
    both = got.active & want.active & same[:, None]
    assert both.any()
    assert float((got.position - want.position).abs().amax(-1)[both].max()) <= 1e-4
    assert float((got.depth - want.depth).abs()[both].max()) <= 1e-4


def test_jacobi_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(0)
    B, m = 512, 60
    G = torch.randn(B, m, 24, generator=g)
    A = (G @ G.transpose(-1, -2) / 24 + torch.eye(m)).to(dev)
    b = torch.randn(B, m, generator=g).to(dev)
    row = torch.arange(m)
    is_eq = (row % 10 == 9).expand(B, m).contiguous().to(dev)
    lo = torch.where(row % 3 == 2, 0.0, -1.0).expand(B, m).contiguous().to(dev)
    hi = torch.where(row % 3 == 2, float("inf"), 1.0).expand(B, m).contiguous().to(dev)
    got = solve_lcp_jacobi(A, b, is_eq, lo, hi, 16, 0.3, 0.45)
    want = solve_lcp_jacobi_plain(A, b, is_eq, lo, hi, 16, 0.3, 0.45)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev):
    p1, R1, h1, p2, R2, h2 = _pairs(8, dev)
    with pytest.raises(TypeError):
        collide_boxes_lanes(p1.double(), R1, h1, p2, R2, h2)
    with pytest.raises(ValueError):
        collide_boxes_lanes(p1, R1[:4], h1, p2, R2, h2)
    A = torch.eye(300, device=dev).expand(2, 300, 300).contiguous()
    v = torch.zeros(2, 300, device=dev)
    # m = 300 takes the cluster form; a float mask is still refused
    with pytest.raises(TypeError):
        solve_lcp_jacobi(A, v, v, v, v, 4, 0.3)
    d = _fused_inputs(dev, B=8)
    with pytest.raises(TypeError):
        prep_bodies(d["q"].double(), d["v"], d["w"], d["inv_mass"], d["Ib"], d["invIb"], 1e-3,
                    (0.0, 0.0, -9.8))
    with pytest.raises(ValueError, match="contiguous"):
        contact_jacobian_blocks(d["b0"], d["b1"], d["pos"], d["pos1"],
                                d["nrm"].transpose(0, 1).contiguous().transpose(0, 1), d["dep"],
                                d["act"], d["eq"], d["p"], torch.zeros(8, 4, 6, device=dev), 2e5)
    Jc = torch.zeros(8, 60, 12, device=dev)
    with pytest.raises(ValueError, match="fewer than"):
        integrate_step(Jc, torch.zeros(8, 30, device=dev), d["b0"], d["b1"], d["p"], d["q"],
                       d["v"], d["w"], d["inv_mass"], torch.zeros(8, 4, 3, 3, device=dev),
                       torch.zeros(8, 4, 6, device=dev), 1e-3)
    A64 = torch.eye(64, device=dev).expand(8, 64, 64).contiguous()
    with pytest.raises(ValueError, match="3-row"):
        solve_lcp_jacobi(A64, v[:, :64], v[:, :64] > 0, v[:, :64], v[:, :64], 4, 0.3, block=True)
    with pytest.raises(ValueError, match="diag has"):
        solve_lcp_jacobi_packed(A64, torch.ones(8, 60, device=dev), torch.zeros(8, 60, device=dev),
                                d["act"], None, 20, 1.0, 4, 0.3, 0.45, block=True)
    big = _random_packed_lcp(dev, B=2, K=80)                  # mp = 240: past one block
    with pytest.raises(ValueError, match="does not fit one block"):
        solve_lcp_jacobi_packed(*big, stream=False)
    ez = torch.zeros(16, 16, device=dev)
    with pytest.raises(TypeError):
        step_2d_fused(ez.double(), ez, ez, ez, ez, 1e-3, 1e-2)


def test_slice_goes_through_both_kernels(dev):
    cfg = SimConfig(solver=SolverKind.JACOBI_KERNEL, solver_iters=16, jacobi_omega=0.3,
                    jacobi_beta=0.45, conditional_cfm=True, cond_estimator="power",
                    contact_capacity=20, contact_kernel=True)
    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    states = State(*[x.expand((64,) + x.shape).clone() for x in st])
    n0, j0 = collide_boxes_lanes.launches, solve_lcp_jacobi.launches
    out = rollout_batched(spec, states, cfg, 5)
    torch.cuda.synchronize()
    assert collide_boxes_lanes.launches - n0 == 5 and solve_lcp_jacobi.launches - j0 == 5
    assert all(bool(torch.isfinite(x).all()) for x in out)


def _close(got, want, rel=1e-5):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(w.abs().max()), 1.0)
        assert float((g - w).abs().max()) <= rel * scale


def _fused_inputs(dev, B=256, K=20, n=4, seed=0):
    """Random bodies and K lanes per scenario: normals +-z and generic,
    ground, equality, inactive and idle lanes."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    i = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev).contiguous()
    q = rng.normal(size=(B, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    G = rng.normal(size=(n, 3, 3))
    Ib = G @ G.transpose(0, 2, 1) + np.eye(3)
    nrm = rng.normal(size=(B, K, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, 0::4] = [0.0, 0.0, 1.0]
    nrm[:, 1::4] = [0.0, 0.0, -1.0]
    b0 = rng.integers(-1, n, size=(B, K))
    b1 = (np.maximum(b0, 0) + rng.integers(1, n, size=(B, K))) % n
    act = rng.uniform(size=(B, K)) < 0.8
    idle = rng.uniform(size=(B, K)) < 0.1
    b0[idle] = b1[idle] = -1
    act[idle] = False
    pos = rng.normal(size=(B, K, 3))
    return dict(
        q=f(q), v=f(rng.normal(size=(B, n, 3))), w=f(rng.normal(size=(B, n, 3))),
        p=f(rng.normal(size=(B, n, 3))), inv_mass=f(rng.uniform(0.5, 2, n)), Ib=f(Ib),
        invIb=f(np.linalg.inv(Ib)), ext=f(rng.normal(size=(B, n, 6))),
        b0=i(b0), b1=i(b1), pos=f(pos), pos1=f(pos + 0.05 * rng.normal(size=(B, K, 3))),
        nrm=f(nrm), dep=f(rng.uniform(0, 0.01, (B, K))),
        act=torch.as_tensor(act, device=dev), eq=torch.as_tensor(rng.uniform(size=(B, K)) < 0.1,
                                                                  device=dev), K=K)


def test_fused_chain_kernels_match_plain(dev):
    d = _fused_inputs(dev)
    K = d["K"]
    before = [f.launches for f in (prep_bodies, contact_jacobian_blocks, contact_system_matrix,
                                   solve_lcp_jacobi_packed, integrate_step)]
    body = (d["q"], d["v"], d["w"], d["inv_mass"], d["Ib"], d["invIb"], 1e-3, (0.0, 0.0, -9.8),
            d["ext"])
    prep = prep_bodies(*body)
    _close(prep, prep_bodies_plain(*body))
    uhat, invIg, F = prep
    lanes = (d["b0"], d["b1"], d["pos"], d["pos1"], d["nrm"], d["dep"], d["act"], d["eq"],
             d["p"], uhat, 2e5)
    blocks = contact_jacobian_blocks(*lanes)
    _close(blocks, contact_jacobian_blocks_plain(*lanes))
    Jc, rhs = blocks
    amat = (Jc, d["b0"], d["b1"], d["act"], d["inv_mass"], invIg, K, 0.01)
    A, diag = contact_system_matrix(*amat)
    _close((A, diag), contact_system_matrix_plain(*amat))
    lcp = (A, diag, rhs, d["act"], d["eq"], K, 1.0, 16, 0.3, 0.45)
    lam = solve_lcp_jacobi_packed(*lcp)
    _close((lam,), (solve_lcp_jacobi_packed_plain(*lcp),), rel=1e-4)
    step = (Jc, lam, d["b0"], d["b1"], d["p"], d["q"], d["v"], d["w"], d["inv_mass"], invIg, F,
            1e-3)
    _close(integrate_step(*step), integrate_step_plain(*step))
    torch.cuda.synchronize()
    after = [f.launches for f in (prep_bodies, contact_jacobian_blocks, contact_system_matrix,
                                  solve_lcp_jacobi_packed, integrate_step)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 1]


def test_fused_slice_goes_through_the_fused_kernels(dev):
    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    states = State(*[x.expand((64,) + x.shape).clone() for x in st])
    wrappers = (collide_boxes_lanes_packed, compact_contacts, prep_bodies,
                contact_jacobian_blocks, contact_system_matrix, solve_lcp_jacobi_packed,
                integrate_step, collide_boxes_lanes, solve_lcp_jacobi,
                solve_lcp_jacobi_packed_stream)
    before = [f.launches for f in wrappers]
    out = rollout_batched(spec, states, BENCH, 5)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [5, 5, 5, 5, 5, 5, 5, 0, 0, 0]
    assert all(bool(torch.isfinite(x).all()) for x in out)


def _jittered_scene(name, dev, B=256, seed=0):
    """B scenarios of a BASELINE scene, positions moved by 2 mm N(0, 1)."""
    spec, states, cfg = scenes.baseline_batch(name, B, device=dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    noise = 2e-3 * torch.randn(states.p.shape, generator=g)
    return spec, states._replace(p=(states.p + noise.to(dev)).contiguous()), cfg


def test_packed_narrowphase_kernel_matches_lanes_kernel_and_plain(dev):
    spec, st, _ = _jittered_scene("box_stack8", dev)
    args = (st.p, st.q, spec.half_extents, spec.pair_i, spec.pair_j)
    before = collide_boxes_lanes_packed.launches
    got = collide_boxes_lanes_packed(*args)
    assert collide_boxes_lanes_packed.launches == before + 1
    B, P = st.p.shape[0], spec.num_pairs
    lanes = collide_boxes_lanes(*gather_pairs(st.p, quat_to_mat(st.q), spec.half_extents,
                                              spec.pair_i, spec.pair_j))
    torch.cuda.synchronize()
    assert torch.equal(got[0], lanes.position.reshape(B, P, 12, 3))
    assert torch.equal(got[1], lanes.normal[:, 0].reshape(B, P, 3))
    assert torch.equal(got[2], lanes.depth.reshape(B, P, 12))
    assert torch.equal(got[3], lanes.active.reshape(B, P, 12))
    want = collide_boxes_lanes_packed_plain(*args)
    assert float((got[3] == want[3]).float().mean()) >= 0.99
    both = got[3] & want[3]
    assert both.any()
    assert float((got[0] - want[0]).abs().amax(-1)[both].max()) <= 1e-4


def test_narrowphase_entries_match_plain_on_degenerate_poses(dev):
    """Aligned stacks, exactly touching faces, coincident centres, separated
    pairs, deep penetration (code 16), a turned stack and generic poses, in
    4099 scenarios (no multiple of the pairs a warp or a block): B2's codes
    agree with the plain version's on every pair, its flags on every lane
    off the reference face and on each pose as the card measured them; B2p
    is bit for bit B2."""
    (p, q, hs, pi, pj), pose = degenerate_args(dev)
    B = p.shape[0]
    gathered = gather_pairs(p, quat_to_mat(q), hs, pi, pj)
    got = collide_boxes_lanes(*gathered)
    want = collide_boxes(*gathered)
    packed = collide_boxes_lanes_packed(p, q, hs, pi, pj)
    torch.cuda.synchronize()
    codes = torch.bincount(got.code.long(), minlength=17)
    assert codes[0] > 0 and codes[16] > 0 and codes[1:7].sum() > 0
    agreement = class_agreement(got, want, pose)
    assert all(code == 1.0 and off_face == 1.0 for code, _, off_face in agreement.values()), \
        agreement
    assert all(flags >= DEGENERATE_FLAG_AGREEMENT[name]
               for name, (_, flags, _) in agreement.items()), agreement
    both = got.active & want.active
    assert float((got.position - want.position).abs().amax(-1)[both].max()) <= 1e-4
    assert float((got.depth - want.depth).abs()[both].max()) <= 1e-4
    assert torch.equal(packed[0], got.position.reshape(B, 1, 12, 3))
    assert torch.equal(packed[1], got.normal[:, 0].reshape(B, 1, 3))
    assert torch.equal(packed[2], got.depth.reshape(B, 1, 12))
    assert torch.equal(packed[3], got.active.reshape(B, 1, 12))


@pytest.mark.parametrize("case", ["seeded 8 boxes", "box_stack8", "living_room"])
def test_packed_narrowphase_is_bit_for_bit_the_lanes_entry(dev, case):
    if case == "seeded 8 boxes":
        rng = np.random.default_rng(2)
        p, q, _ = random_bodies(rng, 4096, 8, xy=(-1.0, 1.0), z=(-1.0, 1.0))
        hs = rng.uniform(0.05, 0.6, (8, 3))
        pi, pj = pair_list(8)
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
        i = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev).contiguous()
        args = (f(p), f(q), f(hs), i(pi), i(pj))
    else:
        spec, st, _ = scenes.baseline_batch(case, 4096, device=dev)
        args = (st.p.contiguous(), st.q.contiguous(), spec.half_extents, spec.pair_i,
                spec.pair_j)
    got = collide_boxes_lanes_packed(*args)
    B, P = args[0].shape[0], args[3].shape[0]
    lanes = collide_boxes_lanes(*gather_pairs(args[0], quat_to_mat(args[1]), *args[2:]))
    torch.cuda.synchronize()
    assert torch.equal(got[0], lanes.position.reshape(B, P, 12, 3))
    assert torch.equal(got[1], lanes.normal[:, 0].reshape(B, P, 3))
    assert torch.equal(got[2], lanes.depth.reshape(B, P, 12))
    assert torch.equal(got[3], lanes.active.reshape(B, P, 12))


def test_narrowphase_refuses_a_plan_it_does_not_take(dev):
    """The C entry takes only the plan of `narrowphase_launch_plan`: any
    other launches nothing and raises (the wrapper launches by that plan)."""
    from eggshell_tpu_torch import kernels

    N = 64
    args = _pairs(N, dev)
    outs = (torch.empty((N, 12, 3), device=dev), torch.empty((N, 3), device=dev),
            torch.empty((N, 12), device=dev), torch.empty((N, 12), dtype=torch.bool, device=dev),
            torch.empty((N,), dtype=torch.int32, device=dev), torch.empty((N,), device=dev),
            torch.empty((N, 3), device=dev))
    plan = narrowphase_launch_plan(N)
    for bad in (plan._replace(lanes=8, blocks=-(-N // 16), shared_bytes=16 * 25 * 8),
                plan._replace(threads=256), plan._replace(blocks=plan.blocks + 1),
                plan._replace(shared_bytes=0)):
        with pytest.raises(RuntimeError):
            kernels.launch("eggshell_narrowphase_f32", dev, *args, *outs, N, *bad)


def _assert_same_lanes(got, want):
    for k in ("b0", "b1", "active"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k in ("position", "normal", "depth"):
        assert float((getattr(got, k) - getattr(want, k)).abs().max()) <= 1e-6, k


@pytest.mark.parametrize("case", ["box_stack8", "box_drop", "dedupe", "depth_cap", "overflow"])
def test_compact_kernel_matches_plain(dev, case):
    scene = "box_drop" if case == "box_drop" else "box_stack8"
    spec, st, cfg = _jittered_scene(scene, dev)
    K, eps2, cap = cfg.contact_capacity, 1e-12, None
    if case == "dedupe":
        eps2 = 0.35 ** 2        # the corners of a face are 0.3 apart
    if case == "depth_cap":
        cap = 2e-4
    if case == "overflow":
        K = 6
    pair = None
    if spec.num_pairs:
        pair = collide_boxes_lanes_packed(st.p, st.q, spec.half_extents, spec.pair_i,
                                          spec.pair_j)
    args = (st.p, st.q, spec.half_extents, spec.ground_enabled, pair, spec.pair_i, spec.pair_j,
            K, eps2, cap)
    before = compact_contacts.launches
    got = compact_contacts(*args)
    torch.cuda.synchronize()
    assert compact_contacts.launches == before + 1
    want = compact_contacts_plain(*args)
    _assert_same_lanes(got, want)
    assert bool(want.active.any())
    if case == "dedupe":
        assert bool(((want.b1 >= 0) & ~want.active).any())


def _to(x, dev):
    """x with every tensor in it (nested tuples included) moved to dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_to(item, dev) for item in x)
    return x


def _same_bits(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))


@pytest.mark.parametrize("case", list(INTEGRATE_CASES.values()), ids=list(INTEGRATE_CASES))
def test_integrate_kernel_gives_the_plain_versions_bits(dev, case):
    """B7 on the cases of the CPU replay (ground slots, idle lanes, b0 = b1,
    lambda = -0, a lambda stride past 3K), -0 included; at K = 2048, n = 64
    and at K = 700, n = 300 the plan takes the chunk route (lanes, and
    lanes and bodies, in chunks)."""
    B, K, n, L, _ = case
    args = _to(_integrate_inputs(B, K, n, L, seed=K + n), dev)
    before = integrate_step.launches
    got = integrate_step(*args)
    torch.cuda.synchronize()
    assert integrate_step.launches == before + 1
    assert _same_bits(got, integrate_step_plain(*args))


def test_integrate_entry_takes_only_its_plan(dev):
    """The C entry computes `integrate_launch_plan`'s plan at every shape of
    the CPU plan test and refuses any other: it launches nothing and
    raises."""
    import ctypes

    from eggshell_tpu_torch import kernels

    lib = kernels.load()
    out = (ctypes.c_int * 5)()
    for B, K, n in PLAN_SHAPES.values():
        assert lib.eggshell_integrate_plan(B, K, n, out) == 0
        assert tuple(out) == tuple(integrate_launch_plan(B, K, n)), (B, K, n)
    B, K, n, L, _ = INTEGRATE_CASES["bench"]
    args = _to(_integrate_inputs(B, K, n, L, seed=K + n), dev)
    outs = tuple(torch.empty_like(x) for x in args[4:8])
    plan = integrate_launch_plan(B, K, n)
    for bad in (plan._replace(scenarios=plan.scenarios + 1), plan._replace(threads=512),
                plan._replace(lanes=3), plan._replace(shared_bytes=plan.shared_bytes + 4)):
        with pytest.raises(RuntimeError):
            kernels.launch("eggshell_integrate_f32", dev, *args[:11], *outs, B, K, n, L,
                           float(args[11]), *bad)


def _at_offset(x):
    """A contiguous copy of x that starts one element past an allocation's
    start."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return flat[1:].view(x.shape).copy_(x)


@pytest.mark.parametrize("what", ["integrate Jc", "integrate q", "compact pair_act"])
def test_views_at_an_offset(dev, what):
    """A Jc that is not 16-byte aligned and pair flags that are not 4-byte
    aligned are refused (the kernels read them in 16- and 4-byte pieces);
    q at any offset is taken, with the plain version's bits."""
    if what.startswith("integrate"):
        B, K, n, L, _ = INTEGRATE_CASES["bench"]
        args = list(_to(_integrate_inputs(B, K, n, L, seed=K + n), dev))
        i = 0 if what.endswith("Jc") else 5
        args[i] = _at_offset(args[i])
        if i == 0:
            with pytest.raises(ValueError, match="16-byte"):
                integrate_step(*args)
        else:
            assert _same_bits(integrate_step(*args), integrate_step_plain(*args))
        return
    args = list(_to(_compact_inputs(*COMPACT_CASES["overflow past K (bench widths)"],
                                    seed=0), dev))
    pos, nrm, dep, act = args[4]
    args[4] = (pos, nrm, dep, _at_offset(act))
    with pytest.raises(ValueError, match="4-byte"):
        compact_contacts(*args)


@pytest.mark.parametrize("case", list(COMPACT_CASES.values()), ids=list(COMPACT_CASES))
def test_compact_kernel_matches_plain_on_the_replay_cases(dev, case):
    """B3 and B3g on the cases of the CPU replay: overflow past K, clustered
    lanes at min_constraint_distance 0.05, a depth cap, ground only, K = 64,
    and two rounds of flag words and of bodies."""
    B, n, P, K, act_p, eps2, cap, clustered, ground_only = case
    args = _to(_compact_inputs(B, n, P, K, act_p, eps2, cap, clustered, ground_only,
                               seed=n + P + K), dev)
    before = compact_contacts.launches
    got = compact_contacts(*args)
    torch.cuda.synchronize()
    assert compact_contacts.launches == before + 1
    _assert_same_lanes(got, compact_contacts_plain(*args))


@pytest.mark.parametrize("K", [32, 64, 85], ids=["mp96", "mp192", "mp256"])
def test_streamed_jacobi_kernel_matches_plain_and_resident(dev, K):
    """B6b with the cluster the plan picks (2 blocks at mp = 96, 3 at 192,
    4 at 256) against the plain version and, bit for bit, the resident B6;
    at mp = 256, past the resident kernel's reach and a tensor copy's box
    width, against the plain version only.  `solve_lcp_jacobi_packed`
    takes B6b past the measured crossing (mp 192 and 256), B6 below it."""
    from eggshell_tpu_torch.ops.pgs_kernel import packed_streams

    lcp = _random_packed_lcp(dev, B=256, K=K, seed=1)
    mp = lcp[1].shape[1]
    plan = packed_launch_plan(mp)
    assert plan.cluster.cluster == {96: 2, 192: 3, 256: 4}[mp]
    assert packed_streams(mp) == (mp > 96)
    before = (solve_lcp_jacobi_packed_stream.launches, solve_lcp_jacobi_packed.launches)
    dispatched = solve_lcp_jacobi_packed(*lcp)
    got = solve_lcp_jacobi_packed_stream(*lcp)
    resident = solve_lcp_jacobi_packed(*lcp, stream=False) if plan.resident else None
    torch.cuda.synchronize()
    streamed = int(packed_streams(mp))
    assert (solve_lcp_jacobi_packed_stream.launches - before[0],
            solve_lcp_jacobi_packed.launches - before[1]) == \
        (1 + streamed, 1 - streamed + int(resident is not None))
    assert torch.equal(dispatched, got)
    assert resident is None or torch.equal(got, resident)
    _close((got,), (solve_lcp_jacobi_packed_plain(*lcp),), rel=1e-4)


@pytest.mark.parametrize("name", ["box_drop", "pendulum_chain6", "box_stack8", "living_room"])
def test_baseline_scene_goes_through_its_kernels(dev, name):
    spec, states, cfg = scenes.baseline_batch(name, 64, device=dev)
    wrappers = {"narrowphase_packed": collide_boxes_lanes_packed, "compact": compact_contacts,
                "jacobi_packed": solve_lcp_jacobi_packed,
                "jacobi_packed_stream": solve_lcp_jacobi_packed_stream,
                "integrate": integrate_step}
    before = {k: f.launches for k, f in wrappers.items()}
    out = rollout_batched(spec, states, cfg, 3)
    torch.cuda.synchronize()
    got = {k: f.launches - before[k] for k, f in wrappers.items()}
    # every scene's solve (mp 32 to 96) is below the resident/cluster crossing
    assert got == {"narrowphase_packed": 3 if spec.num_pairs > 0 else 0, "compact": 3,
                   "jacobi_packed": 3, "jacobi_packed_stream": 0, "integrate": 3}
    assert all(bool(torch.isfinite(x).all()) for x in out)


def test_wide_scene_goes_through_the_cluster_solve(dev):
    """box_stack8 at contact_capacity 64 (mp = 192, past the crossing)
    solves through B6b, once a step."""
    spec, states, cfg = scenes.baseline_batch("box_stack8", 64, device=dev)
    cfg = cfg.replace(contact_capacity=64)
    before = (solve_lcp_jacobi_packed.launches, solve_lcp_jacobi_packed_stream.launches)
    out = rollout_batched(spec, states, cfg, 3)
    torch.cuda.synchronize()
    assert (solve_lcp_jacobi_packed.launches - before[0],
            solve_lcp_jacobi_packed_stream.launches - before[1]) == (0, 3)
    assert all(bool(torch.isfinite(x).all()) for x in out)


@pytest.mark.parametrize("K,n,B,route", [(20, 4, 512, "whole"), (32, 8, 512, "whole"),
                                         (64, 8, 64, "slab"), (400, 8, 8, "chunk")],
                         ids=["K20", "K32", "K64", "K400"])
def test_jacobian_blocks_and_system_matrix_are_bit_for_bit_plain(dev, K, n, B, route):
    """The redesigned B4 and B5 keep each entry's order of operations: on
    the card they return their plain versions' bits (`torch.equal`, which
    takes -0 for 0), at the bench's K = 20 and the scenes' K = 32, where
    B5 builds the whole of A as one item, and on B5's two other routes:
    slabs of whole lanes' rows (K = 64) and one lane's rows with Jc in two
    chunks (K = 400)."""
    plan = amat_launch_plan(K)
    assert route == ("whole" if plan.rows == padded_rows(K)
                     else "slab" if plan.chunk == K else "chunk")
    d = _fused_inputs(dev, B=B, K=K, n=n, seed=3)
    uhat, invIg, _ = prep_bodies_plain(d["q"], d["v"], d["w"], d["inv_mass"], d["Ib"], d["invIb"],
                                       1e-3, (0.0, 0.0, -9.8))
    lanes = (d["b0"], d["b1"], d["pos"], d["pos1"], d["nrm"], d["dep"], d["act"], d["eq"],
             d["p"], uhat, 2e5)
    before = (contact_jacobian_blocks.launches, contact_system_matrix.launches)
    blocks = contact_jacobian_blocks(*lanes)
    want_blocks = contact_jacobian_blocks_plain(*lanes)
    amat = (want_blocks[0], d["b0"], d["b1"], d["act"], d["inv_mass"], invIg, K, 0.01)
    A, diag = contact_system_matrix(*amat)
    torch.cuda.synchronize()
    assert (contact_jacobian_blocks.launches - before[0],
            contact_system_matrix.launches - before[1]) == (1, 1)
    assert all(torch.equal(g, w) for g, w in zip(blocks, want_blocks))
    assert all(torch.equal(g, w) for g, w in zip((A, diag), contact_system_matrix_plain(*amat)))


def _random_lcp(dev, B, m, seed):
    """A seeded SPD system (B, m, m) with contact-like rows: tangents in
    [-1, 1], normals in [0, inf), every tenth row an equality."""
    g = torch.Generator().manual_seed(seed)
    G = torch.randn(B, m, 24, generator=g)
    A = (G @ G.transpose(-1, -2) / 24 + torch.eye(m)).to(dev)
    b = torch.randn(B, m, generator=g).to(dev)
    row = torch.arange(m)
    is_eq = (row % 10 == 9).expand(B, m).contiguous().to(dev)
    lo = torch.where(row % 3 == 2, 0.0, -1.0).expand(B, m).contiguous().to(dev)
    hi = torch.where(row % 3 == 2, float("inf"), 1.0).expand(B, m).contiguous().to(dev)
    return A, b, is_eq, lo, hi


def _solve_in(plan, A, b, is_eq, lo, hi, block):
    """B6c or B6c' in the form `plan` names, whatever m is."""
    from eggshell_tpu_torch.ops.pgs_kernel import launch_jacobi_plan

    if block:
        return launch_jacobi_plan("eggshell_jacobi_block_f32", plan, A, b, is_eq, lo, hi, 16, 0.3)
    return launch_jacobi_plan("eggshell_jacobi_f32", plan, A, b, is_eq, lo, hi, 16, 0.3, 0.45)


@pytest.mark.parametrize("block", [False, True], ids=["scalar", "block"])
def test_unfused_jacobi_forms_match_plain_and_global_rows(dev, block):
    """B6c and B6c' in the form their plan picks: resident at m = 30 (rows
    copied by element loads, m % 4 != 0) and 60 (one tensor copy), cluster
    at m = 132 (one tensor copy a block but the last, whose fewer rows
    come one bulk copy a row), 240 (one tensor copy a block), 480 (one
    bulk copy a row) and 672 (past the portable 8 blocks: 9 to 16), the
    streamed form at m = 1,200 (one tensor copy a stage), 1,203 (element
    loads) and 4,200 (two tensor copies a stage, past a box's 256 rows),
    each against the plain version (1e-4 and 1e-5 of max |x|) and
    bit for bit against the global-rows form forced by its plan; the
    cluster form forced at m = 60, a cluster of 16 forced at m = 96 and the
    streamed form forced at m = 240 return the plan's form's bits."""
    from eggshell_tpu_torch.ops.pgs_kernel import (jacobi_cluster_plan, jacobi_global_plan,
                                                   jacobi_launch_plan, jacobi_streamed_plan)

    rel = 1e-5 if block else 1e-4
    counter = solve_lcp_jacobi_block if block else solve_lcp_jacobi

    def plain(*args):
        return (solve_lcp_jacobi_plain(*args, 16, 0.3, block=True) if block
                else solve_lcp_jacobi_plain(*args, 16, 0.3, 0.45))

    for B, m, route, copy in ((256, 30, "resident", "element loads"),
                              (256, 60, "resident", "tensor map"),
                              (256, 132, "cluster", "tensor map"),
                              (256, 240, "cluster", "tensor map"),
                              (64, 480, "cluster", "bulk rows"), (64, 672, "cluster", "bulk rows"),
                              (16, 1200, "streamed", "tensor map"),
                              (8, 1203, "streamed", "element loads"),
                              (2, 4200, "streamed", "tensor map")):
        args = _random_lcp(dev, B, m, seed=m)
        plan = jacobi_launch_plan(m, block)
        assert (plan.route, plan.copy) == (route, copy)
        assert m != 132 or plan.cluster * plan.rows > m     # a shorter last block
        assert m != 672 or plan.cluster > 8                 # Hopper's non-portable sizes
        n0 = counter.launches
        got = solve_lcp_jacobi(*args, 16, 0.3, 0.45, block=block)
        want = plain(*args)
        rows = _solve_in(jacobi_global_plan(m, block), *args, block)
        torch.cuda.synchronize()
        assert counter.launches == n0 + 1
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= rel * float(want.abs().max()), m
        assert torch.equal(rows, got), m
    for m, force in ((60, jacobi_cluster_plan(60, block)),
                     (96, jacobi_cluster_plan(96, block, 16)),
                     (240, jacobi_streamed_plan(240, block))):
        args = _random_lcp(dev, 256, m, seed=m + 1)
        planned = solve_lcp_jacobi(*args, 16, 0.3, 0.45, block=block)
        forced = _solve_in(force, *args, block)
        torch.cuda.synchronize()
        assert torch.equal(forced, planned), m


def test_packed_global_rows_matches_plain_and_the_cluster_kernel(dev):
    """Past mp = 664 B6b holds A on a cluster of 9 to 16 blocks (mp = 672
    and 888, a shorter last block at 888) and past what 16 blocks hold
    streams it (mp = 1,200, and 4,200 with two tensor copies a stage): each
    against the plain version (1e-4) and bit for bit against the
    global-rows form forced by its plan.  At mp = 96
    the global-rows form, a forced cluster of 16 and a forced streamed form
    return the cluster kernel's and the resident B6's bits."""
    from eggshell_tpu_torch import kernels
    from eggshell_tpu_torch.ops.pgs_kernel import (ROWS_THREADS, launch_packed_plan,
                                                   packed_cluster_plan, rows_plan, streamed_plan)

    for B, K, route in ((64, 224, "cluster"), (32, 296, "cluster"), (16, 400, "streamed"),
                        (2, 1400, "streamed")):
        lcp = _random_packed_lcp(dev, B=B, K=K, seed=5)
        mp = lcp[1].shape[1]
        plan = packed_launch_plan(mp)
        assert (plan.cluster if route == "cluster" else plan.streamed) is not None, mp
        assert route != "cluster" or plan.cluster.cluster > 8
        n0 = solve_lcp_jacobi_packed_stream.launches
        got = solve_lcp_jacobi_packed_stream(*lcp)
        rows = launch_packed_plan(rows_plan(mp, 3), *lcp)
        torch.cuda.synchronize()
        assert solve_lcp_jacobi_packed_stream.launches == n0 + 1
        _close((got,), (solve_lcp_jacobi_packed_plain(*lcp),), rel=1e-4)
        assert torch.equal(rows, got), mp

    A, diag, rhs, act, eq, K, mu, iters, omega, beta = _random_packed_lcp(dev, B=256, K=32, seed=6)
    cluster = solve_lcp_jacobi_packed_stream(A, diag, rhs, act, eq, K, mu, iters, omega, beta)
    resident = solve_lcp_jacobi_packed(A, diag, rhs, act, eq, K, mu, iters, omega, beta,
                                       stream=False)
    rows = torch.empty_like(diag)
    kernels.launch("eggshell_jacobi_packed_rows_f32", dev, A, diag, rhs, act, eq, rows, 256, K, 96,
                   iters, mu, omega, beta, min(ROWS_THREADS, 96))
    sixteen = launch_packed_plan(packed_cluster_plan(96, 16), A, diag, rhs, act, eq, K, mu, iters,
                                 omega, beta)
    streamed = launch_packed_plan(streamed_plan(96), A, diag, rhs, act, eq, K, mu, iters, omega,
                                  beta)
    torch.cuda.synchronize()
    assert torch.equal(rows, cluster) and torch.equal(rows, resident)
    assert torch.equal(sixteen, resident) and torch.equal(streamed, resident)


def _random_packed_lcp(dev, B=256, K=20, seed=2):
    rng = np.random.default_rng(seed)
    mp = 3 * K + (-3 * K) % 8
    G = torch.as_tensor(rng.normal(size=(B, mp, 24)), dtype=torch.float32, device=dev)
    A = (G @ G.transpose(-1, -2) / 24 + torch.eye(mp, device=dev)).contiguous()
    diag = torch.diagonal(A, dim1=-2, dim2=-1).contiguous()
    rhs = torch.as_tensor(rng.normal(size=(B, 3 * K)), dtype=torch.float32, device=dev)
    act = torch.as_tensor(rng.uniform(size=(B, K)) < 0.8, device=dev)
    eq = torch.as_tensor(rng.uniform(size=(B, K)) < 0.1, device=dev)
    return (A, diag, rhs, act, eq, K, 1.0, 16, 0.3, 0.45)


@pytest.mark.parametrize("block,pyramid_mu", [(True, 0.0), (False, 0.5), (True, 0.5)],
                         ids=["block", "pyramid", "block_pyramid"])
def test_packed_block_and_pyramid_kernels_match_plain(dev, block, pyramid_mu):
    lcp = _random_packed_lcp(dev)
    counters = (solve_lcp_jacobi_packed, solve_lcp_jacobi_packed_block,
                solve_lcp_jacobi_packed_pyramid)
    before = [f.launches for f in counters]
    got = solve_lcp_jacobi_packed(*lcp, block=block, pyramid_mu=pyramid_mu)
    want = solve_lcp_jacobi_packed_plain(*lcp, block, pyramid_mu)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [0, int(block), int(not block)]
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


_FORMS = [(False, 0.0), (True, 0.0), (False, 0.5), (True, 0.5)]


@pytest.mark.parametrize("B", [1, 133, 4096])
@pytest.mark.parametrize("K", [8, 20, 32, 45, 64], ids=["mp24", "mp64", "mp96", "mp136", "mp192"])
def test_packed_forms_match_plain_at_every_row_length(dev, K, B):
    """B6's four forms at register row lengths 32, 64, 96 and 128 (mp 136
    and 192 read rows from shared memory), with B = 133 leaving the
    persistent grid a partial last wave; 80 % active and 10 % equality
    lanes."""
    lcp = _random_packed_lcp(dev, B=B, K=K, seed=K + B)
    for block, pyramid_mu in _FORMS:
        got = solve_lcp_jacobi_packed(*lcp, block=block, pyramid_mu=pyramid_mu, stream=False)
        want = solve_lcp_jacobi_packed_plain(*lcp, block, pyramid_mu)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        if block or pyramid_mu:
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        else:
            _close((got,), (want,), rel=1e-4)


def test_block_jacobi_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(1)
    B, m = 512, 60
    G = torch.randn(B, m, 24, generator=g)
    A = (G @ G.transpose(-1, -2) / 24 + torch.eye(m)).to(dev)
    b = torch.randn(B, m, generator=g).to(dev)
    row = torch.arange(m)
    is_eq = (row % 10 == 9).expand(B, m).contiguous().to(dev)
    lo = torch.where(row % 3 == 2, 0.0, -1.0).expand(B, m).contiguous().to(dev)
    hi = torch.where(row % 3 == 2, float("inf"), 1.0).expand(B, m).contiguous().to(dev)
    before = (solve_lcp_jacobi.launches, solve_lcp_jacobi_block.launches)
    got = solve_lcp_jacobi(A, b, is_eq, lo, hi, 16, 0.5, 0.45, block=True)
    want = solve_lcp_jacobi_plain(A, b, is_eq, lo, hi, 16, 0.5, block=True)
    torch.cuda.synchronize()
    assert (solve_lcp_jacobi.launches - before[0], solve_lcp_jacobi_block.launches - before[1]) \
        == (0, 1)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_fdtd_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    n = 300
    f = init_2d(n, n, device=dev)
    f = f._replace(**{k: torch.as_tensor(rng.normal(size=tuple(x.shape)), dtype=torch.float32,
                                         device=dev) for k, x in f._asdict().items()})
    eps_r = torch.as_tensor(rng.uniform(1.0, 4.0, (n, n)), dtype=torch.float32, device=dev)
    pec = torch.as_tensor(rng.uniform(size=(n, n)) < 0.05, device=dev)
    grids = fused_grids(f, eps_r, pec)
    before = step_2d_fused.launches
    got = step_2d_fused(*grids, 1e-3, 4e-3)
    want = step_2d_fused_plain(*grids, 1e-3, 4e-3)
    torch.cuda.synchronize()
    assert step_2d_fused.launches == before + 1
    scale = float(want[0].abs().max())
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-6 * scale
    assert bool((got[0][pec] == 0).all())


@pytest.mark.parametrize("case", ["pyramid", "block"])
def test_fused_slice_goes_through_its_b6_form(dev, case):
    from eggshell_tpu_torch.utils.config import FrictionModel

    cfg = (BENCH.replace(friction_model=FrictionModel.COULOMB_PYRAMID) if case == "pyramid"
           else BENCH.replace(jacobi_block=True))
    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    states = State(*[x.expand((64,) + x.shape).clone() for x in st])
    wrappers = (solve_lcp_jacobi_packed, solve_lcp_jacobi_packed_block,
                solve_lcp_jacobi_packed_pyramid, integrate_step)
    before = [f.launches for f in wrappers]
    out = rollout_batched(spec, states, cfg, 5)
    torch.cuda.synchronize()
    want = [0, 5, 0, 5] if case == "block" else [0, 0, 5, 5]
    assert [f.launches - b for f, b in zip(wrappers, before)] == want
    assert all(bool(torch.isfinite(x).all()) for x in out)


def _prep_args(dev, B, n, ext, seed=0):
    """Seeded bodies for B1: body 0 static (inverse mass and inertia 0)
    where n > 1, the bench's dt and gravity, ext_forces or None."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    q = rng.normal(size=(B, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    G = rng.normal(size=(n, 3, 3))
    Ib = G @ G.transpose(0, 2, 1) + np.eye(3)
    invIb = np.linalg.inv(Ib)
    inv_mass = rng.uniform(0.5, 2.0, n)
    if n > 1:
        inv_mass[0], invIb[0] = 0.0, 0.0
    return (f(q), f(rng.normal(size=(B, n, 3))), f(rng.normal(size=(B, n, 3))), f(inv_mass),
            f(Ib), f(invIb), 1e-3, (0.0, 0.0, -9.8),
            f(rng.normal(size=(B, n, 6))) if ext else None)


@pytest.mark.parametrize("ext", [False, True], ids=["gravity", "ext_forces"])
@pytest.mark.parametrize("n", [1, 4, 7, 8, 64])
def test_prep_kernel_gives_the_plain_versions_bits(dev, n, ext):
    """B1 at B = 523 (a ragged last tile, and every tile size the plan
    takes over n = 1 to 64) returns the plain version's bits."""
    args = _prep_args(dev, 523, n, ext, seed=n)
    before = prep_bodies.launches
    got = prep_bodies(*args)
    torch.cuda.synchronize()
    assert prep_bodies.launches == before + 1
    assert _same_bits(got, prep_bodies_plain(*args))


@pytest.mark.parametrize("what", ["q", "v", "w", "ext_forces", "all"])
def test_prep_kernel_takes_views_at_an_offset(dev, what):
    """An input that starts 4 bytes past its allocation is copied in 4-byte
    pieces, with the plain version's bits; a tile the C entry does not
    take launches nothing and raises."""
    from eggshell_tpu_torch import kernels

    args = list(_prep_args(dev, 301, 7, True, seed=3))
    for i, name in enumerate(("q", "v", "w")):
        if what in (name, "all"):
            args[i] = _at_offset(args[i])
    if what in ("ext_forces", "all"):
        args[8] = _at_offset(args[8])
    assert _same_bits(prep_bodies(*args), prep_bodies_plain(*args))
    outs = [torch.empty(301, 7, k, device=dev) for k in (6, 9, 6)]
    with pytest.raises(RuntimeError):
        kernels.launch("eggshell_prep_f32", dev, *args[:3], args[8], *args[3:6], *outs, 301, 7,
                       1e3, 0.0, 0.0, -9.8, 48)


# case: (BASELINE scene, configuration or None for the scene's, the launch
# counters of its path); bench (B3, B2p), box_drop (B3g), pendulum_chain6
# (the joint lanes' torch glue), slice_pyramid (B6's pyramid form)
GRAPH_CASES = {
    "bench": ("box_stack4", None, ("narrowphase_packed", "compact", "prep", "jassembly", "amat",
                                   "jacobi_packed", "integrate")),
    "box_drop": ("box_drop", None, ("compact", "prep", "jassembly", "amat", "jacobi_packed",
                                    "integrate")),
    "pendulum_chain6": ("pendulum_chain6", None, ("compact", "prep", "jassembly", "amat",
                                                  "jacobi_packed", "integrate")),
    "slice_pyramid": ("box_stack4", "pyramid", ("narrowphase_packed", "compact", "prep",
                                                "jassembly", "amat", "jacobi_packed_pyramid",
                                                "integrate")),
    "living_room_bp": ("living_room", "broadphase", ("narrowphase_packed", "compact", "prep",
                                                     "jassembly", "amat", "jacobi_packed",
                                                     "integrate")),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_rollout_is_bit_for_bit_the_loop(dev, case):
    """The captured rollout returns the eager loop's
    bits, counts H launches of each kernel of its path and none of any
    other, leaves the caller's states as they were, returns tensors that
    a later replay does not overwrite, and replays from its cache."""
    from eggshell_tpu_torch.ops import launch_counters
    from eggshell_tpu_torch.parallel.rollout import clear_graphs, rollout_batched_monitored
    from eggshell_tpu_torch.utils.config import FrictionModel

    scene, form, path = GRAPH_CASES[case]
    spec, states, cfg = scenes.baseline_batch(scene, 256, device=dev)
    if form == "pyramid":
        cfg = cfg.replace(friction_model=FrictionModel.COULOMB_PYRAMID)
    if form == "broadphase":
        cfg = cfg.replace(pair_capacity=6, broadphase_margin=0.1)
    start = State(*(x.clone() for x in states))
    H = 7
    eager = rollout_batched(spec, states, cfg, H, graph=False)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    got = rollout_batched(spec, states, cfg, H, graph=True)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in counters.items()} == \
        {k: H if k in path else 0 for k in counters}
    assert _same_bits(got, eager)
    assert _same_bits(states, start)
    again = rollout_batched(spec, got, cfg, H, graph=True)
    assert _same_bits(got, eager) and not _same_bits(again, got)
    final, diag = rollout_batched_monitored(spec, states, cfg, H, graph=True)
    assert _same_bits(final, eager)
    assert int(diag["diverged_count"]) == 0 and bool((diag["first_bad_step"] == H).all())
    clear_graphs()


def test_graph_monitor_is_bit_for_bit_the_loop(dev):
    """The monitor inside the graph: scenarios poisoned with v = 1e9 are
    flagged at step 0 and frozen, exactly as in the loop."""
    from eggshell_tpu_torch.parallel.rollout import clear_graphs, rollout_batched_monitored

    spec, states, cfg = scenes.baseline_batch("box_stack4", 256, device=dev)
    poisoned = torch.zeros(256, dtype=torch.bool, device=dev)
    poisoned[1::50] = True
    states = states._replace(v=torch.where(poisoned[:, None, None], 1e9, states.v))
    want, wdiag = rollout_batched_monitored(spec, states, cfg, 9, graph=False)
    got, diag = rollout_batched_monitored(spec, states, cfg, 9, graph=True)
    assert _same_bits(got, want)
    for k in ("diverged", "diverged_count", "first_bad_step"):
        assert torch.equal(diag[k], wdiag[k]), k
    assert torch.equal(diag["diverged"], poisoned)
    assert bool((diag["first_bad_step"][poisoned] == 0).all())
    clear_graphs()


def test_a_rollout_outside_the_capture_rule_loops_and_says_so(dev):
    """The unfused conditional-CFM slice is outside `graph_capturable`: its
    rollout runs the loop with a RolloutLoopWarning, and a forced capture
    raises."""
    from eggshell_tpu_torch.parallel.rollout import RolloutLoopWarning, graph_capturable

    cfg = BENCH.replace(conditional_cfm=True, cond_estimator="power")
    assert not graph_capturable(cfg)
    spec, states, _ = scenes.baseline_batch("box_stack4", 64, device=dev)
    with pytest.warns(RolloutLoopWarning, match="Python loop"):
        got = rollout_batched(spec, states, cfg, 2)
    assert _same_bits(got, rollout_batched(spec, states, cfg, 2, graph=False))
    with pytest.raises(ValueError, match="cannot capture"):
        rollout_batched(spec, states, cfg, 2, graph=True)


def _mpc_cell(dev):
    """living_room under the bench configuration at contact_capacity 32,
    the MPC cell's (bench.py:181-218) cost, at S = 64 and H = 5."""
    spec, st = scenes.living_room(device=dev, dtype=torch.float32)
    target = torch.tensor([0.0, 0.0, 0.5], device=dev)

    def cost(final):
        return torch.sum((final.p[4] - target) ** 2)

    return spec, st, BENCH.replace(contact_capacity=32), cost


MPC_PATH = ("narrowphase_packed", "compact", "prep", "jassembly", "amat", "jacobi_packed",
            "integrate")


def test_captured_mppi_update_is_bit_for_bit_the_loop(dev):
    """The captured MPPI update (the control slot filled inside the graph)
    gives the eager loop's bits in the new mean and the costs, counts H
    launches of each kernel of the fused path and none of any other, and a
    controlled rollout with a running cost and 2 substeps gives the loop's
    bits in its states and its running cost."""
    from eggshell_tpu_torch.mpc.sampling import (_sample, mppi_update_batched,
                                                 rollout_controlled_batched)
    from eggshell_tpu_torch.ops import launch_counters
    from eggshell_tpu_torch.parallel.rollout import clear_graphs

    spec, st, cfg, cost = _mpc_cell(dev)
    S, H = 64, 5
    mean = torch.zeros((H, 6), device=dev)

    def update(graph):
        gen = torch.Generator(device=dev).manual_seed(0)
        return mppi_update_batched(spec, st, cfg, mean, gen, cost, controlled_body=4,
                                   num_samples=S, noise_sigma=5.0, noise_mode="constant",
                                   graph=graph)

    want = update(False)
    update(True)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    got = update(True)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in counters.items()} == \
        {k: H if k in MPC_PATH else 0 for k in counters}
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool(torch.isfinite(got[1]).all())

    ctrls = _sample(mean, torch.Generator(device=dev).manual_seed(1), S, 5.0, "white")
    states = State(*(x.expand((S,) + x.shape) for x in st))
    eager = rollout_controlled_batched(spec, states, cfg, ctrls, 4, cost, 2, graph=False)
    captured = rollout_controlled_batched(spec, states, cfg, ctrls, 4, cost, 2, graph=True)
    assert _same_bits(captured[0], eager[0]) and torch.equal(captured[1], eager[1])
    clear_graphs()


def test_controlled_rollout_outside_the_capture_rule_loops_and_says_so(dev):
    """An unfused configuration's controlled rollout loops with a
    RolloutLoopWarning and refuses graph=True, as does graph=True on CPU
    tensors."""
    from eggshell_tpu_torch.mpc.sampling import rollout_controlled_batched
    from eggshell_tpu_torch.parallel.rollout import RolloutLoopWarning

    spec, st, cfg, _ = _mpc_cell(dev)
    unfused = cfg.replace(conditional_cfm=True, cond_estimator="power")
    states = State(*(x.expand((8,) + x.shape) for x in st))
    ctrls = torch.ones((8, 2, 6), device=dev)
    with pytest.warns(RolloutLoopWarning, match="Python loop"):
        got, _ = rollout_controlled_batched(spec, states, unfused, ctrls, 4)
    want, _ = rollout_controlled_batched(spec, states, unfused, ctrls, 4, graph=False)
    assert _same_bits(got, want)
    with pytest.raises(ValueError, match="cannot capture"):
        rollout_controlled_batched(spec, states, unfused, ctrls, 4, graph=True)
    cpu = State(*(x.cpu() for x in states))
    cspec = type(spec)(*(x.cpu() for x in spec))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        rollout_controlled_batched(cspec, cpu, cfg, ctrls.cpu(), 4, graph=True)


def _pile27(dev, B, seed=0):
    """B scenarios of a compressed box_pile(27), float32 on the card: each
    box shifted by up to 2 mm and turned by up to about 0.05 rad (seeded),
    some 160 overlapping pairs of the 351 at margin 0.05."""
    spec, st = scenes.box_pile(27, spacing=0.97, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    n = spec.num_bodies
    p = st.p.cpu().double().numpy()[None] + rng.uniform(-2e-3, 2e-3, (B, n, 3))
    p[..., 2] -= 3e-3
    phi = rng.uniform(-0.05, 0.05, (B, n, 3))
    ang = np.linalg.norm(phi, axis=-1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * phi / ang], -1)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    z = torch.zeros((B, n, 3), device=dev)
    return spec, State(p=f(p), v=z, q=f(q), w=z.clone())


def test_gated_narrowphase_and_compaction_match_plain(dev):
    """B2p and B3 on each scenario's broadphase pair list (S = 64, pair
    capacity 200 above the overlapping pairs, so gated-off self-pairs
    (0, 0) exist): B2p bit for bit the lanes entry on the gathered pairs
    with the gate applied, no active lane on a gated-off pair; B3 on those
    lanes the plain version's ids and flags, geometry within 1e-6."""
    from eggshell_tpu_torch.ops.broadphase import select_scene_pairs

    spec, st = _pile27(dev, 64)
    cfg = SimConfig(contact_capacity=256, pair_capacity=200, broadphase_margin=0.05)
    pi, pj, gate = select_scene_pairs(spec, st, cfg)
    assert not bool(gate.all()) and bool(gate.any())
    before = collide_boxes_lanes_packed.launches
    got = collide_boxes_lanes_packed(st.p, st.q, spec.half_extents, pi, pj, gate)
    assert collide_boxes_lanes_packed.launches == before + 1
    lanes = collide_boxes_lanes(*gather_pairs(st.p, quat_to_mat(st.q), spec.half_extents, pi, pj))
    B, P = pi.shape
    assert torch.equal(got[0], lanes.position.reshape(B, P, 12, 3))
    assert torch.equal(got[1], lanes.normal[:, 0].reshape(B, P, 3))
    assert torch.equal(got[2], lanes.depth.reshape(B, P, 12))
    assert torch.equal(got[3], lanes.active.reshape(B, P, 12) & gate[..., None])
    assert not bool(got[3][~gate].any()) and bool(lanes.active.reshape(B, P, 12)[~gate].any())
    want = collide_boxes_lanes_packed_plain(st.p, st.q, spec.half_extents, pi, pj, gate)
    normal_ok = (got[1] - want[1]).abs().amax(-1) <= 1e-4
    assert float(normal_ok.float().mean()) >= 0.99
    assert float((got[3] == want[3])[normal_ok].float().mean()) >= 0.99
    args = (st.p, st.q, spec.half_extents, spec.ground_enabled, got, pi, pj, 256,
            cfg.min_constraint_distance ** 2, 0.05)
    cs = compact_contacts(*args)
    plain = compact_contacts_plain(*args)
    for k in ("b0", "b1", "active"):
        assert torch.equal(getattr(cs, k), getattr(plain, k)), k
    for k in ("position", "normal", "depth"):
        assert float((getattr(cs, k) - getattr(plain, k)).abs().max()) <= 1e-6, k
    assert int(cs.active.sum(1).min()) > 100


def test_captured_matrix_free_rollout_is_bit_for_bit_the_loop(dev):
    """The matrix-free step (box_pile(27), B = 3, K = 256, pair capacity
    128, 40 sweeps, the "auto" matvec form) captures: the replayed rollout
    gives the loop's bits and counts one B2 launch a step and nothing
    else."""
    from eggshell_tpu_torch.ops import launch_counters
    from eggshell_tpu_torch.parallel.rollout import clear_graphs, graph_capturable

    spec, st = _pile27(dev, 3)
    cfg = BENCH.replace(solver=SolverKind.MATRIX_FREE, solver_iters=40, contact_capacity=256,
                        pair_capacity=128, broadphase_margin=0.05, max_correcting_vel=2.0)
    assert graph_capturable(cfg)
    H = 5
    eager = rollout_batched(spec, st, cfg, H, graph=False)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    got = rollout_batched(spec, st, cfg, H, graph=True)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in counters.items()} == \
        {k: H if k == "narrowphase" else 0 for k in counters}
    assert _same_bits(got, eager)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    clear_graphs()


def test_narrowphase_backward_is_the_plain_versions_on_the_card(dev):
    """`collide_boxes_lanes_diff` launches B2 forward and gives autograd of
    the plain narrowphase backward: on tests/test_diff_kernel.py:147-187's
    five pairs its gradient within 1e-5 of the plain version's largest
    magnitude (the kernel's positions and normals, which the backward
    multiplies by, differ in the last bits; random poses are not used: a
    clip point on the reference face may be kept by one version only)."""
    from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes_diff

    rng = np.random.default_rng(3)
    p1 = rng.uniform(-0.1, 0.1, (5, 3))
    p2 = p1 + np.asarray([0.25, 0.0, 0.1]) + rng.uniform(-0.02, 0.02, (5, 3))
    q = rng.normal(size=(5, 4))
    f = lambda x: torch.as_tensor(np.array(x), dtype=torch.float32, device=dev).contiguous()
    R2 = quat_to_mat(f(q / np.linalg.norm(q, axis=-1, keepdims=True))).contiguous()
    pairs = (f(p1), f(np.broadcast_to(np.eye(3), (5, 3, 3))), f(np.full((5, 3), 0.15)), f(p2),
             R2, f(np.full((5, 3), 0.15)))

    def grads(fn):
        args = [x.clone() for x in pairs]
        args[0].requires_grad_()
        args[4].requires_grad_()
        out = fn(*args)
        zero = torch.zeros((), device=dev)
        (torch.sum(torch.where(out.active, out.depth, zero))
         + torch.sum(out.position * out.normal)).backward()
        return args[0].grad, args[4].grad

    before = collide_boxes_lanes.launches
    got = grads(collide_boxes_lanes_diff)
    assert collide_boxes_lanes.launches == before + 1
    want = grads(collide_boxes)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert scale > 0 and float((g - w).abs().max()) <= 1e-5 * scale


def test_a_kernel_refuses_a_tensor_that_requires_grad(dev):
    """A wrapper launched with a tensor that requires grad raises instead of
    returning a gradient that stops at the kernel; under no_grad, or inside
    the fused step's Function, it launches."""
    args = _pairs(64, dev)
    p1 = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        collide_boxes_lanes(p1, *args[1:])
    with torch.no_grad():
        collide_boxes_lanes(p1, *args[1:])
    spec, states, cfg = scenes.baseline_batch("box_stack4", 64, device=dev)
    e = torch.zeros(states.p.shape[:2] + (6,), device=dev, requires_grad=True)
    from eggshell_tpu_torch.physics.stepper import step_ode_batched

    out = step_ode_batched(spec, states, cfg, e)
    torch.sum(out.p[:, -1, 2]).backward()
    assert torch.isfinite(e.grad).all() and float(e.grad.abs().max()) > 0
    unfused = BENCH.replace(conditional_cfm=True, cond_estimator="power")
    with pytest.raises(RuntimeError, match="requires grad"):
        step_ode_batched(spec, states, unfused, e)


def test_stabilizer_counts_b2_once_a_detection(dev):
    """init_stabilize on the hanging chain with its link pairs, float32 on the
    card: B2 launches once for each contact detection (iterations + 1) and
    the iteration count is the CPU float32 plain path's."""
    from eggshell_tpu_torch.physics import stepper

    def pulled(device):
        spec, st = scenes.chain(6, collide=True, device=device, dtype=torch.float32)
        p = st.p.clone()
        p[2, 1] += 0.05
        return spec, st._replace(p=p)

    cfg = SimConfig(contact_capacity=16)
    before = collide_boxes_lanes.launches
    got, iters = stepper.init_stabilize(*pulled(dev), cfg, return_iterations=True)
    assert collide_boxes_lanes.launches - before == iters + 1
    _, want = stepper.init_stabilize(*pulled("cpu"), cfg, return_iterations=True)
    assert iters == want


def test_stabilizer_float64_box_pairs_take_the_plain_narrowphase(dev):
    """box_stack(3) sunk 1 mm into the floor, float64 on the card: its box
    pairs take the plain narrowphase (B2 is float32 only), B2 unlaunched;
    the state within 1e-10 of the CPU's after the same iterations.
    contact_kernel=True on float64 raises."""
    from eggshell_tpu_torch.physics import stepper

    def sunk(device):
        spec, st = scenes.box_stack(3, device=device, dtype=torch.float64)
        return spec, st._replace(p=st.p - torch.tensor([0.0, 0.0, 1e-3], dtype=torch.float64,
                                                       device=device))

    cfg = SimConfig(contact_capacity=24)
    before = collide_boxes_lanes.launches
    got, iters = stepper.init_stabilize(*sunk(dev), cfg, return_iterations=True)
    assert collide_boxes_lanes.launches == before
    want, citers = stepper.init_stabilize(*sunk("cpu"), cfg, return_iterations=True)
    assert iters == citers
    for k in ("p", "v", "q", "w"):
        np.testing.assert_allclose(getattr(got, k).cpu().numpy(), getattr(want, k).numpy(),
                                   rtol=0, atol=1e-10, err_msg=k)
    with pytest.raises(ValueError, match="float32"):
        stepper.init_stabilize(*sunk(dev), cfg.replace(contact_kernel=True))


def test_implicit_midpoint_launches_b2_once_a_step(dev):
    from eggshell_tpu_torch.physics import stepper

    cfg = BENCH.replace(solver=SolverKind.JACOBI)
    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    cspec, cst = scenes.box_stack(4, device="cpu", dtype=torch.float64)
    before = collide_boxes_lanes.launches
    for _ in range(3):
        st, _ = stepper.step_implicit_midpoint(spec, st, cfg)
        cst, _ = stepper.step_implicit_midpoint(cspec, cst, cfg)
    assert collide_boxes_lanes.launches - before == 3
    assert float((st.p.double().cpu() - cst.p).abs().max()) <= 2e-3


def test_fem_solves_on_the_card_match_the_host_solve(dev):
    """A small guide: the BCR and BiCGStab on the card against the host
    SuperLU, complex128, and the SuperLU's solution back on the card."""
    from eggshell_tpu_torch.fem.helmholtz import FemConfig, make_driven_fn, mesh_tensors
    from eggshell_tpu_torch.fem.mesher import mesh_structured
    from eggshell_tpu_torch.fem.shape import Rectangle

    cd = Rectangle(0.0, 0.0, 20.0, 3.0)
    cd.Port((0.0, 0.0), (0.0, 3.0), 1)
    cd.Port((20.0, 0.0), (20.0, 3.0), 2)
    mesh = mesh_structured(cd, (0.0, 0.0), (20.0, 0.0), (0.0, 3.0), 0.3)
    cfg = FemConfig(type="EZ", frequency=75e9, unit=1e-3)
    ref, _ = make_driven_fn(mesh, cfg, solver="sparse")
    u_ref, _ = ref(*mesh_tensors(mesh, device="cpu"), cfg.k0)
    for solver, tol in (("bcr", 1e-10), ("bicgstab", 1e-6), ("sparse", 1e-12)):
        fn, _ = make_driven_fn(mesh, cfg, solver=solver)
        u, s = fn(*mesh_tensors(mesh, device=dev), cfg.k0)
        assert u.device.type == "cuda" and s.device.type == "cuda"
        assert float((u.cpu() - u_ref).abs().max()) <= tol * float(u_ref.abs().max()), solver
