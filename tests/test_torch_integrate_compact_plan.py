"""The integrate kernel's launch plan, and the warp-level steps of the
integrate (B7) and compaction (B3, B3g) kernels replayed on the CPU.

`csrc/integrate.cu` spreads J^T lambda over the lanes: one thread a
(scenario, lane, slot) forms the slot's products (l0 J0 + l1 J1) + l2 J2,
then one thread a (scenario, body, component) sums them in lane order, slot
0 before slot 1, adding only where the slot names its body; the chunk
route carries the sums from one lane chunk to the next.
`integrate_launch_plan` names the tile.  The replay below follows those
steps in float32 and must give `integrate_step_plain`'s bits, -0 included.

`csrc/compact.cu` runs a scenario on one warp: a lane takes g consecutive
corners of one body (g = 1, 2, 4 or 8 by the body count), lanes hold the
pair flags as 32-bit words (up to 4 consecutive words a lane), a count of
the active candidates in the lanes below (ballots, or a warp scan) gives
each active candidate its slot, the landing pair candidates' geometry is
read a slot a lane, and the dedupe tests of the pair lanes are spread over
the 32 lanes (test t = k(k-1)/2 + j on lane t % 32) and OR-ed into a drop
mask.  The replay follows those steps lane by lane and must give
`compact_contacts_plain`'s ids, flags and geometry bit for bit.

These checks need no card: the kernels themselves are held against the
plain versions on the card in `tests/test_torch_kernels.py`.
"""

import numpy as np
import pytest
import torch

from eggshell_tpu_torch.kernels import MAX_SHARED_BYTES
from eggshell_tpu_torch.ops.collision_poses import pair_list, random_bodies
from eggshell_tpu_torch.ops.compact_kernel import compact_contacts_plain
from eggshell_tpu_torch.ops.integrate_kernel import (INTEGRATE_THREADS, integrate_bodies_plain,
                                                     integrate_launch_plan,
                                                     integrate_shared_bytes,
                                                     integrate_step_plain, jt_lambda_plain)
from eggshell_tpu_torch.physics import scenes
from torch_limits import time_limit  # noqa: F401

f32 = np.float32
SMS = 132
# The warps in flight of the kernel B7 replaces: one thread a body, 128 a
# block, at the bench shape (B = 4096, n = 4).
PARENT_WARPS = 4096 * 4 // 32


def _lanes_of(scene: str):
    """(K lanes with the joints, n bodies) of a BASELINE scene's fused step."""
    spec, st, cfg = scenes.baseline_batch(scene, 1, device="cpu")
    return cfg.contact_capacity + spec.num_joints, st.p.shape[1]


PLAN_SHAPES = {
    "bench": (4096, 20, 4), "box_stack8": (4096, 32, 8), "wide K=64": (4096, 64, 8),
    "Jc-chunk K=400": (8, 400, 8), "K=400 at B=4096": (4096, 400, 8),
    "n=64": (4096, 20, 64), "K=400, n=64": (4096, 400, 64), "K=2048, n=64": (64, 2048, 64),
    "n=300": (16, 20, 300),
    "living_room": (4096, *_lanes_of("living_room")),
    "pendulum_chain6": (4096, *_lanes_of("pendulum_chain6")),
    "box_drop": (4096, *_lanes_of("box_drop")),
}


@pytest.mark.parametrize("shape", list(PLAN_SHAPES.values()), ids=list(PLAN_SHAPES))
def test_the_integrate_plan_takes_the_shape_within_a_block(shape):
    B, K, n = shape
    plan = integrate_launch_plan(B, K, n)
    assert plan.shared_bytes == integrate_shared_bytes(plan.scenarios, plan.lanes, plan.bodies)
    assert plan.shared_bytes <= MAX_SHARED_BYTES
    assert plan.threads == INTEGRATE_THREADS and plan.threads % 32 == 0
    assert 1 <= plan.scenarios <= B and 1 <= plan.lanes <= K and 1 <= plan.bodies <= n
    if (plan.lanes, plan.bodies) != (K, n):
        assert plan.scenarios == 1      # the chunk route: one scenario a block
    blocks = -(-B // plan.scenarios)
    if B == 4096:
        # every SM gets blocks, and more warps are in flight than the
        # parent kernel's one thread a body
        assert blocks >= SMS
        assert blocks * plan.threads // 32 >= PARENT_WARPS


def _whole(shape) -> bool:
    """Whether the plan of (B, K, n) takes every lane and body in one
    chunk."""
    B, K, n = shape
    plan = integrate_launch_plan(B, K, n)
    return (plan.lanes, plan.bodies) == (K, n)


def test_the_scenes_and_the_bench_take_the_whole_route():
    for name in ("bench", "box_stack8", "wide K=64", "Jc-chunk K=400", "K=400, n=64",
                 "living_room", "pendulum_chain6", "box_drop"):
        assert _whole(PLAN_SHAPES[name]), name
    assert not _whole(PLAN_SHAPES["K=2048, n=64"])


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=f32)).view(np.int32)


def _integrate_inputs(B, K, n, L, seed):
    """Seeded float32 inputs of B7: ground slots, idle lanes, lanes whose
    two slots name one body, lambda = -0 on some rows, a lambda stride L."""
    rng = np.random.default_rng(seed)
    b0 = rng.integers(-1, n, size=(B, K))
    b1 = rng.integers(0, n, size=(B, K))
    same = rng.uniform(size=(B, K)) < 0.15
    b1[same] = np.maximum(b0[same], 0)
    b0[same] = b1[same]
    idle = rng.uniform(size=(B, K)) < 0.1
    b0[idle] = b1[idle] = -1
    lam = rng.normal(size=(B, L)).astype(f32)
    lam[rng.uniform(size=(B, L)) < 0.1] = f32(-0.0)
    q = rng.normal(size=(B, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    G = rng.normal(size=(B, n, 3, 3))
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=f32))
    return (t(rng.normal(size=(B, 3 * K, 12))), torch.as_tensor(lam), torch.as_tensor(b0),
            torch.as_tensor(b1), t(rng.normal(size=(B, n, 3))), t(q),
            t(rng.normal(size=(B, n, 3))), t(rng.normal(size=(B, n, 3))),
            t(rng.uniform(0.5, 2.0, n)), t(G @ G.transpose(0, 1, 3, 2)),
            t(rng.normal(size=(B, n, 6))), 1e-3)


def _staged_jt_lambda(Jc, lam, b0, b1, n, lanes, bodies):
    """csrc/integrate.cu's J^T lambda, in float32: per lane chunk, the
    products of each (lane, slot), zero on a ground slot, then each (body,
    component) adds them in lane order, slot 0 before slot 1, where the
    slot names the body, onto the sum carried from the earlier chunks."""
    B, K = b0.shape
    J = Jc.numpy().reshape(B, K, 3, 12)
    lm = lam.numpy()[:, :3 * K].reshape(B, K, 3)
    ids = np.stack([b0.numpy(), b1.numpy()], -1)                       # (B, K, 2)
    jtl = np.zeros((B, n, 6), dtype=f32)
    for n0 in range(0, n, bodies):
        mine = np.arange(n0, min(n, n0 + bodies))
        for k0 in range(0, K, lanes):
            kc = min(lanes, K - k0)
            l0, l1, l2 = (lm[:, k0:k0 + kc, r, None, None] for r in range(3))
            Jk = J[:, k0:k0 + kc].reshape(B, kc, 3, 2, 6)
            con = (l0 * Jk[:, :, 0] + l1 * Jk[:, :, 1]) + l2 * Jk[:, :, 2]  # (B, kc, 2, 6)
            ck = ids[:, k0:k0 + kc]
            con = np.where((ck < 0)[..., None], f32(0), con).reshape(B, 2 * kc, 6)
            ck = ck.reshape(B, 2 * kc)
            acc = jtl[:, mine]                  # each body of the chunk at once
            for e in range(2 * kc):
                hit = (ck[:, e, None] == mine)[..., None]
                acc = np.where(hit, acc + con[:, e, None], acc)
            jtl[:, mine] = acc
    return jtl


INTEGRATE_CASES = {
    # B, K, n, lambda rows, forced (lanes, bodies) chunks or None: the plan's
    "bench": (64, 20, 4, 64, None),
    "box_stack8": (32, 32, 8, 96, None),
    "K=64, lambda stride 200": (8, 64, 8, 200, None),
    "K=400": (2, 400, 8, 1200, None),
    "n=64": (4, 24, 64, 72, None),
    "lane and body chunks": (16, 20, 5, 61, (3, 2)),
    "the plan's lane chunks, K=2048, n=64": (2, 2048, 64, 6144, None),
    "the plan's lane and body chunks, K=700, n=300": (1, 700, 300, 2100, None),
}


@pytest.mark.parametrize("case", list(INTEGRATE_CASES.values()), ids=list(INTEGRATE_CASES))
def test_the_staged_reduction_gives_the_plain_versions_bits(case):
    B, K, n, L, chunks = case
    args = _integrate_inputs(B, K, n, L, seed=K + n)
    Jc, lam, b0, b1 = args[:4]
    plan = integrate_launch_plan(B, K, n)
    lanes, bodies = chunks or (plan.lanes, plan.bodies)
    staged = _staged_jt_lambda(Jc, lam, b0, b1, n, lanes, bodies)
    plain = jt_lambda_plain(Jc, lam, b0, b1, n)
    assert np.array_equal(_bits(staged), _bits(plain))
    got = integrate_bodies_plain(torch.from_numpy(staged), *args[4:])
    want = integrate_step_plain(*args)
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))
    # the cases reach what they are there for
    assert bool(((b0 == b1) & (b0 >= 0)).any()) and bool((b0 == -1).any())
    assert bool((lam[:, :3 * K] == 0).any())


def _popc(x: int) -> int:
    return bin(x).count("1")


def _exclusive(counts):
    out, run = [], 0
    for c in counts:
        out.append(run)
        run += c
    return out, run


def _replay_compact(p, q, hs, gen, pair, pi, pj, K, eps2, cap):
    """csrc/compact.cu lane by lane, in float32; returns the ContactSet's
    fields as numpy arrays."""
    B, n = p.shape[:2]
    cap = f32(np.inf if cap is None else cap)
    one, two = f32(1), f32(2)
    P = 0 if pair is None else pi.shape[0]
    out = dict(b0=np.full((B, K), -1, np.int64), b1=np.full((B, K), -1, np.int64),
               position=np.zeros((B, K, 3), f32), normal=np.zeros((B, K, 3), f32),
               depth=np.zeros((B, K), f32), active=np.zeros((B, K), bool))
    if P:
        ppos, pnrm, pdep, pact = (x.numpy() for x in pair)
    for s in range(B):
        sb0, sb1 = [0] * K, [0] * K
        spos, snrm, sdep = np.zeros((K, 3), f32), np.zeros((K, 3), f32), np.zeros(K, f32)
        filled = 0
        g = 1 if n <= 4 else 2 if n <= 8 else 4 if n <= 16 else 8
        for c0 in range(0, 8 * n, 32 * g):
            frames = {}             # each body's R, as the lanes of its corners form it
            for ib in range(c0 // 8, min(n, c0 // 8 + 4 * g)):
                qw, qx, qy, qz = q[s, ib]
                xx, yy, zz = qx * qx, qy * qy, qz * qz
                xy, xz, yz = qx * qy, qx * qz, qy * qz
                wx, wy, wz = qw * qx, qw * qy, qw * qz
                frames[ib] = (one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
                              two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
                              two * (xz - wy), two * (yz + wx), one - two * (xx + yy))

            def corner_of(c):
                i, corner = divmod(c, 8)
                R = frames[i]
                o = [(one if corner & bit else -one) * hs[i, a]
                     for a, bit in enumerate((4, 2, 1))]
                return i, [p[s, i, r] + R[3 * r] * o[0] + R[3 * r + 1] * o[1] + R[3 * r + 2] * o[2]
                           for r in range(3)]

            masks = []
            for lane in range(32):  # g consecutive corners a lane
                c, mask = c0 + lane * g, 0
                for j in range(g):
                    if c + j < 8 * n:
                        i, corner = corner_of(c + j)
                        if corner[2] < 0 and gen[i]:
                            mask |= 1 << j
                masks.append(mask)
            offs, total = _exclusive([_popc(m) for m in masks])
            for lane in range(32):
                slot = filled + offs[lane]
                for j in range(g):
                    if not masks[lane] >> j & 1 or slot >= K:
                        continue
                    i, c = corner_of(c0 + lane * g + j)
                    sb0[slot], sb1[slot] = -1, i
                    spos[slot], snrm[slot] = c, (0, 0, 1)
                    sdep[slot] = min(-c[2], cap)
                    slot += 1
            filled += total
        ng = min(filled, K)          # ground lanes: the first ng
        if P:
            words = np.ascontiguousarray(pact[s].astype(np.uint8)).reshape(-1).view("<u4")
            W = 3 * P
            wpl = 4 if W > 128 else -(-W // 32)
            for w0 in range(0, W, 32 * wpl):
                masks = []
                for lane in range(32):
                    mask = 0
                    for j in range(wpl):    # nonzero bytes: bit 28 + b of the product
                        idx = w0 + lane * wpl + j
                        word = int(words[idx]) if idx < W else 0
                        ones = sum(1 << (8 * b) for b in range(4) if word >> (8 * b) & 0xFF)
                        mask |= ((ones * 0x10204080) % 2 ** 32 >> 28) << (4 * j)
                    masks.append(mask)
                offs, total = _exclusive([_popc(m) for m in masks])
                for lane in range(32):
                    slot = filled + offs[lane]
                    for bit in range(16):
                        if masks[lane] >> bit & 1 and slot < K:
                            sb0[slot] = -2 - (4 * (w0 + lane * wpl + (bit >> 2)) + (bit & 3))
                            slot += 1
                filled += total
        nf = min(filled, K)
        for k in range(nf):          # round 2, a slot a lane
            if sb0[k] <= -2:
                c = -2 - sb0[k]
                pk = c // 12
                sb0[k], sb1[k] = int(pi[pk]), int(pj[pk])
                spos[k], snrm[k] = ppos[s, pk, c % 12], pnrm[s, pk]
                sdep[k] = min(pdep[s, pk, c % 12], cap)
        drop = set()
        np_ = nf - ng                # the pair lanes ng .. nf-1
        tests = np_ * (np_ - 1) // 2
        for lane in range(32):
            k = int((1 + np.sqrt(f32(8 * lane + 1))) * 0.5)
            j, t = lane - k * (k - 1) // 2, lane
            while t < tests:
                a, b = ng + k, ng + j
                lo, hi = min(sb0[a], sb1[a]), max(sb0[a], sb1[a])
                if lo >= 0 and (min(sb0[b], sb1[b]), max(sb0[b], sb1[b])) == (lo, hi):
                    d = spos[a] - spos[b]
                    if d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < eps2:
                        drop.add(a)
                t, j = t + 32, j + 32
                while j >= k:
                    j -= k
                    k += 1
        for k in range(nf):
            out["b0"][s, k], out["b1"][s, k] = sb0[k], sb1[k]
            out["position"][s, k], out["normal"][s, k] = spos[k], snrm[k]
            out["depth"][s, k] = sdep[k]
            out["active"][s, k] = k not in drop
    return out


def _compact_inputs(B, n, P_all, K, act_p, eps2, cap, clustered, ground_only, seed):
    rng = np.random.default_rng(seed)
    p, q, hs = random_bodies(rng, B, n, z=(0.0, 0.3))
    gen = np.ones(n, bool)
    gen[min(2, n - 1)] = False
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=f32))
    body = (t(p), t(q), t(hs), torch.as_tensor(gen))
    pi, pj = pair_list(n)
    pi, pj = pi[:P_all], pj[:P_all]
    P = len(pi)
    ids = (torch.as_tensor(pi), torch.as_tensor(pj))
    if ground_only:
        return (*body, None, *ids, K, eps2, cap)
    spread = rng.normal(size=(B, P, 12, 3))
    pos = rng.normal(size=(B, P, 1, 3)) + 0.01 * spread if clustered else spread
    nrm = rng.normal(size=(B, P, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pair = (t(pos), t(nrm), t(rng.uniform(0.0, 0.01, (B, P, 12))),
            torch.as_tensor(rng.uniform(size=(B, P, 12)) < act_p))
    return (*body, pair, *ids, K, eps2, cap)


COMPACT_CASES = {
    # B, n, pairs, K, activity, eps2, cap, clustered, ground only
    "overflow past K (bench widths)": (32, 4, 6, 20, 0.5, 1e-12, None, False, False),
    "clustered, min distance 0.05": (32, 4, 6, 32, 0.4, 0.05 ** 2, None, True, False),
    "depth cap 0.005": (32, 4, 6, 20, 0.3, 1e-12, 0.005, False, False),
    "ground only": (32, 4, 0, 8, 0.0, 1e-12, None, False, True),
    "K=64, box_stack8 widths": (16, 8, 28, 64, 0.3, 0.05 ** 2, None, True, False),
    "two rounds of flag words, 40 bodies": (4, 40, 50, 64, 0.2, 1e-12, None, False, False),
}


@pytest.mark.parametrize("case", list(COMPACT_CASES.values()), ids=list(COMPACT_CASES))
def test_the_warp_compaction_gives_the_plain_versions_lanes(case):
    B, n, P, K, act_p, eps2, cap, clustered, ground_only = case
    args = _compact_inputs(B, n, P, K, act_p, eps2, cap, clustered, ground_only, seed=n + P + K)
    p, q, hs, gen = (x.numpy() for x in args[:4])
    got = _replay_compact(p, q, hs, gen, args[4], args[5].numpy(), args[6].numpy(), K, eps2, cap)
    want = compact_contacts_plain(*args)
    for k in ("b0", "b1", "active"):
        assert np.array_equal(got[k], getattr(want, k).numpy()), k
    for k in ("position", "normal", "depth"):
        assert np.array_equal(_bits(got[k]), _bits(getattr(want, k))), k
    # the cases reach what they are there for
    filled = (want.b1 >= 0).sum(1)
    assert bool(want.active.any())
    if not ground_only and P:
        assert bool((filled == K).any())                               # K filled
    if clustered:
        assert bool(((want.b1 >= 0) & ~want.active).any())             # dedupe dropped
    if cap is not None:
        assert float(want.depth.max()) == pytest.approx(cap)
