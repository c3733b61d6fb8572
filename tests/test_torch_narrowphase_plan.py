"""The narrowphase kernels' launch plan, two of their warp-level steps
replayed on the CPU, and the degenerate poses they are held on.

`csrc/narrowphase.cu` runs one box pair on a group of G = 4 lanes of a
warp (`LANES_PER_PAIR`).  Two of its steps replace sequential code of the
plain version and must give the same bits:

- the clip's emission: each lane holds vertices lane, lane + G, ... of the
  polygon, two ballots and popcounts give each vertex its output slot, and
  each lane stores its vertex (v + 0.f) and its crossing point into a
  buffer of MAX_POLY slots that reads 0 at or past the new count.  The
  replay below follows those steps lane by lane and is held bit for bit
  against `ops.collision._clip_halfspace` (the one-hot emission) and
  against the one-hot sum the earlier kernel ran (acc = acc + ...);
- the axis scan: each lane offers its axes as (sep, index), a butterfly of
  xor shuffles keeps the larger sep and of equal seps the lower index, and
  a NaN sep or an invalid edge axis (sep = -BIG) is never taken; held
  against the sequential strict `>` scan from -BIG.

The poses of `ops.collision_poses.degenerate_bodies` are checked to give,
through the plain version, the contacts each class is there for.

These checks need no card: the kernels themselves are held against the
plain version on the card in `tests/test_torch_kernels.py`.
"""

import numpy as np
import pytest
import torch

from eggshell_tpu_torch.ops.amat_kernel import MAX_SHARED_BYTES
from eggshell_tpu_torch.ops.collision import MAX_POLY, _clip_halfspace
from eggshell_tpu_torch.ops.collision_kernel import (GROUP_BYTES, LANES_PER_PAIR, MAX_PAIRS,
                                                    NARROWPHASE_THREADS, collide_boxes_lanes,
                                                    collide_boxes_lanes_packed, gather_pairs,
                                                    narrowphase_launch_plan)
from eggshell_tpu_torch.ops.collision_poses import (POSE_CLASSES, class_agreement,
                                                    degenerate_args, pair_list)
from eggshell_tpu_torch.ops.quaternion import quat_to_mat
from torch_limits import time_limit  # noqa: F401

f32 = np.float32
BIG = f32(1e30)
NO_AXIS = 64


@pytest.mark.parametrize("N", [1, 2, 24_575, 24_576, 114_688, 2 ** 20])
def test_the_plan_covers_every_pair_and_fits_a_block(N):
    plan = narrowphase_launch_plan(N)
    pairs = plan.threads // plan.lanes
    assert plan.lanes == LANES_PER_PAIR and plan.threads == NARROWPHASE_THREADS
    assert plan.threads % 32 == 0 and 32 % plan.lanes == 0
    # every pair has a group, and no block is all tail
    assert plan.blocks * pairs >= N > (plan.blocks - 1) * pairs
    assert plan.blocks < 2 ** 31
    assert plan.shared_bytes == pairs * GROUP_BYTES <= 48 * 1024 <= MAX_SHARED_BYTES


@pytest.mark.parametrize("N", [0, -1, MAX_PAIRS + 1])
def test_the_plan_refuses_no_pairs_and_more_than_32_bits_index(N):
    with pytest.raises(ValueError):
        narrowphase_launch_plan(N)


# ---- the clip's emission ----

def _popc(x: int) -> int:
    return bin(x).count("1")


def scatter_clip(px, py, cnt, nx, ny, dclip, G=LANES_PER_PAIR):
    """One clip pass of one polygon as the kernel's group of G lanes runs
    it: px, py (MAX_POLY,) float32, cnt the vertex count, the halfspace
    nx x + ny y + dclip >= 0.  Returns (new px, new py, new count)."""
    NV = -(-MAX_POLY // G)
    # lane l's registers: vertex l + G s in slot s, 0 past MAX_POLY
    vert = lambda lane, s: lane + G * s
    reg = lambda a, v: a[v] if v < MAX_POLY else f32(0)
    kv = {(lane, s): reg(px, vert(lane, s)) * nx + reg(py, vert(lane, s)) * ny + dclip
          for lane in range(G) for s in range(NV)}
    lanes = {}
    for lane in range(G):
        for s in range(NV):
            v = vert(lane, s)
            if s > 0 and cnt <= G * s:
                # the kernel skips a slot where no vertex is valid (here: on
                # no lane of the group; there: of the warp)
                lanes[(lane, s)] = (False, False, f32(0), f32(0), f32(0), f32(0))
                continue
            wrap = v >= MAX_POLY - 1 or cnt == v + 1
            nv = 0 if wrap else v + 1
            k1, k2 = kv[(lane, s)], kv[(nv % G, nv // G)]
            x, y = reg(px, v), reg(py, v)
            valid = v < cnt and v < MAX_POLY
            inside = bool(k1 >= 0) and valid
            crosses = bool(k1 * k2 < 0) and valid
            tden = k2 - k1 if crosses else f32(1)
            with np.errstate(all="ignore"):
                tt = k1 / tden
                cx = x - tt * (reg(px, nv) - x)
                cy = y - tt * (reg(py, nv) - y)
            lanes[(lane, s)] = (inside, crosses, x, y, cx, cy)
    # the two ballots of each slot: bit `lane` of the group
    mi = [sum(lanes[(lane, s)][0] << lane for lane in range(G)) for s in range(NV)]
    mc = [sum(lanes[(lane, s)][1] << lane for lane in range(G)) for s in range(NV)]
    buf = np.full((MAX_POLY, 2), np.nan, dtype=f32)   # never read where not written
    run = 0
    for s in range(NV):
        for lane in range(G):
            below = (1 << lane) - 1
            offs = run + _popc(mi[s] & below) + _popc(mc[s] & below)
            inside, crosses, x, y, cx, cy = lanes[(lane, s)]
            oc = offs + int(inside)
            if inside and offs < MAX_POLY:
                buf[offs] = (x + f32(0), y + f32(0))
            if crosses and oc < MAX_POLY:
                buf[oc] = (cx + f32(0), cy + f32(0))
        run += _popc(mi[s]) + _popc(mc[s])
    filled = min(run, MAX_POLY)
    out = np.zeros((MAX_POLY, 2), dtype=f32)
    out[:filled] = buf[:filled]
    return out[:, 0], out[:, 1], run


def onehot_clip(px, py, cnt, nx, ny, dclip):
    """The same pass as the earlier kernel emitted it: a thread a polygon,
    slot o = the sum over i of px[i] where vertex i goes to slot o, from 0."""
    kv = px * nx + py * ny + dclip
    inside, crosses, cx, cy, offs = [], [], [], [], []
    run = 0
    for i in range(MAX_POLY):
        wrap = i == MAX_POLY - 1 or cnt == i + 1
        j = 0 if wrap else i + 1
        valid = i < cnt
        inside.append(bool(kv[i] >= 0) and valid)
        crosses.append(bool(kv[i] * kv[j] < 0) and valid)
        tden = kv[j] - kv[i] if crosses[i] else f32(1)
        with np.errstate(all="ignore"):
            tt = kv[i] / tden
            cx.append(px[i] - tt * (px[j] - px[i]))
            cy.append(py[i] - tt * (py[j] - py[i]))
        offs.append(run)
        run += int(inside[i]) + int(crosses[i])
    npx = np.zeros(MAX_POLY, dtype=f32)
    npy = np.zeros(MAX_POLY, dtype=f32)
    for o in range(MAX_POLY):
        ax = ay = f32(0)
        for i in range(MAX_POLY):
            sv = offs[i] == o and inside[i]
            sc = offs[i] + int(inside[i]) == o and crosses[i]
            ax = ax + (px[i] if sv else f32(0)) + (cx[i] if sc else f32(0))
            ay = ay + (py[i] if sv else f32(0)) + (cy[i] if sc else f32(0))
        npx[o], npy[o] = ax, ay
    return npx, npy, run


def _polygons():
    """Seeded clip passes (px, py, cnt, nx, ny, d): random polygons of every
    count from 0 to 12, vertices exactly on the clip line, polygons every
    edge of which crosses it, and -0.0 coordinates."""
    rng = np.random.default_rng(0)
    cases = []
    for k in range(N_POLYGONS):
        cnt = k % (MAX_POLY + 1)
        p = np.zeros((MAX_POLY, 2), dtype=f32)
        p[:cnt] = rng.uniform(-1, 1, (cnt, 2))
        n = rng.normal(size=2).astype(f32)
        d = f32(rng.uniform(-0.5, 0.5))
        if k % 4 == 1 and cnt:
            # the line x = p[0].x: kv == 0 exactly on vertex 0 and on half the others
            p[1:cnt:2, 0] = p[0, 0]
            n, d = np.array([1, 0], dtype=f32), -p[0, 0]
        if k % 4 == 2:
            # a zigzag across y = 0: every edge of an even count crosses
            p[:cnt, 1] = np.where(np.arange(cnt) % 2 == 0, 1, -1) * rng.uniform(0.1, 1, cnt)
            n, d = np.array([0, 1], dtype=f32), f32(0)
        if k % 4 == 3 and cnt:
            p[: cnt : 3] = -0.0
            p[1:cnt:3, 1] = -0.0
        cases.append((p[:, 0].copy(), p[:, 1].copy(), cnt, n[0], n[1], d))
    return cases


N_POLYGONS = 240


def _bits(x):
    return np.asarray(x, dtype=f32).view(np.int32)


@pytest.mark.parametrize("cnt", range(MAX_POLY + 1))
def test_scatter_emission_is_bit_for_bit_the_one_hot_emission(cnt):
    """Every seeded polygon of `cnt` vertices: the kernel's emission, the
    earlier kernel's one-hot sum and `_clip_halfspace` give the same bits."""
    cases = [c for c in _polygons() if c[2] == cnt]
    poly = torch.tensor(np.stack([np.stack([c[0], c[1]], -1) for c in cases]))
    count = torch.tensor([c[2] for c in cases])
    normal = torch.tensor(np.array([[c[3], c[4]] for c in cases]))
    d = torch.tensor(np.array([c[5] for c in cases]))
    plain, plain_count = _clip_halfspace(poly, count, normal, d)
    for k, (px, py, _, nx, ny, dd) in enumerate(cases):
        sx, sy, scnt = scatter_clip(px, py, cnt, nx, ny, dd)
        ox, oy, ocnt = onehot_clip(px, py, cnt, nx, ny, dd)
        assert scnt == ocnt == int(plain_count[k]), k
        np.testing.assert_array_equal(_bits(sx), _bits(ox), err_msg=f"case {k}")
        np.testing.assert_array_equal(_bits(sy), _bits(oy), err_msg=f"case {k}")
        np.testing.assert_array_equal(_bits(sx), _bits(plain[k, :, 0].numpy()), err_msg=f"{k}")
        np.testing.assert_array_equal(_bits(sy), _bits(plain[k, :, 1].numpy()), err_msg=f"{k}")


def test_the_polygons_reach_what_they_are_there_for():
    """Counts 0 and 12, vertices on the line, emission past the 12 slots,
    -0.0 inputs."""
    on_plane = crossing_all = negative_zero = 0
    cases = _polygons()
    for px, py, cnt, nx, ny, dd in cases:
        _, _, scnt = scatter_clip(px, py, cnt, nx, ny, dd)
        kv = px[:cnt] * nx + py[:cnt] * ny + dd
        on_plane += int((kv == 0).any())
        crossing_all += int(cnt > 1 and scnt > MAX_POLY)
        negative_zero += int(np.signbit(px[:cnt]).any() and (px[:cnt] == 0).any())
    assert {c[2] for c in cases} == set(range(MAX_POLY + 1))
    assert on_plane > 10 and crossing_all > 5 and negative_zero > 10


# ---- the axis scan ----

def sequential_scan(seps):
    """The earlier kernel's scan: strict > from -BIG; (best, index or -1)."""
    best, idx = -BIG, -1
    for i, s in enumerate(seps):
        if s > best:
            best, idx = s, i
    return best, idx


def group_scan(face, edge, G):
    """The kernel's reduction: lane l offers axes l, l + G, ... (faces
    0-5, then edges 6-14), takes the better of its own, then a butterfly of
    xor shuffles over the G lanes.  Returns ((sepFN, face index or -1),
    (sepEE, edge index or -1)) as every lane ends with them."""
    axes = list(face) + list(edge)

    def better(s, i, best, idx):
        return (s, i) if (s > best or (s == best and i < idx)) else (best, idx)

    def offer(sep, i, cur):
        eligible = bool(sep > -BIG)
        return better(sep if eligible else f32(-np.inf), i if eligible else NO_AXIS, *cur)

    lanes = []
    for lane in range(G):
        fb, eb = (f32(-np.inf), NO_AXIS), (f32(-np.inf), NO_AXIS)
        for a in range(lane, 15, G):
            if a < 6:
                fb = offer(axes[a], a, fb)
            else:
                eb = offer(axes[a], a - 6, eb)
        lanes.append([fb, eb])
    m = G // 2
    while m >= 1:
        lanes = [[better(*lanes[lane ^ m][k], *lanes[lane][k]) for k in range(2)]
                 for lane in range(G)]
        m //= 2
    assert all(lanes[lane] == lanes[0] for lane in range(G))
    return tuple((-BIG, -1) if i == NO_AXIS else (s, i) for s, i in lanes[0])


AXIS_KINDS = ("generic", "ties", "no valid edge axis", "NaN seps", "infinities and no face")


def _axis_cases(kind):
    """Seeded (face seps (6,), edge seps (9,)) float32 of one of AXIS_KINDS."""
    rng = np.random.default_rng(1 + AXIS_KINDS.index(kind))
    cases = []
    for k in range(80):
        face = rng.normal(size=6).astype(f32)
        edge = rng.normal(size=9).astype(f32)
        if kind == "ties":              # repeated values, and -0.0 against +0.0
            face[rng.integers(0, 6, 3)] = face.max()
            edge[rng.integers(0, 9, 4)] = edge.max()
            face[k % 6] = f32(-0.0)
            face[(k + 2) % 6] = f32(0.0)
        if kind == "no valid edge axis":  # aligned boxes: codeEE 0
            edge[:] = -BIG
        if kind == "NaN seps":          # on the best axis too
            face[rng.integers(0, 6, 2)] = np.nan
            edge[np.argmax(edge)] = np.nan
            edge[rng.integers(0, 9)] = np.nan
        if kind == "infinities and no face":  # all-NaN faces, some invalid edges
            face[:] = np.nan if k % 2 == 0 else face
            edge[rng.integers(0, 9, 3)] = -BIG
            edge[rng.integers(0, 9)] = np.inf
        cases.append((face, edge))
    return cases


@pytest.mark.parametrize("kind", AXIS_KINDS)
def test_group_reduction_matches_the_sequential_scan(kind):
    seen = {"tie": 0, "no_edge": 0, "nan": 0, "no_face": 0}
    for k, (face, edge) in enumerate(_axis_cases(kind)):
        (sf, i_f), (se, i_e) = group_scan(face, edge, LANES_PER_PAIR)
        wf, wif = sequential_scan(face)
        we, wie = sequential_scan(edge)
        assert (i_f, i_e) == (wif, wie), k
        assert _bits(sf) == _bits(wf) and _bits(se) == _bits(we), k
        seen["tie"] += int(np.sum(face == face[i_f]) > 1) if i_f >= 0 else 0
        seen["no_edge"] += int(i_e < 0)
        seen["no_face"] += int(i_f < 0)
        seen["nan"] += int(np.isnan(face).any() or np.isnan(edge).any())
    # each kind reaches what it is there for
    want = {"generic": None, "ties": "tie", "no valid edge axis": "no_edge",
            "NaN seps": "nan", "infinities and no face": "no_face"}[kind]
    assert want is None or seen[want] > 10, seen


# ---- the degenerate poses ----

@pytest.fixture(scope="module")
def degenerate_contacts():
    """The plain version (the wrappers on CPU tensors) on the degenerate
    poses: the lanes entry's contacts, the packed entry's and the class of
    each scenario."""
    (p, q, hs, pi, pj), kind = degenerate_args("cpu")
    lanes = collide_boxes_lanes(*gather_pairs(p, quat_to_mat(q), hs, pi, pj))
    return lanes, collide_boxes_lanes_packed(p, q, hs, pi, pj), kind


@pytest.mark.parametrize("name", POSE_CLASSES)
def test_each_degenerate_pose_gives_the_contacts_it_is_there_for(degenerate_contacts, name):
    lanes, packed, kind = degenerate_contacts
    sel = kind == POSE_CLASSES.index(name)
    code = lanes.code[sel]
    n_active = lanes.active[sel].sum(-1)
    face = (code >= 1) & (code <= 6)
    edge = (code >= 7) & (code <= 15)
    assert int(sel.sum()) >= 585
    if name in ("aligned stack", "turned stack"):
        assert bool(face.all()) and bool((n_active >= 4).all())
    elif name == "exactly touching":
        assert not bool(edge.any()) and bool(face.any())
    elif name == "coincident centres":
        assert bool((code == 16).all()) and bool((n_active == 1).all())
    elif name == "separated":
        assert bool((code == 0).all()) and not bool(lanes.active[sel].any())
    elif name == "deep penetration":
        assert bool((code > 0).all()) and bool((code == 16).any()) and bool(edge.any())
    else:
        assert bool((code == 0).any()) and bool(face.any()) and bool(edge.any())
    # the packed entry's plain version gives the same lanes
    B = int(kind.shape[0])
    assert torch.equal(packed[3], lanes.active.reshape(B, 1, 12))
    assert torch.equal(packed[0], lanes.position.reshape(B, 1, 12, 3))
    # a version against itself agrees on every pair and lane
    assert class_agreement(lanes, lanes, kind)[name] == (1.0, 1.0, 1.0)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pair_list_holds_every_pair_once(n):
    i, j = pair_list(n)
    assert i.dtype == j.dtype == np.int64
    assert sorted(zip(i.tolist(), j.tolist())) == [(a, b) for a in range(n)
                                                   for b in range(a + 1, n)]
