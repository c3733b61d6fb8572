"""Plain reference of the rigid-body contact step that the benchmark holds
the program to: boxes on a ground plane, frictional contact as a mixed
LCP solved by fixed-sweep heavy-ball projected Jacobi, the ODE velocity
step with the midpoint position update.

It is a frozen, self-contained copy of the semantics the port's fused
chain computes (its plain twin: narrowphase, stable compaction into K
lanes, same-pair dedupe, dense Jacobian, A = J M^-1 J^T with always-on
CFM, projected Jacobi from the projected right-hand side, integration),
written in plain torch at any dtype.  It imports nothing of the program
or of the JAX package; the scene is built here from the configuration
file's arrays.  Only what the benchmark's configurations use is here:
BOX friction, always-on CFM, no joints, every pair a candidate.

The upstream stepper is `Ensemble::StepVelocities_ODE` and `ComputeVDot`
(teenylasers/eggshell, eggshell/ensembles.cc:498-591).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

ALIGNMENT_TOLERANCE = 0.9962
TOL = 1e-9
MAX_POLY = 12
GROUND_CONTACTS = 8
CORNER_SIGNS = [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0) for z in (-1.0, 1.0)]


class Scene(NamedTuple):
    """One scene: per body inv_mass (n,), inertia and inv_inertia (n, 3, 3),
    half_extents (n, 3), ground (n,) bool; candidate pairs pair_i, pair_j
    (P,) int64."""

    inv_mass: torch.Tensor
    inertia: torch.Tensor
    inv_inertia: torch.Tensor
    half_extents: torch.Tensor
    ground: torch.Tensor
    pair_i: torch.Tensor
    pair_j: torch.Tensor


class Solver(NamedTuple):
    dt: float
    gravity: tuple
    erp: float
    cfm: float
    friction_bound: float
    sweeps: int
    omega: float
    beta: float
    capacity: int
    min_distance: float


class Bodies(NamedTuple):
    """p (B, n, 3), v (B, n, 3), q (B, n, 4) wxyz, w (B, n, 3)."""

    p: torch.Tensor
    v: torch.Tensor
    q: torch.Tensor
    w: torch.Tensor


def solver_of(config: dict) -> Solver:
    s = config["solver"]
    if (s["friction_model"] != "box" or s["conditional_cfm"] or s["joints"]
            or s["max_correcting_vel"] != "inf"):
        raise ValueError("the reference covers box friction, always-on CFM, no depth cap and "
                         "no joints")
    return Solver(dt=s["dt"], gravity=tuple(s["gravity"]), erp=s["erp"], cfm=s["cfm_always"],
                  friction_bound=s["friction_bound"], sweeps=s["sweeps"], omega=s["omega"],
                  beta=s["beta"], capacity=s["contact_capacity"],
                  min_distance=s["min_constraint_distance"])


def scene_of(config: dict, dtype, device, input_dtype=None) -> tuple[Scene, Bodies]:
    """The scene and its one start state (batch of one) from the
    configuration's arrays, taken in `input_dtype` (by default the dtype
    the configuration states, so that both sides start from the same
    numbers) and worked in `dtype`: static bodies have no mass and no
    ground contacts, the inertia is the solid box's, every pair with a
    free body is a candidate."""
    sc = config["scene"]
    n = len(sc["positions"])
    given = getattr(torch, config["solver"]["dtype"]) if input_dtype is None else input_dtype

    def given_f64(x):
        return torch.tensor(x, dtype=given).to(torch.float64)

    he = given_f64(sc["half_extents"])
    mass = given_f64(sc["masses"])
    static = torch.tensor(sc["static"], dtype=torch.bool)
    s2 = (2.0 * he) ** 2
    inertia = torch.diag_embed(torch.stack(
        [s2[:, 1] + s2[:, 2], s2[:, 0] + s2[:, 2], s2[:, 0] + s2[:, 1]], -1) * (mass[:, None] / 12))
    inv_mass = torch.where(static, 0.0, 1.0 / mass)
    inv_inertia = torch.zeros_like(inertia)
    inv_inertia[~static] = torch.linalg.inv(inertia[~static])
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n) if not (static[i] and static[j])]
    q = given_f64(sc["quats"])
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    def f(x):
        return x.to(dtype=dtype, device=device)

    def i(x):
        return torch.tensor(x, dtype=torch.int64, device=device)

    scene = Scene(f(inv_mass), f(inertia), f(inv_inertia), f(he), (~static).to(device),
                  i([a for a, _ in pairs]), i([b for _, b in pairs]))
    zeros = torch.zeros((1, n, 3), dtype=dtype, device=device)
    bodies = Bodies(f(given_f64(sc["positions"]))[None], zeros,
                    f(q)[None], zeros.clone())
    return scene, bodies


# --- rotations --------------------------------------------------------------


def cross_mat(a):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    z = torch.zeros_like(ax)
    return torch.stack([torch.stack([z, -az, ay], -1), torch.stack([az, z, -ax], -1),
                        torch.stack([-ay, ax, z], -1)], -2)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)], -2)


def quat_mul(a, b):
    w1, x1, y1, z1 = a.unbind(-1)
    w2, x2, y2, z2 = b.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_normalize(q):
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.where(n > 0, n, torch.ones_like(n))


def integrate_quat(q, w, dt):
    """Q(w dt) q renormalised, the exp map Taylor-safe at 0."""
    phi = w * dt
    t2 = torch.sum(phi * phi, -1, keepdim=True)
    small = t2 < 1e-12
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * t) / t)
    c = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * t))
    return quat_normalize(quat_mul(torch.cat([c, k * phi], -1), q))


def _unit(v):
    l2 = torch.sum(v * v, -1, keepdim=True)
    ok = l2 > 0
    return torch.where(ok, v / torch.sqrt(torch.where(ok, l2, torch.ones_like(l2))),
                       torch.zeros_like(v))


def align_to_z(a):
    """Rotations taking each direction a (..., 3) onto +z."""
    ah = _unit(a)
    bh = torch.zeros_like(ah)
    bh[..., 2] = 1.0
    w = 1.0 + torch.sum(ah * bh, -1, keepdim=True)
    q = torch.cat([w, torch.linalg.cross(ah, bh, dim=-1)], -1)
    e = torch.nn.functional.one_hot(torch.argmin(torch.abs(ah), -1), 3).to(a.dtype)
    q_pi = torch.cat([torch.zeros_like(w), _unit(torch.linalg.cross(ah, e, dim=-1))], -1)
    return quat_to_mat(quat_normalize(torch.where(w < 1e-8, q_pi, q)))


# --- narrowphase (separating axes, clipping) ----------------------------------


def _sgn(x):
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _dot(a, b):
    return torch.sum(a * b, -1)


def _mv(M, v):
    return torch.einsum("nij,nj->ni", M, v)


def _mtv(M, v):
    return torch.einsum("nji,nj->ni", M, v)


def _col(M, idx):
    return torch.gather(M, 2, idx[:, None, None].expand(-1, 3, 1))[..., 0]


def _at(v, idx):
    return torch.gather(v, 1, idx[:, None])[:, 0]


def _sel(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def _clip(poly, count, normal, d):
    """Clip convex polygons by normal . P + d >= 0 in emission order: each
    vertex if inside, then the crossing to the next vertex."""
    idx = torch.arange(MAX_POLY, device=poly.device)
    valid = idx[None] < count[:, None]
    nxt = torch.where(idx[None] + 1 >= count[:, None], 0, idx[None] + 1)
    p2 = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    k1 = torch.einsum("npc,nc->np", poly, normal) + d[:, None]
    k2 = torch.einsum("npc,nc->np", p2, normal) + d[:, None]
    inside = (k1 >= 0) & valid
    crosses = (k1 * k2 < 0) & valid
    t = k1 / torch.where(crosses, k2 - k1, torch.ones_like(k1))
    cross_pt = poly - t[..., None] * (p2 - poly)
    contrib = inside.long() + crosses.long()
    offs = torch.cumsum(contrib, 1) - contrib
    slots = idx[None, :, None]
    sel_v = ((offs[:, None] == slots) & inside[:, None]).to(poly.dtype)
    sel_c = (((offs + inside.long())[:, None] == slots) & crosses[:, None]).to(poly.dtype)
    out = torch.einsum("nsi,nic->nsc", sel_v, poly) + torch.einsum("nsi,nic->nsc", sel_c, cross_pt)
    return out, contrib.sum(1)


def _box_rectangle(Ac, AR, Ah, Rc, RR, Rh):
    N = Ac.shape[0]
    Bc = Ac - Rc
    poly = torch.zeros((N, MAX_POLY, 2), dtype=Ac.dtype, device=Ac.device)
    poly[:, 0, 0], poly[:, 0, 1] = -Rh[:, 0], -Rh[:, 1]
    poly[:, 1, 0], poly[:, 1, 1] = -Rh[:, 0], Rh[:, 1]
    poly[:, 2, 0], poly[:, 2, 1] = Rh[:, 0], Rh[:, 1]
    poly[:, 3, 0], poly[:, 3, 1] = Rh[:, 0], -Rh[:, 1]
    count = torch.full((N,), 4, dtype=torch.int64, device=Ac.device)
    Rn = RR[:, :, 2]
    for i in range(3):
        Bn = AR[:, :, i]
        BnBc = _dot(Bn, Bc)
        parallel = torch.linalg.vector_norm(torch.linalg.cross(Bn, Rn, dim=-1), dim=-1) < TOL
        for j in (-1.0, 1.0):
            Bd = -j * BnBc - Ah[:, i]
            Bnormal = -j * Bn
            H = torch.stack([_dot(RR[:, :, 0], Bnormal), _dot(RR[:, :, 1], Bnormal)], -1)
            new_poly, new_count = _clip(poly, count, H, -Bd)
            poly = _sel(parallel, poly, new_poly)
            count = torch.where(parallel & (Bd > 0), 0,
                                torch.where(parallel & (Bd <= 0), count, new_count))
    return poly, count


def box_box(p1, R1, H1, p2, R2, H2):
    """Contacts of N box pairs: position (N, 12, 3), normal (N, 3), depth
    (N, 12), active (N, 12); the normal points from box 1 to box 2."""
    N = p1.shape[0]
    dtype, device = p1.dtype, p1.device
    R = R1.transpose(-1, -2) @ R2
    p = _mtv(R1, p2 - p1)
    Q = torch.abs(R)
    aligned = (Q.amax(-2) > ALIGNMENT_TOLERANCE).sum(-1)

    e_face = torch.cat([p, _mtv(R, p)], -1)
    sep_face = torch.abs(e_face) - torch.cat([H1 + _mv(Q, H2), _mtv(Q, H1) + H2], -1)
    normals = torch.cat([R1.transpose(-1, -2), R2.transpose(-1, -2)], -2)
    i_fn = torch.argmax(sep_face, -1)
    depth_fn = _at(sep_face, i_fn)
    axis_fn = _sgn(_at(e_face, i_fn))[:, None] * torch.gather(
        normals, 1, i_fn[:, None, None].expand(-1, 1, 3))[:, 0]
    code_fn = i_fn + 1

    eye = torch.eye(3, dtype=dtype, device=device)
    n = torch.linalg.cross(eye[None, :, None].expand(N, 3, 3, 3),
                           R.transpose(-1, -2)[:, None].expand(N, 3, 3, 3), dim=-1).reshape(N, 9, 3)
    l2 = torch.sum(n * n, -1)
    valid = l2 > TOL * TOL
    length = torch.sqrt(torch.where(valid, l2, torch.ones_like(l2)))
    e_ee = torch.einsum("nkc,nc->nk", n, p)
    others = ((1, 2), (0, 2), (0, 1))
    span2 = torch.stack([H2[:, others[b][0]] * Q[:, a, others[b][1]]
                         + H2[:, others[b][1]] * Q[:, a, others[b][0]]
                         for a in range(3) for b in range(3)], -1)
    raw = torch.abs(e_ee) - (torch.einsum("nkc,nc->nk", torch.abs(n), H1) + span2)
    sep_ee = torch.where(valid, raw / length, torch.full_like(l2, -float("inf")))
    i_ee = torch.argmax(sep_ee, -1)
    depth_ee = _at(sep_ee, i_ee)
    n_best = torch.gather(n, 1, i_ee[:, None, None].expand(-1, 1, 3))[:, 0]
    axis_ee = _mv(R1, n_best / (_sgn(_at(e_ee, i_ee)) * _at(length, i_ee))[:, None])
    separated = (sep_face > 0).any(-1) | (valid & (raw > 0)).any(-1)
    best_fn = depth_fn > depth_ee

    pa = p1 + _mv(R1, _sgn(_mtv(R1, axis_ee)) * H1)
    pb = p2 - _mv(R2, _sgn(_mtv(R2, axis_ee)) * H2)
    ua, ub = _col(R1, i_ee // 3), _col(R2, i_ee % 3)
    uaub = _dot(ua, ub)
    q1, q2 = _dot(ua, pb - pa), -_dot(ub, pb - pa)
    den = 1 - uaub * uaub
    degenerate = den == 0
    den = torch.where(degenerate, torch.ones_like(den), den)
    alpha = torch.where(degenerate, torch.zeros_like(den), (q1 + uaub * q2) / den)
    beta = torch.where(degenerate, torch.zeros_like(den), (uaub * q1 + q2) / den)
    ee_pos = (pa + ua * alpha[:, None] + pb + ub * beta[:, None]) * 0.5

    a1 = code_fn <= 3
    Ac, AR, Ah = _sel(a1, p1, p2), _sel(a1, R1, R2), _sel(a1, H1, H2)
    Bc, BR, Bh = _sel(a1, p2, p1), _sel(a1, R2, R1), _sel(a1, H2, H1)
    Anormal = axis_fn * torch.where(a1, 1.0, -1.0).to(dtype)[:, None]
    nf = _mtv(BR, Anormal)
    k = torch.argmax(torch.abs(nf), -1)
    Bnormal = -_sgn(_at(nf, k))[:, None] * _col(BR, k)
    k1, k2 = (k + 1) % 3, (k + 2) % 3
    Rc = Bc + Bnormal * _at(Bh, k)[:, None]
    RR = torch.stack([_col(BR, k1), _col(BR, k2), _col(BR, k)], -1)
    Rh = torch.stack([_at(Bh, k1), _at(Bh, k2), torch.zeros_like(Ac[:, 0])], -1)
    Ad = -_dot(Anormal, Ac + Anormal * _at(Ah, (code_fn - 1) % 3)[:, None])
    poly, count = _box_rectangle(Ac, AR, Ah, Rc, RR, Rh)
    lane = torch.arange(MAX_POLY, device=device)
    face_pos = (Rc[:, None] + poly[:, :, :1] * RR[:, None, :, 0]
                + poly[:, :, 1:2] * RR[:, None, :, 1])
    face_depth = -(torch.einsum("npc,nc->np", face_pos, Anormal) + Ad[:, None])
    keep = (lane[None] < count[:, None]) & ((torch.abs(face_depth) > TOL) | (aligned >= 2)[:, None])
    any_face = keep.any(-1)

    use_ee = (aligned == 0) & ~best_fn
    position = _sel(use_ee, ee_pos[:, None].expand(N, MAX_POLY, 3),
                    _sel(any_face, face_pos, p2[:, None].expand(N, MAX_POLY, 3)))
    depth = _sel(use_ee, (-depth_ee)[:, None].expand(N, MAX_POLY),
                 _sel(any_face, face_depth, (-depth_fn)[:, None].expand(N, MAX_POLY)))
    one = (lane == 0)[None].expand(N, MAX_POLY)
    active = _sel(use_ee, one, _sel(any_face, keep, one)) & ~separated[:, None]
    return position, _sel(use_ee, axis_ee, axis_fn), depth, active


# --- contacts, constraints, solve, integration ---------------------------------


def contacts(scene: Scene, st: Bodies, solver: Solver):
    """K lanes a scenario: (b0, b1, position, normal, depth, active); ground
    corners body-major, then 12 lanes a candidate pair, the active ones
    compacted in that order (the rest dropped), then the same-pair dedupe
    judged on the incoming flags.  b0 = -1 is the ground."""
    B, n = st.p.shape[:2]
    dev, dtype = st.p.device, st.p.dtype
    R = quat_to_mat(st.q)
    signs = torch.tensor(CORNER_SIGNS, dtype=dtype, device=dev)
    corners = st.p[..., None, :] + (signs * scene.half_extents[:, None, :]) @ R.transpose(-1, -2)
    G = GROUND_CONTACTS
    b0 = [torch.full((B, n * G), -1, dtype=torch.int64, device=dev)]
    b1 = [torch.arange(n, device=dev).repeat_interleave(G).expand(B, n * G)]
    pos = [corners.reshape(B, n * G, 3)]
    nrm = [torch.zeros((B, n * G, 3), dtype=dtype, device=dev)]
    nrm[0][..., 2] = 1.0
    dep = [-corners[..., 2].reshape(B, n * G)]
    act = [((corners[..., 2] < 0) & scene.ground[:, None]).reshape(B, n * G)]
    P = scene.pair_i.shape[0]
    if P:
        pi, pj = scene.pair_i, scene.pair_j

        def g(x, idx):
            return x[:, idx].reshape((B * P,) + x.shape[2:])

        he = scene.half_extents.expand(B, n, 3)
        cp, cn, cd, ca = box_box(g(st.p, pi), g(R, pi), g(he, pi), g(st.p, pj), g(R, pj), g(he, pj))
        C = MAX_POLY
        b0.append(pi.repeat_interleave(C).expand(B, P * C))
        b1.append(pj.repeat_interleave(C).expand(B, P * C))
        pos.append(cp.reshape(B, P * C, 3))
        nrm.append(cn.reshape(B, P, 1, 3).expand(B, P, C, 3).reshape(B, P * C, 3))
        dep.append(cd.reshape(B, P * C))
        act.append(ca.reshape(B, P * C))
    b0, b1, pos, nrm, dep, act = (torch.cat(x, 1) for x in (b0, b1, pos, nrm, dep, act))

    K = solver.capacity
    C = act.shape[1]
    offs = torch.cumsum(act.long(), 1) - act.long()
    slot = torch.where(act & (offs < K), offs, torch.full_like(offs, K))

    def scatter(vals, fill):
        buf = torch.full((B, K + 1) + vals.shape[2:], fill, dtype=vals.dtype, device=dev)
        idx = slot.reshape(B, C, *([1] * (vals.dim() - 2))).expand(vals.shape)
        return buf.scatter(1, idx, vals)[:, :K]

    b0, b1 = scatter(b0.expand(B, C), -1), scatter(b1.expand(B, C), -1)
    pos, nrm = scatter(pos, 0.0), scatter(nrm, 0.0)
    dep, act = scatter(dep, 0.0), scatter(act, False)

    lo, hi = torch.minimum(b0, b1), torch.maximum(b0, b1)
    d = pos[:, :, None] - pos[:, None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    same = (lo[:, :, None] == lo[:, None]) & (hi[:, :, None] == hi[:, None])
    ok = (lo >= 0)[:, :, None] & (lo >= 0)[:, None]
    lane = torch.arange(K, device=dev)
    drop = (same & ok & act[:, :, None] & act[:, None] & (lane[None] < lane[:, None])
            & (d2 < solver.min_distance ** 2)).any(2)
    return b0, b1, pos, nrm, dep, act & ~drop


def _rows(bodies, blocks, n):
    """(B, K, 3, 6) blocks on bodies (B, K) -> dense rows (B, 3K, n, 6)."""
    B, K = bodies.shape
    onehot = (bodies[..., None] == torch.arange(n, device=bodies.device)).to(blocks.dtype)
    return torch.einsum("bcn,bcrk->bcrnk", onehot, blocks).reshape(B, 3 * K, n, 6)


def inv_mass_blocks(scene: Scene, st: Bodies):
    R = quat_to_mat(st.q)
    inv_ig = R @ scene.inv_inertia @ R.transpose(-1, -2)
    eye = torch.eye(3, dtype=st.p.dtype, device=st.p.device)
    top = (scene.inv_mass[:, None, None] * eye).expand(inv_ig.shape)
    zero = torch.zeros_like(inv_ig)
    return torch.cat([torch.cat([top, zero], -1), torch.cat([zero, inv_ig], -1)], -2)


def step(scene: Scene, st: Bodies, solver: Solver, ext=None, tally=None) -> Bodies:
    """One step of B scenarios; `ext` (B, n, 6) adds wrenches [force;
    torque] to gravity and the gyroscopic torque; `tally(b0, b1, active)`,
    where given, is shown the step's contact lanes."""
    B, n = st.p.shape[:2]
    dtype, dev = st.p.dtype, st.p.device
    dt = solver.dt
    b0, b1, pos, nrm, dep, act = contacts(scene, st, solver)
    if tally is not None:
        tally(b0, b1, act)
    K = solver.capacity

    Rcf = align_to_z(nrm)
    b0ok, b1ok = b0 >= 0, b1 >= 0

    def arm(b):
        idx = torch.where(b >= 0, b, 0)
        return cross_mat(pos - torch.gather(st.p, 1, idx[..., None].expand(B, K, 3)))

    blk0 = torch.cat([-Rcf, Rcf @ arm(b0)], -1)
    blk1 = torch.cat([Rcf, -(Rcf @ arm(b1))], -1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    blk0 = torch.where((act & b0ok)[..., None, None], blk0, zero)
    blk1 = torch.where((act & b1ok)[..., None, None], blk1, zero)
    minus1 = torch.full_like(b0, -1)
    J = _rows(torch.where(act, b0, minus1), blk0, n) + _rows(torch.where(act, b1, minus1), blk1, n)
    zk = torch.zeros((B, K), dtype=dtype, device=dev)
    err = torch.stack([zk, zk, torch.where(act, -dep, zk)], -1).reshape(B, 3 * K)
    row_on = act[..., None].expand(B, K, 3).reshape(B, 3 * K)
    mu = solver.friction_bound
    lo = torch.tensor([-mu, -mu, 0.0], dtype=dtype, device=dev).repeat(K).expand(B, 3 * K)
    hi = torch.tensor([mu, mu, math.inf], dtype=dtype, device=dev).repeat(K).expand(B, 3 * K)
    is_eq = ~row_on

    u = torch.cat([st.v, st.w], -1)
    Minv = inv_mass_blocks(scene, st)
    R = quat_to_mat(st.q)
    ig = R @ scene.inertia @ R.transpose(-1, -2)
    im = scene.inv_mass
    mass = torch.where(im > 0, 1.0 / torch.where(im > 0, im, torch.ones_like(im)),
                       torch.zeros_like(im))
    g = torch.tensor(solver.gravity, dtype=dtype, device=dev)
    F = torch.cat([(mass[:, None] * g).expand(B, n, 3),
                   -torch.linalg.cross(st.w, torch.einsum("bnij,bnj->bni", ig, st.w), dim=-1)], -1)
    if ext is not None:
        F = F + ext
    MinvF = torch.einsum("bnij,bnj->bni", Minv, F)
    rhs = -solver.erp / dt / dt * err - torch.einsum("bmnk,bnk->bm", J, u / dt + MinvF)

    A = torch.einsum("bmnl,bonl->bmo", torch.einsum("bmnk,bnkl->bmnl", J, Minv), J)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    scale = torch.amax(torch.where(row_on, diag, zero), -1, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    A = A + torch.diag_embed(torch.where(row_on, solver.cfm, scale))

    diag = torch.diagonal(A, dim1=-2, dim2=-1)

    def project(x):
        return torch.where(is_eq, x, torch.minimum(torch.maximum(x, lo), hi))

    x = project(rhs)
    xp = x
    for _ in range(solver.sweeps):
        r = rhs - torch.einsum("bij,bj->bi", A, x) + diag * x
        x, xp = project((1.0 - solver.omega) * x + solver.omega * (r / diag)
                        + solver.beta * (x - xp)), x

    vdot = torch.einsum("bnij,bnj->bni", Minv, F + torch.einsum("bmnk,bm->bnk", J, x))
    u_new = u + dt * vdot
    u_mid = 0.5 * (u + u_new)
    return Bodies(p=st.p + dt * u_mid[..., :3], v=u_new[..., :3],
                  q=integrate_quat(st.q, u_mid[..., 3:], dt), w=u_new[..., 3:])


def rollout(scene: Scene, st: Bodies, solver: Solver, steps: int, tally=None) -> Bodies:
    for _ in range(steps):
        st = step(scene, st, solver, tally=tally)
    return st


def controlled_rollout(scene: Scene, st: Bodies, solver: Solver, controls, body: int,
                       tally=None) -> Bodies:
    """Each sample's wrench controls[:, t] (S, H, 6) on `body` for step t."""
    S, H = controls.shape[:2]
    n = st.p.shape[1]
    for t in range(H):
        ext = torch.zeros((S, n, 6), dtype=st.p.dtype, device=st.p.device)
        ext[:, body] = controls[:, t]
        st = step(scene, st, solver, ext, tally)
    return st
