"""Canonical scenarios, counterpart of `eggshell_tpu.physics.scenes`.

Each builder draws its numbers with numpy exactly as the JAX package's
builder does, so the same arguments give the same arrays.  The tensors go
to the card unless the caller passes another `device`; without a CUDA
device the default raises as torch does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from eggshell_tpu_torch.ops import quaternion as quat
from eggshell_tpu_torch.physics.scene import State, make_scene
from eggshell_tpu_torch.utils.config import BENCH, SolverKind


def chain(num_links: int = 10, anchor_position=(2.0, 2.0, 1.0), collide: bool = False, *,
          device="cuda", dtype=torch.float64):
    """Hanging chain of unit boxes linked corner to corner by ball joints,
    anchored to the world at link 0's centre.  Links start collinear along
    x at spacing sqrt(3) * 0.3 with R = Rz(0.9553166) Rx(pi/4), the pose in
    which the corner offsets +-0.15 touch.  `collide=True` adds the ground
    and all link-link pairs; the default has neither (joints only)."""
    anchor = np.asarray(anchor_position, float)
    qz = np.array([math.cos(0.95531661812451 / 2), 0, 0, math.sin(0.95531661812451 / 2)])
    qx = np.array([math.cos(math.pi / 8), math.sin(math.pi / 8), 0, 0])
    q0 = quat.quat_mul(torch.as_tensor(qz), torch.as_tensor(qx)).numpy()
    positions = [anchor + np.array([math.sqrt(3.0) * 0.3 * i, 0, 0]) for i in range(num_links)]
    c1 = np.array([0.15, -0.15, 0.15])
    c2 = np.array([-0.15, 0.15, -0.15])
    joints = [(i, i + 1, c1, c2) for i in range(num_links - 1)]
    joints.append((0, -1, np.zeros(3), positions[0].copy()))
    return make_scene(positions, quats=np.tile(q0, (num_links, 1)), joints=joints,
                      ground=collide, pairs=None if collide else [], device=device,
                      dtype=dtype)


def cairn(num_rocks: int = 4, x_bound=(-0.2, 0.2), y_bound=(-0.2, 0.2),
          z_bound=(1.0, 8.0), seed: int = 0, max_init_v: float = 1.0,
          max_init_w: float = 1.0, *, device="cuda", dtype=torch.float64):
    """Random falling boxes with I = 0.1 I3."""
    rng = np.random.default_rng(seed)
    lo = np.array([x_bound[0], y_bound[0], z_bound[0]])
    hi = np.array([x_bound[1], y_bound[1], z_bound[1]])
    p = rng.uniform(0, 1, (num_rocks, 3)) * (hi - lo) + lo
    q = rng.normal(size=(num_rocks, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.uniform(-1, 1, (num_rocks, 3)) * max_init_v
    w = rng.uniform(-1, 1, (num_rocks, 3)) * max_init_w
    inertia = np.tile(0.1 * np.eye(3), (num_rocks, 1, 1))
    return make_scene(p, quats=q, velocities=v, angular_velocities=w,
                      inertias=inertia, ground=True, device=device, dtype=dtype)


def box_drop(height: float = 0.5, *, device="cuda", dtype=torch.float64):
    """One box above the ground plane."""
    return make_scene([[0.0, 0.0, height]], ground=True, device=device,
                      dtype=dtype)


def box_stack(num_boxes: int = 8, jitter: float = 0.0, seed: int = 0, *,
              device="cuda", dtype=torch.float64):
    """A vertical stack of unit boxes of side 0.3 resting on the ground."""
    rng = np.random.default_rng(seed)
    side = 0.3
    p = np.zeros((num_boxes, 3))
    p[:, 2] = side / 2 + side * np.arange(num_boxes)
    if jitter:
        p[:, :2] += rng.uniform(-jitter, jitter, (num_boxes, 2))
    return make_scene(p, ground=True, device=device, dtype=dtype)


def pendulum_chain(num_links: int = 6, *, device="cuda", dtype=torch.float64):
    """A pendulum chain anchored at (0, 0, 2): joints only, no contacts."""
    return chain(num_links, anchor_position=(0.0, 0.0, 2.0), device=device, dtype=dtype)


def living_room(*, device="cuda", dtype=torch.float64):
    """The living-room clutter scene as boxes: 4 static furniture boxes
    (infinite mass, no ground contacts) and 3 free boxes dropped into the
    room.  Position, half extents and yaw (degrees) of each box are those of
    the JAX package's builder; only pairs with at least one free body are
    candidate pairs (15 of 21)."""
    def yaw_quat(deg):
        a = math.radians(deg)
        return [math.cos(a / 2), 0.0, 0.0, math.sin(a / 2)]

    # name, pos, half extents, yaw, static
    geoms = [
        ("coffee_table", (0.0, 2.0, 0.3), (1.5, 0.8, 0.3), 0.0, True),
        ("dining_table", (0.0, -3.0, 0.8), (2.5, 1.5, 0.8), 0.0, True),
        ("tall_bookcase", (-4.0, 0.0, 2.0), (0.8, 0.4, 2.0), 90.0, True),
        ("short_bookcase", (4.0, 0.0, 1.2), (0.8, 0.4, 1.2), -90.0, True),
        ("plush_armchair", (-3.0, 3.0, 2.5), (1.0, 0.8, 0.8), 45.0, False),
        ("elegant_armchair", (2.5, 2.5, 1.2), (1.0, 0.8, 0.8), -45.0, False),
        ("table_lamp", (0.0, -3.0, 1.4), (0.3, 0.3, 0.6), 0.0, False),
    ]
    return _with_static([g[1] for g in geoms], [yaw_quat(g[3]) for g in geoms],
                        [g[2] for g in geoms], [g[4] for g in geoms], device, dtype)


def _with_static(positions, quats, half_extents, static, device, dtype):
    """A scene of boxes some of which are static (infinite mass, no ground
    contacts); every pair but static-static is a candidate."""
    n = len(positions)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n) if not (static[i] and static[j])]
    spec, state = make_scene(positions, quats=quats, half_extents=half_extents, static=static,
                             ground=True, pairs=pairs, device=device, dtype=dtype)
    ground = torch.as_tensor([not st for st in static], device=spec.ground_enabled.device)
    return spec._replace(ground_enabled=ground), state


def box_pile(num_boxes: int = 216, side: float = 0.3, spacing: float = 1.15, seed: int = 0,
             jitter: float = 0.02, *, device="cuda", dtype=torch.float64):
    """A large scene: a cubic lattice of num_boxes (a cube) boxes of side
    `side` at `spacing` sides apart, the lowest layer on the ground, x and
    y jittered by uniform(-jitter, jitter); it collapses into a pile.  All
    pairs are candidates; the bench runs it with SolverKind.MATRIX_FREE and
    a pair capacity."""
    rng = np.random.default_rng(seed)
    m = round(num_boxes ** (1 / 3))
    if m ** 3 != num_boxes:
        raise ValueError(f"num_boxes must be a perfect cube, got {num_boxes}")
    g = np.arange(m) - (m - 1) / 2
    xx, yy, zz = np.meshgrid(g, g, np.arange(m), indexing="ij")
    p = np.stack([xx.ravel() * side * spacing, yy.ravel() * side * spacing,
                  side / 2 + zz.ravel() * side * spacing], -1)
    p[:, :2] += rng.uniform(-jitter, jitter, (num_boxes, 2))
    return make_scene(p, ground=True, device=device, dtype=dtype)


def mjcf_boxes(path: str, *, device="cuda", dtype=torch.float64):
    """The box geoms of a MuJoCo XML file as a scene: a body with a
    <freejoint/> is free, any other static (infinite mass, no ground
    contacts); geom pos, size (half extents) and euler (degrees, applied
    x, then y, then z) as the JAX package's minimal importer reads them;
    every pair but static-static is a candidate."""
    import xml.etree.ElementTree as ET

    def axis_quat(axis, deg):
        phi = torch.zeros(3, dtype=torch.float64)
        phi[axis] = math.radians(deg)
        return quat.quat_from_scaled_axis(phi)

    positions, half, quats, static = [], [], [], []
    for body in ET.parse(path).getroot().iter("body"):
        free = body.find("freejoint") is not None
        for geom in body.findall("geom"):
            if geom.get("type") != "box":
                continue
            euler = [float(x) for x in geom.get("euler", "0 0 0").split()]
            rx, ry, rz = (axis_quat(a, e) for a, e in enumerate(euler))
            positions.append([float(x) for x in geom.get("pos", "0 0 0").split()])
            half.append([float(x) for x in geom.get("size", "0.1 0.1 0.1").split()])
            quats.append(quat.quat_mul(rz, quat.quat_mul(ry, rx)).numpy())
            static.append(not free)
    return _with_static(positions, quats, half, static, device, dtype)


# The scenes that bench.py rolls on the fused chain (`bench.py:148-176`,
# and the bench slice of `bench.py:80-94`): builder, contact capacity, and
# the jitter that spreads a batch (scenario b's position + b * jitter / (B - 1)).
BASELINE = {
    "box_stack4": (lambda **kw: box_stack(4, **kw), 20, 1e-3),
    "box_drop": (lambda **kw: box_drop(height=0.1495, **kw), 8, 1e-4),
    "pendulum_chain6": (lambda **kw: pendulum_chain(6, **kw), 4, 1e-4),
    "box_stack8": (lambda **kw: box_stack(8, **kw), 32, 1e-3),
    "living_room": (lambda **kw: living_room(**kw), 32, 1e-3),
}


def baseline_batch(name: str, B: int, *, device="cuda", dtype=torch.float32):
    """(spec, states, cfg) of B scenarios of the BASELINE scene `name`: the
    bench's jitter on every coordinate of p, and the bench configuration
    with the scene's contact capacity."""
    build, capacity, jitter = BASELINE[name]
    spec, st = build(device=device, dtype=dtype)
    states = State(*[x.expand((B,) + x.shape).clone() for x in st])
    shift = torch.linspace(0, jitter, B, device=device, dtype=dtype)
    return (spec, states._replace(p=states.p + shift[:, None, None]),
            BENCH.replace(contact_capacity=capacity))


# bench.py:286-318's large-scene tier: boxes of the pile, batch, contact
# capacity and pair capacity, on the bench solver with MATRIX_FREE, 60
# sweeps, broadphase margin 0.05 and max_correcting_vel 2
LARGE = {"pile216": (216, 8, 4096, 2048), "pile512": (512, 4, 8192, 4096)}
LARGE_JITTER = 1e-3


def large_batch(name: str, B: int = None, *, device="cuda", dtype=torch.float32):
    """(spec, states, cfg) of the large-scene cell `name` (LARGE): B
    scenarios (the cell's batch by default) of the pile, scenario b's
    position + b * LARGE_JITTER / (B - 1) on every coordinate, as bench.py
    spreads them."""
    boxes, batch, K, pc = LARGE[name]
    B = batch if B is None else B
    spec, st = box_pile(boxes, device=device, dtype=dtype)
    states = State(*[x.expand((B,) + x.shape).clone() for x in st])
    shift = torch.linspace(0, LARGE_JITTER, B, device=device, dtype=dtype)
    cfg = BENCH.replace(solver=SolverKind.MATRIX_FREE, solver_iters=60, contact_capacity=K,
                        pair_capacity=pc, broadphase_margin=0.05, max_correcting_vel=2.0)
    return spec, states._replace(p=states.p + shift[:, None, None]), cfg


# living_room on the fused chain with the broadphase (`[scene_living_room_bp]`
# of chip_smoke.py): margin 0.1, and the smallest pair capacity at which no
# overlapping pair is left out over the bench rollout (B = 4096, H = 50; at
# most 2 of the 15 candidate pairs overlap)
LIVING_ROOM_BP_MARGIN = 0.1
LIVING_ROOM_PAIR_CAPACITY = 2
