"""Canonical scenarios, counterpart of `eggshell_tpu.physics.scenes`.

Each builder draws its numbers with numpy exactly as the JAX package's
builder does, so the same arguments give the same arrays.  The tensors go
to the card unless the caller passes another `device`; without a CUDA
device the default raises as torch does.
"""

from __future__ import annotations

import numpy as np
import torch

from eggshell_tpu_torch.physics.scene import make_scene


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
