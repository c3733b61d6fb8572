"""Port parity: `eggshell_tpu_torch.mpc.gradient.gradient_mpc_update`
against the JAX package's, on the CPU in float64.

box_drop resting on the floor (height 0.15, so the ground contacts and
their friction are in the solve) under tests/test_mpc_parallel.py:14-17's
PGS configuration, H = 4, 2 updates with a learning rate that moves the
controls: the controls and the cost within 1e-8.  The port differentiates
through its PGS sweeps, whose row updates are built out of place.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eggshell_tpu.mpc.gradient import gradient_mpc_update as jax_update
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.mpc import gradient_mpc_update
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

# tests/test_mpc_parallel.py:14-17
CFG = SimConfig(solver=SolverKind.PGS, solver_iters=40, conditional_cfm=False, cfm_always=0.01,
                contact_capacity=16)
H, STEPS, LR = 4, 2, 2e5
TARGET = (0.05, 0.0, 0.15)


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _controls():
    return np.random.default_rng(0).normal(scale=5.0, size=(H, 6))


@functools.lru_cache(maxsize=None)
def _jax():
    spec, st = js.box_drop(height=0.15)
    target = jnp.asarray(TARGET)

    def cost(final):
        return jnp.sum((final.p[0] - target) ** 2)

    c, val = jax_update(spec, st, JaxSimConfig.from_json(CFG.to_json()), jnp.asarray(_controls()),
                        cost, learning_rate=LR, steps=STEPS)
    return np.asarray(c), float(val)


def test_gradient_mpc_update_matches_jax():
    spec, st = js.box_drop(height=0.15)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tst = convert.state_from_numpy(_np(st), device="cpu", dtype=torch.float64)
    target = torch.tensor(TARGET, dtype=torch.float64)

    def cost(final):
        return torch.sum((final.p[0] - target) ** 2)

    c0 = torch.tensor(_controls())
    c, val = gradient_mpc_update(tspec, tst, CFG, c0, cost, learning_rate=LR, steps=STEPS)
    want_c, want_val = _jax()
    assert not c.requires_grad and val.shape == ()
    np.testing.assert_allclose(c.numpy(), want_c, rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(val), want_val, rtol=0, atol=1e-8)
    assert float(np.abs(want_c - _controls()).max()) > 1e-2     # the updates moved the plan
