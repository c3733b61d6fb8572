"""Port parity: the BASELINE physics scenes on the all-kernel fused chain.

- The builders `chain`, `pendulum_chain` and `living_room` against the JAX
  package's, field for field and number for number.
- Each scene's fused rollout (`rollout_batched` under the bench
  configuration, the plain versions of every kernel on the CPU) against 20
  steps of the JAX package's XLA twin of the fused step (`_step_xla_twin`),
  B=8, float64, within 1e-8 (the two agree to about 1e-12): `box_drop`
  (K=8, ground-only compaction), `pendulum_chain(3)` (K=4, joints as
  equality lanes), a compressed `chain(3, collide=True)` with
  min_constraint_distance 0.05 (K=16: both dedupes drop lanes), `box_stack(4)`
  at K=24 (mp=72, the streamed solve) and `living_room` (K=32, static
  furniture, per-body ground contacts, a chosen pair list).
- The phases each scene's step runs, through the stepper's hook.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics import scenes as ts
from eggshell_tpu_torch.physics import stepper as tstep
from eggshell_tpu_torch.physics.contacts import drop_joint_contacts, joint_anchors, joint_points
from eggshell_tpu_torch.utils.config import BENCH
from torch_limits import time_limit  # noqa: F401

BUILDERS = {
    "chain3_collide": lambda m, **kw: m.chain(3, collide=True, **kw),
    "chain10": lambda m, **kw: m.chain(**kw),
    "pendulum_chain6": lambda m, **kw: m.pendulum_chain(6, **kw),
    "living_room": lambda m, **kw: m.living_room(**kw),
}


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_scene_builder_arrays_equal(name):
    jspec, jstate = BUILDERS[name](js, dtype=jnp.float64)
    tspec, tstate = BUILDERS[name](ts, device="cpu", dtype=torch.float64)
    for want, got in ((jspec, tspec), (jstate, tstate)):
        for field, w in _np(want).items():
            g = getattr(got, field).numpy()
            assert g.shape == w.shape, field
            np.testing.assert_array_equal(g, w, err_msg=field)


def _compressed_chain():
    """chain(3, collide=True) with link i moved 0.01 i towards the anchor:
    neighbouring links overlap at the corners they share with a joint."""
    spec, st = js.chain(3, collide=True)
    return spec, st._replace(p=st.p - 0.01 * jnp.arange(3.0)[:, None]
                             * jnp.asarray([1.0, 0.0, 0.0]))


SCENES = {
    # name: (JAX builder, contact capacity, min_constraint_distance, jitter)
    "box_drop": (lambda: js.box_drop(height=0.1495), 8, 1e-6, 1e-4),
    "pendulum_chain3": (lambda: js.pendulum_chain(3), 4, 1e-6, 1e-4),
    "chain3_collide": (_compressed_chain, 16, 0.05, 1e-4),
    "box_stack4_k24": (lambda: js.box_stack(4), 24, 1e-6, 1e-3),
    "living_room": (js.living_room, 32, 1e-6, 1e-3),
}
B, STEPS = 8, 20


def _cfg(name):
    _, K, mcd, _ = SCENES[name]
    return BENCH.replace(contact_capacity=K, min_constraint_distance=mcd)


@functools.lru_cache(maxsize=None)
def _jax_twin_rollout(name):
    build, _, _, jitter = SCENES[name]
    spec, st = build()
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    states = states._replace(p=states.p + jnp.linspace(0, jitter, B)[:, None, None])
    cfg = JaxSimConfig.from_json(_cfg(name).to_json()).replace(contact_kernel=False)

    @jax.jit
    def run(sts):
        def body(s, _):
            return jstep._step_xla_twin(spec, s, cfg, None), None
        return jax.lax.scan(body, sts, None, length=STEPS)[0]

    return spec, states, run(states)


def _phases(spec, states, cfg):
    names = []

    def record(name, fn, args):
        names.append(name)
        return fn(*args)

    tstep._fused_step(spec, states, cfg, call=record)
    return names


PHASES = ["compact", "prep", "jassembly", "amat", "jacobi_packed", "integrate"]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fused_rollout_matches_jax_twin(name):
    spec, states, want = _jax_twin_rollout(name)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tstates = convert.state_from_numpy(_np(states), device="cpu", dtype=torch.float64)
    cfg = _cfg(name)
    got = rollout_batched(tspec, tstates, cfg, STEPS)
    for field in ("p", "v", "q", "w"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-8, err_msg=field)
    assert all(bool(torch.isfinite(x).all()) for x in got)

    phases = _phases(tspec, tstates, cfg)
    if name == "box_stack4_k24":
        # mp = 72: the JAX package streams A, the card keeps it resident (B6)
        assert phases == ["narrowphase"] + PHASES[:4] + ["jacobi_packed", "integrate"]
    elif tspec.num_pairs == 0:
        assert phases == PHASES                     # ground-only compaction, no narrowphase
    else:
        assert phases == ["narrowphase"] + PHASES[:4] + [tstep.jacobi_phase(
            cfg.contact_capacity + tspec.num_joints), "integrate"]
    if name == "chain3_collide":
        # both dedupes drop lanes on the first step
        record = {}
        tstep._fused_step(tspec, tstates, cfg,
                          call=lambda n, fn, a: record.setdefault(n, fn(*a)))
        cs = record["compact"]
        a0, a1 = joint_anchors(tspec, tstates)
        kept = drop_joint_contacts(cs, joint_points(a0, a1, tspec.joint_b1), tspec.joint_b0,
                                   tspec.joint_b1, 0.05 ** 2)
        assert int((cs.b1 >= 0).sum()) > int(cs.active.sum()) > int(kept.active.sum())


def test_baseline_table_follows_bench():
    """bench.py:148-176: the capacities and jitters of the BASELINE scenes,
    and the bench configuration otherwise."""
    want = {"box_stack4": (20, 1e-3), "box_drop": (8, 1e-4), "pendulum_chain6": (4, 1e-4),
            "box_stack8": (32, 1e-3), "living_room": (32, 1e-3)}
    assert {k: v[1:] for k, v in ts.BASELINE.items()} == want
    spec, states, cfg = ts.baseline_batch("living_room", 5, device="cpu")
    assert cfg == BENCH.replace(contact_capacity=32) and states.p.dtype == torch.float32
    _, st = ts.living_room(device="cpu", dtype=torch.float32)
    shift = (states.p - st.p)[:, 0, 0]
    np.testing.assert_allclose(shift.numpy(), np.linspace(0, 1e-3, 5), rtol=0, atol=1e-7)
    assert spec.ground_enabled.tolist() == [False] * 4 + [True] * 3
    assert spec.num_pairs == 15 and bool((spec.inv_mass[:4] == 0).all())
