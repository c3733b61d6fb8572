"""Port parity: scene builders, conversion and configuration of
`eggshell_tpu_torch` against `eggshell_tpu`, plus the import boundary
(the port loads no JAX and nothing of the JAX package)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.physics import scenes as js
from eggshell_tpu.utils import config as jconfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.physics import scene as tscene
from eggshell_tpu_torch.physics import scenes as ts
from eggshell_tpu_torch.utils import config as tconfig
from torch_limits import time_limit  # noqa: F401

BUILDERS = {
    "box_stack4": lambda m, **kw: m.box_stack(4, **kw),
    "box_stack4_jitter": lambda m, **kw: m.box_stack(4, jitter=0.05, seed=3, **kw),
    "box_drop": lambda m, **kw: m.box_drop(height=0.3, **kw),
    "cairn4": lambda m, **kw: m.cairn(4, seed=2, **kw),
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


def test_convert_round_trip_and_scene_helpers():
    """convert.* carries a JAX scene over unchanged, and the mass/force
    helpers agree with the JAX package's on a tumbling batch."""
    from eggshell_tpu.physics import scene as jscene
    import jax

    jspec, jstate = js.cairn(4, seed=5)
    spec = convert.spec_from_numpy(_np(jspec), device="cpu", dtype=torch.float64)
    state = convert.state_from_numpy(_np(jstate), device="cpu", dtype=torch.float64)
    assert spec.pair_i.dtype == torch.int64 and spec.ground_enabled.dtype == torch.bool
    np.testing.assert_array_equal(state.q.numpy(), np.asarray(jstate.q))

    states = tscene.State(*[x.expand((3,) + x.shape).clone() for x in state])
    jstates = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (3,) + x.shape), jstate)
    want_m = jax.vmap(lambda s: jscene.inv_mass_blocks(jspec, s))(jstates)
    want_f = jax.vmap(lambda s: jscene.external_forces(jspec, s, (0.0, 0.0, -9.8)))(jstates)
    np.testing.assert_allclose(tscene.inv_mass_blocks(spec, states).numpy(), want_m,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tscene.external_forces(spec, states, (0.0, 0.0, -9.8)).numpy(),
                               want_f, rtol=1e-12, atol=1e-12)
    u = tscene.pack_velocity(states)
    np.testing.assert_array_equal(u.numpy(), jax.vmap(jscene.pack_velocity)(jstates))
    back = tscene.unpack_velocity(states, 2.0 * u)
    assert torch.equal(back.v, 2.0 * states.v) and torch.equal(back.w, 2.0 * states.w)


def test_config_matches_jax_package():
    """Same fields, defaults and enum values, so one JSON drives both."""
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.SimConfig)]
    assert tf == jf
    for enum_name in ("SolverKind", "FrictionModel"):
        assert ({e.name: e.value for e in getattr(tconfig, enum_name)}
                == {e.name: e.value for e in getattr(jconfig, enum_name)})
    cfg = jconfig.SimConfig(solver=jconfig.SolverKind.JACOBI_KERNEL, conditional_cfm=True,
                            contact_capacity=20, jacobi_beta=0.45)
    assert tconfig.SimConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()


def test_import_loads_no_jax():
    code = ("import sys, eggshell_tpu_torch, eggshell_tpu_torch.parallel.rollout, "
            "eggshell_tpu_torch.convert, eggshell_tpu_torch.kernels, "
            "eggshell_tpu_torch.ops.prep_kernel, eggshell_tpu_torch.ops.jassembly_kernel, "
            "eggshell_tpu_torch.ops.amat_kernel, eggshell_tpu_torch.ops.integrate_kernel, "
            "eggshell_tpu_torch.ops.compact_kernel, eggshell_tpu_torch.ops.collision_kernel, "
            "eggshell_tpu_torch.fem.fdtd, eggshell_tpu_torch.ops.lcp, "
            "eggshell_tpu_torch.profile_step, eggshell_tpu_torch.physics, "
            "eggshell_tpu_torch.physics.stepper, eggshell_tpu_torch.mpc.sampling, "
            "eggshell_tpu_torch.mpc.gradient, eggshell_tpu_torch.ops.lcp_direct, "
            "eggshell_tpu_torch.ops.geometry2d, eggshell_tpu_torch.fem, "
            "eggshell_tpu_torch.fem.shape, eggshell_tpu_torch.fem.mesher, "
            "eggshell_tpu_torch.fem.ports, eggshell_tpu_torch.fem.metal, "
            "eggshell_tpu_torch.fem.antenna, eggshell_tpu_torch.fem.sparse, "
            "eggshell_tpu_torch.fem.block_tridiag, eggshell_tpu_torch.fem.helmholtz, "
            "eggshell_tpu_torch.fem.fields, eggshell_tpu_torch.utils.mat_file, "
            "eggshell_tpu_torch.utils.dxf, eggshell_tpu_torch.parallel.mesh, "
            "eggshell_tpu_torch.opt, eggshell_tpu_torch.models, eggshell_tpu_torch.native, "
            "eggshell_tpu_torch.utils.hashing; "
            # contourpy and matplotlib are absent where the port runs on the
            # card: no module loads them (viz imports matplotlib in a drawing)
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'eggshell_tpu', 'contourpy', 'matplotlib')); print(bad); "
            "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
