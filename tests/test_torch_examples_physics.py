"""The FDTD and rigid-body example scripts of `eggshell_tpu_torch.examples`
on the CPU: the outcome asserts of tests/test_examples_physics.py:63-80
(fdtd_aperture at n = 96) and :48-60 (chain_swing), and the JAX example
modules' own return values: `fdtd_aperture`'s ez at n = 48 within 1e-5
of the field's scale (float32 in both; the JAX source term is summed in
float64 under x64), `chain_swing`'s trajectory p within 1e-8 (float64).

chain_swing runs 12 steps where tests/test_examples_physics.py runs 200:
the port's single-scene PGS at 60 sweeps is a Python row loop over the
chain's 222 rows, about 1.2 s a step on this CPU.  At 12 steps the links
stay joined, but the swing check (the chain moves 0.05 m) needs about
100 steps of fall and is not made here.  box_drop, which no JAX test
runs, is drawn after 3 steps.
"""

import importlib.util
import os

import numpy as np
import torch

from eggshell_tpu_torch.examples import box_drop, chain_swing, fdtd_aperture
from torch_limits import time_limit  # noqa: F401

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FDTD_REL = 1e-5
CHAIN_TOL = 1e-8
CHAIN_STEPS = 12


def _load_jax(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fdtd_aperture_diffracts_and_blocks(tmp_path):
    """Energy passes THROUGH the aperture (diffraction) while the PEC
    wall blocks the rest: deep-shadow field << aperture-beam field."""
    leak, ez = fdtd_aperture.main(str(tmp_path), n=96, device=CPU)
    assert (tmp_path / "fdtd_aperture.png").exists()
    n = ez.shape[0]
    assert np.isfinite(ez).all()
    assert leak > 1e-3, "nothing diffracted through the aperture"
    beam = np.abs(ez[n // 2 - 8: n // 2 + 8, n // 2 + 4:]).max()
    shadow = max(np.abs(ez[: n // 6, n // 2 + 4:]).max(), np.abs(ez[-n // 6:, n // 2 + 4:]).max())
    assert shadow < 0.5 * beam, f"PEC wall not shadowing: shadow={shadow:.2e} beam={beam:.2e}"


def test_fdtd_aperture_matches_jax_example(tmp_path):
    jleak, jez = _load_jax("fdtd_aperture").main(str(tmp_path), n=48)
    leak, ez = fdtd_aperture.main(str(tmp_path), n=48, render=False, device=CPU)
    scale = float(np.abs(jez).max())
    np.testing.assert_allclose(ez, np.asarray(jez), rtol=0, atol=FDTD_REL * scale)
    np.testing.assert_allclose(leak, jleak, rtol=10 * FDTD_REL)


def test_chain_swing_matches_jax_example_and_holds_together(tmp_path):
    """12 steps, float64: the JAX module's trajectory within 1e-8; finite,
    the links joined (neighbour distance below 0.75); the GIF written."""
    (tmp_path / "jax").mkdir()
    _, jtraj = _load_jax("chain_swing").main(str(tmp_path / "jax"), steps=CHAIN_STEPS)
    final, traj = chain_swing.main(str(tmp_path), steps=CHAIN_STEPS, device=CPU,
                                   dtype=torch.float64)
    assert (tmp_path / "chain_swing.gif").exists()
    p = traj.p.numpy()
    assert p.shape == (CHAIN_STEPS, 10, 3) and torch.equal(final.p, traj.p[-1])
    np.testing.assert_allclose(p, np.asarray(jtraj.p), rtol=0, atol=CHAIN_TOL)
    assert np.isfinite(p).all()
    d = np.linalg.norm(p[:, 1:] - p[:, :-1], axis=-1)
    assert d.max() < 0.75, f"chain broke apart: max link gap {d.max():.3f}"


def test_box_drop_renders(tmp_path, capsys):
    box_drop.main(str(tmp_path), steps=3, device=CPU)
    assert (tmp_path / "box_drop_z.png").exists() and (tmp_path / "box_drop_final.png").exists()
    assert "rest height: " in capsys.readouterr().out
    spec, cfg, final, traj = box_drop.simulate(3, device=CPU)
    assert traj.p.dtype == torch.float32 and traj.p.shape == (3, 1, 3)
    assert float(traj.p[-1, 0, 2]) < float(traj.p[0, 0, 2]) < 0.5
