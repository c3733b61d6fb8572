"""The 11 FEM example models of `eggshell_tpu_torch.examples` on the CPU.

- The outcome asserts of tests/test_examples_rama.py:25-89 (bend,
  polarizer, mode cutoffs, width transitions), on the port's modules at
  that file's sizes.
- The JAX example modules' own return values: `waveguide_bend.solve`'s
  (r, t) and `waveguide_modes.rectangular`'s cutoffs, within 1e-8
  relative (the port's FEM tolerance, tests/test_torch_fem.py).
- The seven models tests/test_examples_rama.py does not assert, each at
  its script's own mesh size, against what its script prints it for:
  the analytic |S11| of the slab, the L-shape's lambda_1 = 9.6397, the
  tunnelling doublet, the capacitor's field direction, the nanojet past
  the lens, the horn's beam and match, the coupler's split.  The bounds
  are this file's, set with a margin around the values the port and the
  JAX scripts both print (stated beside each).
"""

import importlib.util
import os

import numpy as np
import pytest

from eggshell_tpu_torch.examples import (alma_coupler, capacitor_es, cavity_modes, horn_antenna,
                                         photonic_nanojet, schrodinger_barrier, waveguide_bend,
                                         waveguide_modes, waveguide_s11, waveguide_transition,
                                         wire_polarizer)
from torch_limits import time_limit  # noqa: F401

CPU = "cpu"
FEM_REL = 1e-8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------- tests/test_examples_rama.py:25-89


def test_waveguide_bend_reflection_vs_radius():
    _, (r_sharp, t_sharp) = waveguide_bend.solve(70.0, device=CPU)
    _, (r_gentle, t_gentle) = waveguide_bend.solve(220.0, device=CPU)
    assert abs(r_sharp) > 3 * abs(r_gentle), (abs(r_sharp), abs(r_gentle))
    assert abs(r_gentle) < 0.01
    for r, t in ((r_sharp, t_sharp), (r_gentle, t_gentle)):
        assert abs(abs(r) ** 2 + abs(t) ** 2 - 1.0) < 0.03


def test_wire_polarizer():
    mesh = wire_polarizer.build(h=0.12)
    _, (r_ez, t_ez) = wire_polarizer.solve("EZ", mesh=mesh, device=CPU)
    _, (r_exy, t_exy) = wire_polarizer.solve("EXY", mesh=mesh, device=CPU)
    assert abs(t_ez) < 0.25, abs(t_ez)
    assert abs(r_ez) > 0.95, abs(r_ez)
    assert abs(t_exy) > 0.95, abs(t_exy)
    assert abs(r_exy) < 0.25, abs(r_exy)


def test_waveguide_mode_cutoffs_vs_analytic():
    a, K = 122.0, 0.5
    (_, kc_te), (_, kc_tm) = waveguide_modes.rectangular(a, K, h=4.0, device=CPU)
    np.testing.assert_allclose(kc_te[0], np.pi / a, rtol=0.01)
    np.testing.assert_allclose(kc_tm[0], np.pi * np.hypot(1 / a, 1 / (K * a)), rtol=0.01)
    # TE20 and TE01 are degenerate for aspect 0.5 (kc = 2pi/a = pi/b)
    np.testing.assert_allclose(kc_te[1], 2 * np.pi / a, rtol=0.01)
    np.testing.assert_allclose(kc_te[2], 2 * np.pi / a, rtol=0.01)

    (_, ckc_te), (_, ckc_tm) = waveguide_modes.circular(61.0, h=4.0, device=CPU)
    np.testing.assert_allclose(ckc_te[0], 1.84118 / 61.0, rtol=0.01)
    np.testing.assert_allclose(ckc_tm[0], 2.40483 / 61.0, rtol=0.01)


def test_waveguide_transition():
    wc = waveguide_transition.cutoff_width_mil()
    assert 70.0 < wc < 122.0   # the test frequencies straddle cutoff

    def solve(w1, w2, taper):
        return waveguide_transition.solve(w1, w2, taper, h=6.0, device=CPU)[1]

    r0, t0 = solve(122.0, 122.0, 50.0)
    assert abs(r0) < 0.02 and abs(t0) > 0.99
    r_cut, t_cut = solve(122.0, 70.0, 50.0)
    assert abs(r_cut) > 0.98 and abs(t_cut) < 0.05
    r_ab, t_ab = solve(122.0, 200.0, 5.0)
    r_tp, t_tp = solve(122.0, 200.0, 300.0)
    assert abs(r_ab) > 3 * abs(r_tp), (abs(r_ab), abs(r_tp))
    for r, t in ((r_ab, t_ab), (r_tp, t_tp)):
        assert abs(abs(r) ** 2 + abs(t) ** 2 - 1.0) < 0.01


# ----------------------------------------- the JAX example modules' own values


def test_bend_solve_matches_jax_example():
    want = _load_jax("waveguide_bend").solve(150.0, h=10.0)[1]
    got = waveguide_bend.solve(150.0, h=10.0, device=CPU)[1]
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0, atol=FEM_REL)


def test_mode_cutoffs_match_jax_example():
    want = _load_jax("waveguide_modes").rectangular(122.0, 0.5, h=6.0, num_modes=4)
    got = waveguide_modes.rectangular(122.0, 0.5, h=6.0, num_modes=4, device=CPU)
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=FEM_REL)


# ---------------------------------------- the models the JAX tests leave out


def test_waveguide_s11_follows_transmission_line():
    """Printed max error 0.0147 (both packages); bound 0.05."""
    _, ks, fem, ana, sol = waveguide_s11.sweep(device=CPU)
    assert len(fem) == len(ks) == 11 and np.isfinite(sol.field.numpy()).all()
    assert np.abs(np.asarray(fem) - np.asarray(ana)).max() < 0.05


def test_cavity_lshape_eigenvalues():
    """lambda_1 of the L-shape [0, 2]^2 minus a quadrant is 9.6397; the
    mesh gives 9.723 (both packages); bound 2 %."""
    _, vals, vecs = cavity_modes.modes(device=CPU)
    assert vals.shape == (4,) and vecs.shape[1] == 4
    assert np.all(np.diff(vals) > 0) and vals[0] > 0
    np.testing.assert_allclose(vals[0], 9.6397, rtol=0.02)


def test_schrodinger_doublet_closes():
    """E1 - E0 shrinks as the barrier grows (7.443, 2.768, 0.122)."""
    _, out = schrodinger_barrier.levels(device=CPU)
    gaps = [vals[1] - vals[0] for _, vals, _ in out]
    assert gaps[0] > gaps[1] > gaps[2] > 0
    assert gaps[2] < 0.05 * gaps[0]


def test_capacitor_field_points_from_plus_to_minus():
    """The field between the plates points from the +0.5 V plate (y = 1.2)
    to the -0.5 V one: Ey < 0, larger than Ex.  Both packages print
    E = (-0.343, -1.070) against the ideal |Ey| 2.564 (ROADMAP C)."""
    _, phi, E = capacitor_es.solve(device=CPU)
    assert np.isfinite(phi).all() and abs(phi).max() <= 0.5 + 1e-9
    assert E[1] < 0 and abs(E[1]) > abs(E[0])


def test_nanojet_focus_behind_the_lens():
    """The |Ez| peak on the axis lies past the back face (x = 5.04)."""
    _, sol, xs, amps = photonic_nanojet.solve(device=CPU)
    i = int(np.nanargmax(amps))
    assert np.isfinite(amps).all() and photonic_nanojet.BACK_FACE < xs[i] < 6.5


def test_horn_beam_and_match():
    """|S11| 0.049, peak at 0 deg, directivity 4.2, beamwidth 33 deg."""
    mesh, cfg, sol = horn_antenna.solve(device=CPU)
    _, _, peak, d, bw, pc = horn_antenna.pattern(mesh, cfg, sol)
    assert abs(sol.s_params[1]) < 0.15
    assert abs(peak) <= 5.0 and d > 3.0 and 20.0 < bw < 50.0
    assert np.isfinite(pc).all()


def test_alma_coupler_splits():
    """Ports 3 and 4 near -3 dB (-2.74, -3.37), 1 and 2 isolated (-31.4,
    -33.8), power sum 0.9937."""
    _, sol = alma_coupler.solve(device=CPU)
    db = {p: 10 * np.log10(abs(sol.s_params[p]) ** 2) for p in (1, 2, 3, 4)}
    assert -4.5 < db[3] < -2.0 and -4.5 < db[4] < -2.0
    assert db[1] < -20.0 and db[2] < -20.0
    assert abs(sum(abs(sol.s_params[p]) ** 2 for p in (1, 2, 3, 4)) - 1.0) < 0.02


@pytest.mark.parametrize("module", [cavity_modes, capacitor_es, alma_coupler],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_runs_without_rendering(module, capsys):
    """`main(render=False)` (alma_coupler has no render switch) prints its
    results and writes nothing."""
    if module is alma_coupler:
        module.main(device=CPU)
    else:
        module.main("/nonexistent-dir", render=False, device=CPU)
    assert "wrote" not in capsys.readouterr().out
