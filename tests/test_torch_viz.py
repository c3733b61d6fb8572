"""Port parity: `eggshell_tpu_torch.viz` — colormaps, `Figure`, the
scene and FEM renders, the camera and geometric picking, and the
interactive viewer — against the JAX package's, on the CPU, with
matplotlib's Agg backend.

Mirrors tests/test_camera.py (its repeated checks merged into
parametrised cases, one case each) and tests/test_viz_models.py:12-45
and :91.  The viewer's state after a few frames is held to the JAX
viewer's on the same converted scene within 1e-8 in float64.  A process
of its own checks that importing `viz` and every ported example loads
neither matplotlib nor JAX.
"""

import dataclasses
import os
import subprocess
import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from eggshell_tpu.viz import camera as jcamera  # noqa: E402
from eggshell_tpu_torch import convert  # noqa: E402
from eggshell_tpu_torch.physics import scenes  # noqa: E402
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind  # noqa: E402
from eggshell_tpu_torch.viz import (Figure, InteractiveViewer, colormap, draw_field,  # noqa: E402
                                    draw_mesh, draw_scene, save_trajectory_animation)
from eggshell_tpu_torch.viz.camera import Camera, pick_body, ray_obb_distances  # noqa: E402
from torch_limits import time_limit  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWER_TOL = 1e-8
CPU = "cpu"
# tests/test_viz_models.py:98-100 and tests/test_camera.py:180-182
VIEWER_CFG = SimConfig(solver=SolverKind.PGS, solver_iters=30, conditional_cfm=False,
                       cfm_always=0.01, contact_capacity=16)


def _identity_rots(n):
    return np.broadcast_to(np.eye(3), (n, 3, 3)).copy()


# ------------------------------------------------------------------ camera


def test_eye_orbits_target():
    cam = Camera(distance=4.0, azim=0.0, elev=0.0)
    assert np.allclose(cam.eye(), [4.0, 0.0, 0.0])
    cam.orbit(90.0, 0.0)
    assert np.allclose(cam.eye(), [0.0, 4.0, 0.0], atol=1e-12)
    cam.orbit(0.0, 45.0)
    assert cam.eye()[2] > 0
    assert np.isclose(np.linalg.norm(cam.eye() - cam.target), 4.0)


@pytest.mark.parametrize("delev, bound", [(500.0, 89.0), (-500.0, -89.0)])
def test_orbit_clamps_pitch(delev, bound):
    cam = Camera()
    cam.orbit(0.0, delev)
    assert cam.elev == bound


def test_pan_moves_target_in_view_plane():
    cam = Camera(distance=5.0, azim=0.0, elev=0.0)
    f0 = cam.forward()
    cam.pan(1.0, 2.0)
    assert abs(float(cam.target @ f0)) < 1e-12
    assert np.isclose(np.linalg.norm(cam.target), np.sqrt(5.0))


def test_zoom_scales_distance_with_floor():
    cam = Camera(distance=2.0)
    cam.zoom(0.5)
    assert np.isclose(cam.distance, 1.0)
    cam.zoom(1e-9)
    assert cam.distance >= 1e-3


@pytest.mark.parametrize("kw, size, pt", [
    (dict(distance=6.0, azim=-45.0, elev=25.0), (640, 480), (0.3, -0.2, 0.5)),
    (dict(distance=6.0, azim=30.0, elev=-10.0, ortho=True), (400, 400), (-0.4, 0.1, 0.2)),
], ids=["perspective", "ortho"])
def test_project_unproject_roundtrip(kw, size, pt):
    cam = Camera(**kw)
    pt = np.array(pt)
    px = cam.project(pt, *size)[0]
    assert np.all(np.isfinite(px))
    o, d = cam.pixel_to_ray(px[0], px[1], *size)
    t = (pt - o) @ d
    assert t > 0
    assert np.linalg.norm(o + t * d - pt) < 1e-9


def test_point_behind_eye_is_nan():
    cam = Camera(distance=2.0, azim=0.0, elev=0.0)
    behind = cam.eye() - 3.0 * cam.forward()
    assert np.all(np.isnan(cam.project(behind, 100, 100)[0]))


def test_center_pixel_hits_target():
    cam = Camera(target=np.array([1.0, 2.0, 3.0]), distance=7.0, azim=33.0, elev=12.0)
    assert np.allclose(cam.project(cam.target, 640, 480)[0], [320.0, 240.0], atol=1e-6)


def test_camera_matches_jax_module():
    """Every verb and both projections of the copied camera give the JAX
    package's numbers bit for bit."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (16, 3))
    for ortho in (False, True):
        kw = dict(target=np.array([0.1, -0.2, 0.3]), distance=5.0, azim=-30.0, elev=15.0,
                  ortho=ortho)
        a, b = Camera(**kw), jcamera.Camera(**kw)
        for cam in (a, b):
            cam.orbit(12.0, -7.0)
            cam.pan(0.2, -0.1)
            cam.zoom(0.9)
        assert np.array_equal(a.project(pts, 640, 480), b.project(pts, 640, 480),
                              equal_nan=True)
        for x, y in ((10.0, 20.0), (320.0, 240.0), (600.0, 470.0)):
            for u, v in zip(a.pixel_to_ray(x, y, 640, 480), b.pixel_to_ray(x, y, 640, 480)):
                assert np.array_equal(u, v)


# --------------------------------------------------------- ray-box picking

_AX = dict(p=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]]), h=np.full((2, 3), 0.5))
_ONE = dict(p=np.zeros((1, 3)), h=np.full((1, 3), 0.5))
_C, _S = np.cos(np.pi / 4), np.sin(np.pi / 4)


@pytest.mark.parametrize("origin, direction, box, R, want", [
    ((-3.0, 0.0, 0.0), (1.0, 0.0, 0.0), _AX, None, [2.5, np.inf]),   # hit, miss
    ((3.0, 0.0, 0.0), (1.0, 0.0, 0.0), _ONE, None, [np.inf]),        # box behind
    ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), _ONE, None, [0.0]),           # inside
    ((-2.0, 0.2, 0.0), (1.0, 0.0, 0.0), _ONE, None, [1.5]),          # parallel, in slab
    ((-2.0, 0.8, 0.0), (1.0, 0.0, 0.0), _ONE, None, [np.inf]),       # parallel, out
    ((-3.0, 0.0, 0.0), (1.0, 0.0, 0.0), _ONE,
     np.array([[[_C, -_S, 0], [_S, _C, 0], [0, 0, 1.0]]]), [3.0 - np.sqrt(2) / 2]),
], ids=["axis_hit_and_miss", "behind", "origin_inside", "parallel_inside",
        "parallel_outside", "rotated"])
def test_ray_obb(origin, direction, box, R, want):
    n = box["p"].shape[0]
    R = _identity_rots(n) if R is None else R
    t = ray_obb_distances(np.array(origin), np.array(direction), box["p"], R, box["h"])
    np.testing.assert_allclose(t, want, rtol=0, atol=1e-12)
    tj = jcamera.ray_obb_distances(np.array(origin), np.array(direction), box["p"], R, box["h"])
    assert np.array_equal(t, tj)


def test_pick_nearest_of_stacked_bodies():
    cam = Camera(distance=10.0, azim=0.0, elev=0.0)
    p = np.array([[2.0, 0.0, 0.0], [-2.0, 0.0, 0.0]])
    assert pick_body(cam, 320, 240, 640, 480, p, _identity_rots(2), np.full((2, 3), 0.5)) == 0


def test_pick_miss_returns_minus_one():
    cam = Camera(distance=10.0, azim=0.0, elev=0.0)
    assert pick_body(cam, 0, 0, 640, 480, np.zeros((1, 3)), _identity_rots(1),
                     np.full((1, 3), 0.1)) == -1


@pytest.mark.parametrize("i", [0, 1])
def test_pick_through_projected_center(i):
    cam = Camera(distance=8.0, azim=-50.0, elev=30.0)
    p = np.array([[1.5, 0.0, 0.0], [-1.5, 0.5, 0.3]])
    h = np.full((2, 3), 0.3)
    px = cam.project(p[i], 640, 480)[0]
    assert pick_body(cam, px[0], px[1], 640, 480, p, _identity_rots(2), h) == i


def test_viewer_pick_and_camera_integration():
    """Click the rendered center of box_drop's box: it is selected and
    named in the title; a far corner deselects; the camera verbs leave the
    render working (tests/test_camera.py:170-214)."""
    cfg = VIEWER_CFG.replace(solver_iters=20)
    spec, state = scenes.box_drop(height=0.5, device=CPU)
    v = InteractiveViewer(spec, state, cfg)
    v.render_frame()
    w, h = 480, 480
    px = v.body_pixel(0, w, h)
    assert v.pick(px[0], px[1], w, h) == 0 and v.selected == 0
    assert "sel=body0" in v.render_frame().get_title()
    assert v.pick(1, 1, w, h) == -1 and v.selected == -1
    v.camera.orbit(30, 10)
    v.camera.zoom(0.8)
    v.camera.pan(0.1, 0.0)
    v.render_frame()
    import matplotlib.pyplot as plt

    plt.close("all")


# ------------------------------------------------------- plots and renders


@pytest.mark.parametrize("name", ["jet", "hot", "gray", "hsv"])
def test_colormaps(name):
    cm = colormap(name, 64)
    assert cm.shape == (64, 3)
    assert cm.min() >= 0 and cm.max() <= 1
    from eggshell_tpu.viz import colormap as jcolormap

    assert np.array_equal(cm, jcolormap(name, 64))


def test_colormap_unknown_raises():
    with pytest.raises(ValueError):
        colormap("nope")


def test_figure_saves(tmp_path):
    """Lists and tensors both plot (tensors go through the host)."""
    p = str(tmp_path / "fig.png")
    Figure().plot(torch.tensor([0.0, 1.0, 2.0]), [1, 0, 2]).xlabel("x").title("t").grid().save(p)
    assert os.path.getsize(p) > 1000


def test_draw_scene(tmp_path):
    spec, state = scenes.box_stack(3, device=CPU)
    p = draw_scene(spec, state, str(tmp_path / "scene.png"), title="stack")
    assert os.path.getsize(p) > 5000


def test_save_trajectory_animation(tmp_path):
    from eggshell_tpu_torch.parallel.rollout import batch_states

    spec, state = scenes.box_stack(2, device=CPU)
    traj = batch_states([state._replace(p=state.p + 0.01 * k) for k in range(3)])
    p = save_trajectory_animation(spec, traj, str(tmp_path / "traj.gif"), stride=1, fps=5)
    assert os.path.getsize(p) > 1000


def test_draw_mesh_and_field(tmp_path):
    from eggshell_tpu_torch.fem import Rectangle, mesh_shape

    wg = Rectangle(0, 0, 1.0, 1.0)
    wg.Port((0, 0), (0, 1), 1)
    m = mesh_shape(wg, 0.15)
    p1 = draw_mesh(m, str(tmp_path / "mesh.png"))
    f = torch.sin(torch.as_tensor(m.points[:, 0]) * np.pi)
    p2 = draw_field(m, f, str(tmp_path / "field.png"))
    assert os.path.getsize(p1) > 3000 and os.path.getsize(p2) > 3000


# ------------------------------------------------------------------ viewer


def test_interactive_viewer_step_loop(tmp_path):
    """The eggshell_view run/step-loop analog (tests/test_viz_models.py:91):
    programmatic step/run/reset controls advance the sim and render
    frames headlessly; run_headless records an animation."""
    spec, state = scenes.box_drop(height=0.5, device=CPU)
    v = InteractiveViewer(spec, state, VIEWER_CFG, steps_per_frame=10)
    z0 = float(v.state.p[0, 2])
    v.step_once()
    v.step_once()
    assert v.sim_steps == 20
    assert float(v.state.p[0, 2]) < z0          # the box is falling
    assert not v.running
    v.toggle_running()
    assert v.running
    assert v.render_frame() is not None
    v.reset()
    assert v.sim_steps == 0
    assert float(v.state.p[0, 2]) == z0
    out = str(tmp_path / "run.gif")
    v.run_headless(out, frames=3, fps=5)
    assert os.path.getsize(out) > 1000


def test_viewer_state_matches_jax_viewer():
    """box_stack(2) (ground and one box pair), 5 steps a frame, 3 frames:
    the port's viewer state equals the JAX viewer's within 1e-8, f64."""
    from eggshell_tpu.physics import scenes as jscenes
    from eggshell_tpu.utils.config import SimConfig as JSimConfig
    from eggshell_tpu.viz import InteractiveViewer as JViewer

    jspec, jst = jscenes.box_stack(2, jitter=0.02)
    spec = convert.spec_from_numpy(jspec._asdict(), device=CPU, dtype=torch.float64)
    st = convert.state_from_numpy(jst._asdict(), device=CPU, dtype=torch.float64)
    jv = JViewer(jspec, jst, JSimConfig.from_json(VIEWER_CFG.to_json()), steps_per_frame=5)
    v = InteractiveViewer(spec, st, VIEWER_CFG, steps_per_frame=5)
    for _ in range(3):
        jv.step_once()
        v.step_once()
    assert v.sim_steps == jv.sim_steps == 15
    for k in ("p", "v", "q", "w"):
        np.testing.assert_allclose(getattr(v.state, k).numpy(), np.asarray(getattr(jv.state, k)),
                                   rtol=0, atol=VIEWER_TOL, err_msg=k)


# ----------------------------------------------------------------- imports


def test_imports_load_neither_matplotlib_nor_jax():
    """`eggshell_tpu_torch.viz` and every example module import in a fresh
    process without loading matplotlib or JAX (the card's machine has no
    matplotlib)."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "eggshell_tpu_torch", "examples"))
                   if f.endswith(".py") and f != "__init__.py")
    assert len(names) == len([f for f in os.listdir(os.path.join(ROOT, "examples"))
                              if f.endswith(".py")])
    code = ("import importlib, sys; import eggshell_tpu_torch.viz;"
            f" [importlib.import_module('eggshell_tpu_torch.examples.' + n) for n in {names!r}];"
            " print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'matplotlib', 'jax', 'eggshell_tpu', 'mpl_toolkits'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
