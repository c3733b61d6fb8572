"""Interactive simulation viewer — the eggshell_view run/step loop
(ref eggshell/eggshell_view.cc:497-554: GLViewer with a run toggle,
single-step, and a sim timer) on a matplotlib window.

Keyboard bindings (the reference's single-key scheme):
  space  toggle run/pause          (ref ToggleRunning :522-527)
  s      single step while paused  (ref single-step)
  r      reset to the initial state
  q      close

Camera + picking (ref toolkit/camera.h, viewer.h, color_based_
selection.h — see viz/camera.py):
  arrows toggle orbit (yaw/pitch)  (ref rotate drag)
  +/-    zoom in/out               (ref wheel zoom)
  scroll zoom                      (ref wheel zoom)
  click  pick the body under the cursor; the selection is
         highlighted and named in the title (ref color-ID picking)

Works with any interactive matplotlib backend; under a headless Agg
backend the event loop degrades to programmatic `step_once()` /
`render_frame()` calls (which is also how the smoke test drives it) and
`run_headless()` writes an animation instead.

Counterpart of `eggshell_tpu.viz.interactive`: a frame advances
`steps_per_frame` steps of the port's single-scene `step_ode` in a plain
loop (the unfused branch at a batch of one, which a CUDA graph cannot
capture; on the card B2 takes the box pairs of a float32 scene).  The
state is pulled to the host once a drawn frame.  matplotlib is imported
only by the drawing and event methods.  It keeps the JAX viewer's two
known defects for parity (ROADMAP C, "Reference defects"): zoom changes
`camera.distance` but neither the drawn limits nor the pick camera, and a
click is unprojected against the whole canvas, not the axes' box.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.physics.stepper import step_ode
from eggshell_tpu_torch.utils.config import SimConfig
from eggshell_tpu_torch.viz.camera import Camera, pick_body
from eggshell_tpu_torch.viz.plot import as_numpy
from eggshell_tpu_torch.viz.scene_view import _box_faces


class InteractiveViewer:
    """Run/pause/step viewer for one scene."""

    def __init__(self, spec: SceneSpec, state: State, cfg: SimConfig,
                 steps_per_frame: int = 5, elev: float = 20,
                 azim: float = -60):
        self.spec = spec
        self.cfg = cfg
        self.initial_state = state
        self.state = state
        self.steps_per_frame = steps_per_frame
        self.running = False
        self.sim_steps = 0
        self.camera = Camera(elev=elev, azim=azim)
        self.selected = -1          # picked body index, -1 = none
        self._fig = None
        self._ax = None

    # ---- simulation control (the reference's slots) ----
    def step_once(self) -> None:
        """Advance steps_per_frame sim steps (ref OnSimulationTimeout)."""
        st = self.state
        for _ in range(self.steps_per_frame):
            st, _ = step_ode(self.spec, st, self.cfg)
        self.state = st
        self.sim_steps += self.steps_per_frame

    def toggle_running(self) -> None:
        self.running = not self.running

    def reset(self) -> None:
        self.state = self.initial_state
        self.sim_steps = 0

    # ---- drawing ----
    def render_frame(self, ax=None):
        """Draw the current state into a 3D axes (creates one if None).
        Returns the axes."""
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        if ax is None:
            if self._fig is None:
                self._fig = plt.figure(figsize=(7, 6))
                self._ax = self._fig.add_subplot(111, projection="3d")
            ax = self._ax
        ax.clear()
        p = as_numpy(self.state.p)
        R = as_numpy(self.state.R())
        h = as_numpy(self.spec.half_extents)
        inv_mass = as_numpy(self.spec.inv_mass)
        lim = max(1.0, float(np.abs(p).max()) + float(h.max()))
        for i in range(self.spec.num_bodies):
            faces = _box_faces(p[i], R[i], h[i])
            col = Poly3DCollection(faces, alpha=0.8, linewidths=0.5,
                                   edgecolors="k")
            static = float(inv_mass[i]) == 0.0
            if i == self.selected:
                col.set_facecolor("#e0813c")    # picked highlight
            else:
                col.set_facecolor("#b0b0b0" if static else "#4c8ed9")
            ax.add_collection3d(col)
        cam = self.camera
        ax.set_xlim(cam.target[0] - lim, cam.target[0] + lim)
        ax.set_ylim(cam.target[1] - lim, cam.target[1] + lim)
        ax.set_zlim(0, 2 * lim)
        ax.view_init(elev=cam.elev, azim=cam.azim)
        sel = f"  sel=body{self.selected}" if self.selected >= 0 else ""
        ax.set_title(
            f"t = {self.sim_steps * self.cfg.dt:.3f} s  "
            f"[{'running' if self.running else 'paused'}]{sel}  "
            "space=run/pause  s=step  r=reset  q=quit  "
            "arrows=orbit  +/-=zoom  click=pick"
        )
        return ax

    # ---- camera + picking (ref toolkit/camera.h, viewer.h) ----
    def _sync_camera_from_axes(self) -> None:
        """Adopt any orbit the user did with matplotlib's built-in drag
        so our camera (the picking source of truth) follows the view."""
        if self._ax is not None:
            self.camera.elev = float(self._ax.elev)
            self.camera.azim = float(self._ax.azim)

    def pick(self, x: float, y: float, width: int = None,
             height: int = None) -> int:
        """Pick the body under pixel (x, y) (lower-left origin) and
        select it; returns the body index or -1 (ref color_based_
        selection.h:18-24).  width/height default to the canvas size."""
        self._sync_camera_from_axes()
        if width is None or height is None:
            if self._fig is not None:
                width, height = map(int, self._fig.canvas.get_width_height())
            else:
                width, height = 640, 480
        p = as_numpy(self.state.p)
        R = as_numpy(self.state.R())
        h = as_numpy(self.spec.half_extents)
        cam = self._pick_camera(p, h)
        self.selected = pick_body(cam, x, y, width, height, p, R, h)
        return self.selected

    def _pick_camera(self, p, h) -> Camera:
        """matplotlib Axes3D is near-orthographic; build a throwaway
        ortho camera whose view window matches the axis box that
        render_frame established (x/y centered on target, z in
        [0, 2*lim] so the vertical center is z=lim)."""
        lim = max(1.0, float(np.abs(p).max()) + float(h.max()))
        return Camera(
            target=np.array([self.camera.target[0],
                             self.camera.target[1], lim]),
            distance=lim / np.tan(np.deg2rad(self.camera.fov_deg) / 2.0),
            azim=self.camera.azim, elev=self.camera.elev,
            fov_deg=self.camera.fov_deg, ortho=True,
        )

    def body_pixel(self, i: int, width: int = 640,
                   height: int = 480) -> np.ndarray:
        """Pixel coordinates (lower-left origin) of body i's center in
        the current view — the gl_utils project analog, and the inverse
        of pick() for test/annotation use."""
        self._sync_camera_from_axes()
        p = as_numpy(self.state.p)
        h = as_numpy(self.spec.half_extents)
        cam = self._pick_camera(p, h)
        return cam.project(p[i], width, height)[0]

    # ---- event loop ----
    def _on_key(self, event) -> None:
        import matplotlib.pyplot as plt

        if event.key == " ":
            self.toggle_running()
        elif event.key == "s" and not self.running:
            self.step_once()
        elif event.key == "r":
            self.reset()
        elif event.key == "q":
            plt.close(self._fig)
            return
        elif event.key in ("left", "right", "up", "down"):
            self._sync_camera_from_axes()
            d = {"left": (-5, 0), "right": (5, 0),
                 "up": (0, 5), "down": (0, -5)}[event.key]
            self.camera.orbit(*d)
        elif event.key in ("+", "="):
            self.camera.zoom(1 / 1.2)
        elif event.key == "-":
            self.camera.zoom(1.2)
        self.render_frame()
        self._fig.canvas.draw_idle()

    def _on_scroll(self, event) -> None:
        self.camera.zoom(1 / 1.2 if event.button == "up" else 1.2)
        self.render_frame()
        self._fig.canvas.draw_idle()

    def _on_click(self, event) -> None:
        if event.inaxes is not self._ax or event.x is None:
            return
        self.pick(event.x, event.y)
        self.render_frame()
        self._fig.canvas.draw_idle()

    def show(self, frame_ms: int = 30) -> None:
        """Open the interactive window and run the timer loop (requires
        an interactive matplotlib backend; use run_headless otherwise)."""
        import matplotlib
        import matplotlib.pyplot as plt

        if matplotlib.get_backend().lower().startswith("agg"):
            raise RuntimeError(
                "no interactive matplotlib backend; use run_headless()"
            )
        self.render_frame()
        self._fig.canvas.mpl_connect("key_press_event", self._on_key)
        self._fig.canvas.mpl_connect("scroll_event", self._on_scroll)
        self._fig.canvas.mpl_connect("button_press_event", self._on_click)
        timer = self._fig.canvas.new_timer(interval=frame_ms)

        def tick():
            if self.running:
                self.step_once()
                self.render_frame()
                self._fig.canvas.draw_idle()

        timer.add_callback(tick)
        timer.start()
        plt.show()

    def run_headless(self, path: str, frames: int = 60,
                     fps: int = 20) -> None:
        """Headless fallback: advance and record `frames` frames to an
        animated GIF at `path`."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.animation as anim
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(111, projection="3d")

        def update(_):
            self.step_once()
            self.render_frame(ax)
            return []

        a = anim.FuncAnimation(fig, update, frames=frames, blit=False)
        a.save(path, writer=anim.PillowWriter(fps=fps))
        plt.close(fig)
