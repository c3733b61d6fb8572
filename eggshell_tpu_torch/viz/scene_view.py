"""Scene and field visualization — the GLViewer / eggshell_view tier
(eggshell/eggshell_view.cc Draw*, toolkit/viewer.h) as headless renders.

draw_scene renders oriented boxes + ground plane to PNG via matplotlib
3D; save_trajectory_animation writes a GIF of a rollout; draw_field /
draw_mesh render FEM solutions (the rama field display analog).

Counterpart of `eggshell_tpu.viz.scene_view`: states and fields may be
tensors on any device, taken to the host (`plot.as_numpy`); rotations
come from the port's `ops.quaternion`.  matplotlib is imported inside
each function, never at import.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from eggshell_tpu_torch.ops import quaternion as quat
from eggshell_tpu_torch.viz.plot import as_numpy


def _box_faces(p, R, h):
    s = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        float,
    )
    corners = p[None, :] + (s * h[None, :]) @ R.T
    idx = [
        [0, 1, 3, 2], [4, 5, 7, 6], [0, 1, 5, 4],
        [2, 3, 7, 6], [0, 2, 6, 4], [1, 3, 7, 5],
    ]
    return [corners[i] for i in idx]


def draw_scene(spec, state, path: str, elev: float = 20, azim: float = -60,
               title: Optional[str] = None):
    """Render the boxes of a SceneSpec/State to a PNG
    (DrawBox analog, eggshell/eggshell_view.cc:375-420)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    p = as_numpy(state.p)
    R = as_numpy(quat.quat_to_mat(state.q))
    h = as_numpy(spec.half_extents)
    static = as_numpy(spec.inv_mass) == 0

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    span = max(1.0, float(np.abs(p).max() + h.max()))
    gx, gy = np.meshgrid([-span, span], [-span, span])
    ax.plot_surface(gx, gy, np.zeros_like(gx), alpha=0.15, color="gray")
    for i in range(len(p)):
        faces = _box_faces(p[i], R[i], h[i])
        col = "#cfcf70" if static[i] else "#4c9ee0"
        ax.add_collection3d(
            Poly3DCollection(faces, facecolor=col, edgecolor="k",
                             linewidths=0.4, alpha=0.85)
        )
    ax.set_xlim(-span, span)
    ax.set_ylim(-span, span)
    ax.set_zlim(0, max(1.0, float((p[:, 2] + h[:, 2]).max()) * 1.2))
    ax.view_init(elev=elev, azim=azim)
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def save_trajectory_animation(spec, traj, path: str, stride: int = 10,
                              fps: int = 20):
    """GIF of a trajectory (State with leading time axis).  The analog
    of EggshellView's run loop rendering (eggshell_view.cc:497-554)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    P = as_numpy(traj.p)[::stride]
    RS = as_numpy(quat.quat_to_mat(traj.q[::stride]))
    h = as_numpy(spec.half_extents)
    static = as_numpy(spec.inv_mass) == 0
    span = max(1.0, float(np.abs(P).max() + h.max()))

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d")

    def frame(k):
        ax.cla()
        gx, gy = np.meshgrid([-span, span], [-span, span])
        ax.plot_surface(gx, gy, np.zeros_like(gx), alpha=0.15, color="gray")
        R = RS[k]
        for i in range(P.shape[1]):
            col = "#cfcf70" if static[i] else "#4c9ee0"
            ax.add_collection3d(
                Poly3DCollection(
                    _box_faces(P[k, i], R[i], h[i]),
                    facecolor=col, edgecolor="k", linewidths=0.3, alpha=0.85,
                )
            )
        ax.set_xlim(-span, span)
        ax.set_ylim(-span, span)
        ax.set_zlim(0, span)

    anim = FuncAnimation(fig, frame, frames=len(P))
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def draw_mesh(mesh, path: str):
    """Wireframe of a FEM mesh with boundary attributes colored
    (rama mesh display analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.triplot(
        mesh.points[:, 0], mesh.points[:, 1], mesh.triangles,
        linewidth=0.3, color="gray",
    )
    colors = {0: "k", 1: "tab:red", 2: "tab:blue"}
    for kind, col in colors.items():
        for e in mesh.boundary_edges[mesh.edge_kind == kind]:
            ax.plot(mesh.points[e, 0], mesh.points[e, 1], col, linewidth=1.5)
    ax.set_aspect("equal")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def draw_field(mesh, field, path: str, part: str = "real", cmap="jet"):
    """Nodal field over the mesh (rama's field display analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f = as_numpy(field)
    z = {"real": np.real, "imag": np.imag, "abs": np.abs}[part](f)
    fig, ax = plt.subplots(figsize=(7, 5))
    t = ax.tripcolor(
        mesh.points[:, 0], mesh.points[:, 1], mesh.triangles, z,
        shading="gouraud", cmap=cmap,
    )
    fig.colorbar(t, ax=ax)
    ax.set_aspect("equal")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
