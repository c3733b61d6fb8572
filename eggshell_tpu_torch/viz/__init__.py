"""Plots, scene and field renders, the camera and picking, and the
interactive viewer: counterpart of `eggshell_tpu.viz`, with the same
exports.  Importing it imports no matplotlib: each drawing function
imports it when called."""

from eggshell_tpu_torch.viz.colormaps import colormap  # noqa: F401
from eggshell_tpu_torch.viz.plot import Figure  # noqa: F401
from eggshell_tpu_torch.viz.scene_view import (  # noqa: F401
    draw_scene,
    draw_field,
    draw_mesh,
    save_trajectory_animation,
)
from eggshell_tpu_torch.viz.interactive import InteractiveViewer  # noqa: F401
from eggshell_tpu_torch.viz.camera import (  # noqa: F401
    Camera,
    pick_body,
    ray_obb_distances,
)
