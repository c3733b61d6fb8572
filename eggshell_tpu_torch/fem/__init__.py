"""The FEM / FDTD tier, counterpart of `eggshell_tpu.fem`, with the same
exports.

- shape, mesher, ports, metal, antenna: the JAX package's numpy geometry
  stack (CSG shapes, the distmesh-style and structured meshers, port
  modes, conductor and antenna helpers), copied; meshes stay numpy on the
  host.
- sparse:       COO matvecs, the host SuperLU solve (a
                `torch.autograd.Function`), BiCGStab, LOBPCG and
                shift-invert eigensolvers on the device.
- block_tridiag: the block-cyclic-reduction direct solve on batched
                `torch.linalg`, native complex.
- helmholtz:    P1 assembly, driven solves with S-parameters, eigenmodes.
- fields:       probes, gradients, Poynting flux, sweeps, export.
- fdtd:         the 2D FDTD core with its fused step as a hand-written
                CUDA kernel, and the 3D Yee scheme with CPML walls in
                plain torch; no FDTD name is exported here.
"""

from eggshell_tpu_torch.fem.mesher import Mesh, mesh_shape  # noqa: F401
from eggshell_tpu_torch.fem.shape import (  # noqa: F401
    Circle, Polygon, Polyline, Rectangle, Shape,
)
