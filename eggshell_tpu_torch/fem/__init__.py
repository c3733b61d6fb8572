"""The FEM / FDTD tier, counterpart of `eggshell_tpu.fem`.

Ported so far: the 2D FDTD core (`fem.fdtd`), with its fused step as a
hand-written CUDA kernel.  The 3D Yee scheme and the FEM engine are still
to port (ROADMAP A14).
"""
