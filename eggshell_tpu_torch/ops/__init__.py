"""The port's operations: the kernel wrappers (`*_kernel.py`), each beside
its plain version, and the torch operations around them."""

from eggshell_tpu_torch.ops import quaternion  # noqa: F401


def launch_counters() -> dict:
    """Every kernel wrapper of the port by name; each counts its kernel's
    launches in its `launches` attribute (one where it launches, nowhere
    else)."""
    from eggshell_tpu_torch.fem.fdtd import step_2d_fused
    from eggshell_tpu_torch.ops.amat_kernel import contact_system_matrix
    from eggshell_tpu_torch.ops.collision_kernel import (collide_boxes_lanes,
                                                        collide_boxes_lanes_packed)
    from eggshell_tpu_torch.ops.compact_kernel import compact_contacts
    from eggshell_tpu_torch.ops.integrate_kernel import integrate_step
    from eggshell_tpu_torch.ops.jassembly_kernel import contact_jacobian_blocks
    from eggshell_tpu_torch.ops.pgs_kernel import (solve_lcp_jacobi, solve_lcp_jacobi_block,
                                                   solve_lcp_jacobi_packed,
                                                   solve_lcp_jacobi_packed_block,
                                                   solve_lcp_jacobi_packed_pyramid,
                                                   solve_lcp_jacobi_packed_stream)
    from eggshell_tpu_torch.ops.prep_kernel import prep_bodies

    return {"narrowphase": collide_boxes_lanes, "narrowphase_packed": collide_boxes_lanes_packed,
            "compact": compact_contacts, "jacobi": solve_lcp_jacobi,
            "jacobi_block": solve_lcp_jacobi_block,
            "jacobi_packed_stream": solve_lcp_jacobi_packed_stream,
            "jacobi_packed_block": solve_lcp_jacobi_packed_block,
            "jacobi_packed_pyramid": solve_lcp_jacobi_packed_pyramid, "fdtd2d": step_2d_fused,
            "prep": prep_bodies, "jassembly": contact_jacobian_blocks,
            "amat": contact_system_matrix, "jacobi_packed": solve_lcp_jacobi_packed,
            "integrate": integrate_step}
