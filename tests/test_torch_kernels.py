"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no interpret mode, so these tests need a CUDA device and
skip without one.  Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest -o addopts=""

The kernels are float32; tolerances are those of float32 arithmetic
summed in a different order (relative 1e-4 for the Jacobi solve, absolute
1e-4 for narrowphase positions and depths of O(1) boxes).
"""

import numpy as np
import pytest
import torch

from eggshell_tpu_torch.ops.collision import collide_boxes
from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes
from eggshell_tpu_torch.ops.pgs_kernel import solve_lcp_jacobi, solve_lcp_jacobi_plain
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics import scenes
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def _pairs(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    from eggshell_tpu_torch.ops.quaternion import quat_to_mat

    R = quat_to_mat(torch.tensor(q, dtype=torch.float32))
    R[:, ::4] = torch.eye(3)                      # aligned pairs, as in a stack
    c1 = rng.uniform(-1, 1, (n, 3))
    c2 = c1 + rng.uniform(-0.6, 0.6, (n, 3))
    h = rng.uniform(0.05, 0.5, (2, n, 3))
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    return f(c1), f(R[0]), f(h[0]), f(c2), f(R[1]), f(h[1])


def test_narrowphase_kernel_matches_plain(dev):
    args = _pairs(4096, dev)
    before = collide_boxes_lanes.launches
    got = collide_boxes_lanes(*args)
    want = collide_boxes(*args)
    torch.cuda.synchronize()
    assert collide_boxes_lanes.launches == before + 1
    same = got.code == want.code
    assert float(same.float().mean()) >= 0.99
    both = got.active & want.active & same[:, None]
    assert both.any()
    assert float((got.position - want.position).abs().amax(-1)[both].max()) <= 1e-4
    assert float((got.depth - want.depth).abs()[both].max()) <= 1e-4


def test_jacobi_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(0)
    B, m = 512, 60
    G = torch.randn(B, m, 24, generator=g)
    A = (G @ G.transpose(-1, -2) / 24 + torch.eye(m)).to(dev)
    b = torch.randn(B, m, generator=g).to(dev)
    row = torch.arange(m)
    is_eq = (row % 10 == 9).expand(B, m).contiguous().to(dev)
    lo = torch.where(row % 3 == 2, 0.0, -1.0).expand(B, m).contiguous().to(dev)
    hi = torch.where(row % 3 == 2, float("inf"), 1.0).expand(B, m).contiguous().to(dev)
    got = solve_lcp_jacobi(A, b, is_eq, lo, hi, 16, 0.3, 0.45)
    want = solve_lcp_jacobi_plain(A, b, is_eq, lo, hi, 16, 0.3, 0.45)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(dev):
    p1, R1, h1, p2, R2, h2 = _pairs(8, dev)
    with pytest.raises(TypeError):
        collide_boxes_lanes(p1.double(), R1, h1, p2, R2, h2)
    with pytest.raises(ValueError):
        collide_boxes_lanes(p1, R1[:4], h1, p2, R2, h2)
    A = torch.eye(300, device=dev).expand(2, 300, 300).contiguous()
    v = torch.zeros(2, 300, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        solve_lcp_jacobi(A, v, v > 0, v, v, 4, 0.3)


def test_slice_goes_through_both_kernels(dev):
    cfg = SimConfig(solver=SolverKind.JACOBI_KERNEL, solver_iters=16, jacobi_omega=0.3,
                    jacobi_beta=0.45, conditional_cfm=True, cond_estimator="power",
                    contact_capacity=20, contact_kernel=True)
    spec, st = scenes.box_stack(4, device=dev, dtype=torch.float32)
    states = State(*[x.expand((64,) + x.shape).clone() for x in st])
    n0, j0 = collide_boxes_lanes.launches, solve_lcp_jacobi.launches
    out = rollout_batched(spec, states, cfg, 5)
    torch.cuda.synchronize()
    assert collide_boxes_lanes.launches - n0 == 5 and solve_lcp_jacobi.launches - j0 == 5
    assert all(bool(torch.isfinite(x).all()) for x in out)
