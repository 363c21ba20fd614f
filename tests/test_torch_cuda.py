"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Every test here needs a CUDA card and skips without one. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX for the JAX package's tests).
"""

import pytest
import torch

from torch_inputs import warp_inputs

from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend, warp_blend_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("at_bound", [False, True])
@pytest.mark.parametrize("size,c", [(256, 128), (128, 256), (64, 512), (32, 512)])
def test_warp_blend_kernel_on_card(cuda, size, c, at_bound):
    """The warp-blend kernel at the main-path shapes, with the flow inside
    and pinned at the bound; within 1e-5 of max|target| (float32 on both
    sides, the kernel rounds its tap positions as the plain version does)."""
    x, grid, alpha = (torch.from_numpy(a).to(cuda) for a in
                      warp_inputs(2, size, c, 0.08, seed=5, at_bound=at_bound))
    before = warp_blend.launches
    out = warp_blend(x, grid, alpha)
    ref = warp_blend_reference(x, grid, alpha)
    torch.cuda.synchronize()
    assert warp_blend.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-5 * float(x.abs().max())


@pytest.mark.cuda
def test_warp_blend_kernel_bf16_target(cuda):
    """A bfloat16 target with float32 math: within one bf16 step of
    max|target| of the plain version on the same (rounded) target."""
    x, grid, alpha = (torch.from_numpy(a).to(cuda) for a in
                      warp_inputs(2, 64, 512, 0.08, seed=6))
    xb = x.to(torch.bfloat16)
    out = warp_blend(xb, grid, alpha)
    assert out.dtype == torch.bfloat16
    ref = warp_blend_reference(xb.float(), grid, alpha)
    assert float((out.float() - ref).abs().max()) <= 2.0 ** -8 * float(x.abs().max())
