"""The port's hand-written CUDA kernels (warp-blend, the packed conv B3, the
packed stage B4) against their plain PyTorch versions on the card. Every
test here needs a CUDA card and skips without one. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX for the JAX package's tests).
"""

import pytest
import torch

from torch_inputs import PAIR_KEYS, packed_stage_inputs, warp_inputs

from ood_gan_inversion_tpu_torch.ops import packed_conv
from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend, warp_blend_reference

# packed kernels: float32 sums in another order than cuDNN's over up to
# K = 9 * 256 terms -> 1e-4 of max|ref|; bfloat16 operands against the plain
# version on the same rounded operands in float32 -> 2^-7 of max|ref| (the
# output's rounding, 2^-9 relative, plus that of conv1's activation which
# conv2 reads in bfloat16)
PACKED_TOL = 1e-4
PACKED_TOL_BF16 = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False      # the plain versions in float32
    torch.backends.cuda.matmul.allow_tf32 = False
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


def packed_operands(dev, b, h, w, c1, c4, dtype, seed=0):
    """(kernel operands, float32 operands of the plain version): x, skip
    and the kernels rounded to `dtype`, the rest float32."""
    a = {k: torch.from_numpy(v).to(dev)
         for k, v in packed_stage_inputs(b, h, w, c1, c4, seed).items()}
    for k in ("x", "skip", "k1", "k2", "k3sr", "k4"):
        a[k] = a[k].to(dtype)
    return a, {k: v.float() for k, v in a.items()}


def rel_err(got, ref):
    return float((got.float() - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, PACKED_TOL),
                                       (torch.bfloat16, PACKED_TOL_BF16)])
@pytest.mark.parametrize("b,h,w,ci,co", [(1, 256, 256, 256, 256),   # 512px stage conv2
                                         (2, 37, 45, 12, 40)])      # ragged tiles
def test_packed_conv_kernel_on_card(cuda, b, h, w, ci, co, dtype, tol):
    """One launch of the packed conv kernel (B3) against its plain version."""
    a, ref_args = packed_operands(cuda, b, h, w, ci, co, dtype, seed=ci + co)
    names = ("x", "n1", "k1", "s1", "d1", "b1")
    before = packed_conv.fused_conv3x3_act.launches
    out = packed_conv.fused_conv3x3_act(*(a[k] for k in names))
    ref = packed_conv.packed_conv3x3_act_reference(*(ref_args[k] for k in names))
    torch.cuda.synchronize()
    assert packed_conv.fused_conv3x3_act.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, h, w, co)
    assert rel_err(out, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, PACKED_TOL),
                                       (torch.bfloat16, PACKED_TOL_BF16)])
@pytest.mark.parametrize("b,h,w,c1,c4", [(1, 256, 256, 128, 256),   # 512px stage
                                         (2, 19, 27, 12, 20)])      # ragged tiles
def test_packed_stage_kernel_on_card(cuda, b, h, w, c1, c4, dtype, tol):
    """The whole-stage kernel (B4) against its plain version: z2 and rgb."""
    a, ref_args = packed_operands(cuda, b, h, w, c1, c4, dtype, seed=c1 + c4)
    before = packed_conv.fused_packed_stage.launches
    rgb, z2 = packed_conv.fused_packed_stage(*a.values())
    rgb_ref, z2_ref = packed_conv.packed_stage_reference(*ref_args.values())
    torch.cuda.synchronize()
    assert packed_conv.fused_packed_stage.launches == before + 1
    assert rgb.dtype == z2.dtype == dtype and rgb.shape == (b, h, w, 12)
    assert rel_err(z2, z2_ref) <= tol
    assert rel_err(rgb, rgb_ref) <= tol


@pytest.mark.cuda
def test_packed_pair_launches_the_conv_kernel_twice(cuda):
    a, ref_args = packed_operands(cuda, 2, 32, 32, 16, 32, torch.float32)
    before = packed_conv.fused_conv3x3_act.launches
    out = packed_conv.fused_packed_pair(*(a[k] for k in PAIR_KEYS))
    ref = packed_conv.packed_pair_reference(*(ref_args[k] for k in PAIR_KEYS))
    torch.cuda.synchronize()
    assert packed_conv.fused_conv3x3_act.launches == before + 2
    assert rel_err(out, ref) <= PACKED_TOL


@pytest.mark.cuda
def test_packed_kernels_give_each_batch_slot_its_own_result(cuda):
    """A sample's outputs do not depend on the other samples of the batch:
    slot 1 of a batch of 2 is bit-identical to that sample alone."""
    a, _ = packed_operands(cuda, 2, 40, 40, 16, 32, torch.float32, seed=9)
    # the per-sample operands lead with the batch axis, the kernels with 3
    one = {k: (v[1:].contiguous() if v.dim() > 1 and v.shape[0] == 2 else v)
           for k, v in a.items()}
    rgb, z2 = packed_conv.fused_packed_stage(*a.values())
    rgb1, z21 = packed_conv.fused_packed_stage(*one.values())
    pair = packed_conv.fused_packed_pair(*(a[k] for k in PAIR_KEYS))
    pair1 = packed_conv.fused_packed_pair(*(one[k] for k in PAIR_KEYS))
    torch.cuda.synchronize()
    assert torch.equal(rgb[1:], rgb1) and torch.equal(z2[1:], z21)
    assert torch.equal(pair[1:], pair1)
