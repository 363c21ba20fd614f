"""The port's hand-written CUDA kernels (warp-blend, the packed conv B3, the
packed stage B4, the AlignNet body0 kernels B2a and B2b, the conv3x3 +
activation B5 and the halo probe) against their plain PyTorch versions on
the card. Every
test here needs a CUDA card and skips without one. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX for the JAX package's tests).
"""

import pytest
import torch

from torch_inputs import (PAIR_KEYS, conv_act_inputs, packed_stage_inputs,
                          samm_body0_inputs, warp_inputs)

from ood_gan_inversion_tpu_torch.ops import alignnet, halo_probe, packed_conv, samm_conv
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


# ------------------------------------------------ AlignNet body0 kernels

# (b, C, H, W): AlignNet body0 at the four SAMM scales of the 1024px model
# (2C = 1024, 1024, 512, 256), and a ragged case (tiles of 8 x 16 pixels)
SAMM_CASES = [(1, 512, 32, 32), (1, 512, 64, 64), (1, 256, 128, 128),
              (1, 128, 256, 256), (2, 48, 19, 27)]
# float32: sums over up to K = 9 * 1024 terms in another order than cuDNN's
# -> 1e-4 of max|ref|; bfloat16 operands against the plain version on the
# same rounded operands in float32 -> 2^-7 of max|ref| (the kernels round
# x1 and their output to bfloat16)
SAMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def samm_operands(dev, b, c, h, w, dtype, seed=0):
    """(kernel operands, float32 operands of the plain versions): s, t and
    the conv kernels rounded to `dtype`; the coefficients of (s, t) and the
    PReLU slopes float32."""
    a = {k: torch.from_numpy(v).to(dev)
         for k, v in samm_body0_inputs(b, c, h, w, seed).items()}
    a["coeffs"] = alignnet._alignnet_coeffs(a["s"], a["t"], a["g1"], a["b1"], True, 1e-5)[0]
    for k in ("s", "t", "k1", "k2"):
        a[k] = a[k].to(dtype)
    return a, {k: v.float() for k, v in a.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w", SAMM_CASES)
def test_alignnet_conv_kernels_on_card(cuda, b, c, h, w, dtype):
    """B2a against its plain version; B2b on B2a's output against its plain
    version (y2 and both moments), twice, bit-identical."""
    a, r = samm_operands(cuda, b, c, h, w, dtype, seed=c + h)
    before = (alignnet.alignnet_conv1.launches, alignnet.alignnet_conv2.launches)
    z = alignnet.alignnet_conv1(a["s"], a["t"], a["coeffs"], a["k1"], a["alpha"])
    z_ref = alignnet.alignnet_conv1_reference(r["s"], r["t"], r["coeffs"], r["k1"], r["alpha"])
    y2, part = alignnet.alignnet_conv2(z, a["k2"])
    y2_ref, part_ref = alignnet.alignnet_conv2_reference(z.float(), r["k2"])
    y2_again, part_again = alignnet.alignnet_conv2(z, a["k2"])
    torch.cuda.synchronize()
    assert (alignnet.alignnet_conv1.launches, alignnet.alignnet_conv2.launches) == \
        (before[0] + 1, before[1] + 2)
    assert z.dtype == dtype and z.shape == (b, 2 * c, h, w)
    assert y2.dtype == part.dtype == torch.float32 and part.shape == (b, 2, 2 * c)
    tol = SAMM_TOL[dtype]
    assert rel_err(z, z_ref) <= tol
    # B2b reads the same operands as its plain version: float32 sums alone
    assert rel_err(y2, y2_ref) <= SAMM_TOL[torch.float32]
    for m in range(2):
        assert rel_err(part[:, m], part_ref[:, m]) <= SAMM_TOL[torch.float32]
    assert torch.equal(y2, y2_again) and torch.equal(part, part_again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,ci,co,h,w,act", [
    (1, 1024, 1024, 32, 32, "prelu"), (1, 1024, 1024, 64, 64, "none"),
    (1, 512, 512, 128, 128, "prelu"), (1, 256, 256, 256, 256, "none"),
    (2, 40, 136, 19, 27, "lrelu")])
def test_conv3x3_act_kernel_on_card(cuda, b, ci, co, h, w, act, dtype):
    """B5 against its plain version on the same (rounded) operands."""
    x, k, alpha = (torch.from_numpy(v).to(cuda)
                   for v in conv_act_inputs(b, ci, co, h, w, seed=ci + h))
    x, k = x.to(dtype), k.to(dtype)
    before = samm_conv.conv3x3_act.launches
    out = samm_conv.conv3x3_act(x, k, alpha, act)
    ref = samm_conv.conv3x3_act_reference(x.float(), k.float(), alpha, act)
    torch.cuda.synchronize()
    assert samm_conv.conv3x3_act.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, co, h, w)
    assert rel_err(out, ref) <= SAMM_TOL[dtype]


@pytest.mark.cuda
def test_samm_kernels_give_each_batch_slot_its_own_result(cuda):
    """Slot 1 of a batch of 2 is bit-identical to that sample alone, for
    B2a, B2b (moments included) and B5."""
    a, _ = samm_operands(cuda, 2, 64, 40, 40, torch.float32, seed=4)
    one = {k: (a[k][1:].contiguous() if k in ("s", "t", "coeffs") else a[k]) for k in a}
    z = alignnet.alignnet_conv1(a["s"], a["t"], a["coeffs"], a["k1"], a["alpha"])
    z1 = alignnet.alignnet_conv1(one["s"], one["t"], one["coeffs"], one["k1"], one["alpha"])
    y2, part = alignnet.alignnet_conv2(z, a["k2"])
    y21, part1 = alignnet.alignnet_conv2(z1, a["k2"])
    c = samm_conv.conv3x3_act(z, a["k2"], a["alpha"], "prelu")
    c1 = samm_conv.conv3x3_act(z1, a["k2"], a["alpha"], "prelu")
    torch.cuda.synchronize()
    assert torch.equal(z[1:], z1)
    assert torch.equal(y2[1:], y21) and torch.equal(part[1:], part1)
    assert torch.equal(c[1:], c1)


@pytest.mark.cuda
def test_fused_alignnet_body0_on_card(cuda):
    """The fused body0 (one B2a and one B2b launch between plain passes)
    against the algebraic body0 on the card: within 1e-4 of max|ref|."""
    a, _ = samm_operands(cuda, 2, 128, 64, 64, torch.float32, seed=6)
    args = [a[k] for k in ("s", "t", "g1", "b1", "k1", "alpha", "k2", "g2", "b2")]
    before = (alignnet.alignnet_conv1.launches, alignnet.alignnet_conv2.launches)
    out = alignnet.fused_alignnet_body0(*args, True)
    ref = alignnet.algebraic_alignnet_body0(*args, True)
    torch.cuda.synchronize()
    assert (alignnet.alignnet_conv1.launches, alignnet.alignnet_conv2.launches) == \
        (before[0] + 1, before[1] + 1)
    assert rel_err(out, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(32, 32), (37, 45)])
def test_box3x3_kernel_on_card(cuda, h, w):
    """The halo probe adds its 9 terms in the plain version's order:
    bit-identical."""
    x = torch.from_numpy(conv_act_inputs(1, 1, 1, h, w, seed=h)[0][0, 0]).to(cuda)
    before = halo_probe.box3x3.launches
    out = halo_probe.box3x3(x)
    ref = halo_probe.box3x3_reference(x)
    torch.cuda.synchronize()
    assert halo_probe.box3x3.launches == before + 1
    assert torch.equal(out, ref)
