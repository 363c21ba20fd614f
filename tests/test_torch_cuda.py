"""The port's hand-written CUDA kernels (warp-blend, the packed conv B3, the
packed stage B4, the AlignNet body0 kernels B2a and B2b, the conv3x3 +
activation B5 and the halo probe) against their plain PyTorch versions on
the card, and their autograd Functions' gradients against the plain
versions' own. Every test here needs a CUDA card and skips without one. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX for the JAX package's tests).
"""

import math

import pytest
import torch

from torch_inputs import (PAIR_KEYS, conv_act_inputs, packed_cancel_inputs,
                          packed_stage_inputs, samm_body0_inputs, tf32_cancel_inputs,
                          warp_inputs)

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
@pytest.mark.parametrize("dtype,c", [(torch.float32, 36), (torch.bfloat16, 36),
                                     (torch.bfloat16, 40)])
def test_warp_blend_kernel_ragged_on_card(cuda, dtype, c):
    """H and W off the 2 x 8 pixel tile, C = 36 (9 float32 vectors of 16
    bytes; not a multiple of 8, so bfloat16 takes the one-element path) and
    C = 40 in bfloat16 (5 vectors), the flow pinned at the bound so that
    taps fall outside the image: float32 within 1e-5 of max|target|,
    bfloat16 within one bf16 step of the plain version on the same target."""
    x, grid, alpha = (torch.from_numpy(a).to(cuda) for a in
                      warp_inputs(3, 19, c, 0.08, seed=c, at_bound=True))
    x, grid, alpha = x[:, :, :17].contiguous(), grid[:, :, :17].contiguous(), \
        alpha[:, :, :17].contiguous()
    xt = x.to(dtype)
    out = warp_blend(xt, grid, alpha)
    ref = warp_blend_reference(xt.float(), grid, alpha)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (3, 19, 17, c)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert float((out.float() - ref).abs().max()) <= tol * float(x.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_blend_kernel_slot_bitwise(cuda, dtype):
    """Slot 2 of a batch of 3 is bit-identical to that sample alone."""
    x, grid, alpha = (torch.from_numpy(a).to(cuda) for a in warp_inputs(3, 64, 512, 0.08, seed=8))
    x = x.to(dtype)
    out = warp_blend(x, grid, alpha)
    one = warp_blend(x[2:].contiguous(), grid[2:].contiguous(), alpha[2:].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out[2:], one)


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


def packed_operands(dev, b, h, w, c1, c4, dtype, seed=0, inputs=packed_stage_inputs):
    """(kernel operands, float32 operands of the plain version): x, skip
    and the kernels rounded to `dtype`, the rest float32."""
    a = {k: torch.from_numpy(v).to(dev)
         for k, v in inputs(b, h, w, c1, c4, seed).items()}
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


def check_packed_stage(a, ref_args, tol):
    """One call of the whole-stage kernels against the plain version: one
    launch counted, z2 and rgb within tol of max|ref|."""
    before = packed_conv.fused_packed_stage.launches
    rgb, z2 = packed_conv.fused_packed_stage(*a.values())
    rgb_ref, z2_ref = packed_conv.packed_stage_reference(*ref_args.values())
    torch.cuda.synchronize()
    assert packed_conv.fused_packed_stage.launches == before + 1
    assert rgb.dtype == z2.dtype == a["x"].dtype and rgb.shape == rgb_ref.shape
    assert rel_err(z2, z2_ref) <= tol
    assert rel_err(rgb, rgb_ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, PACKED_TOL),
                                       (torch.bfloat16, PACKED_TOL_BF16)])
@pytest.mark.parametrize("b,h,w,c1,c4", [(1, 256, 256, 128, 256),   # 512px stage
                                         (1, 512, 512, 64, 128),    # 1024px stage
                                         (2, 19, 27, 12, 20),       # ragged tiles
                                         # C4 beyond 469 (float32) and 938 (bfloat16),
                                         # where conv1's activation tile would not
                                         # fit in shared memory
                                         (1, 64, 64, 32, 512), (1, 40, 40, 16, 1024)])
def test_packed_stage_kernel_on_card(cuda, b, h, w, c1, c4, dtype, tol):
    """The whole-stage kernels (B4) against their plain version: z2 and rgb."""
    a, ref_args = packed_operands(cuda, b, h, w, c1, c4, dtype, seed=c1 + c4)
    check_packed_stage(a, ref_args, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("c1,c4", [(128, 256), (64, 128)])
def test_packed_stage_float32_accuracy_on_card(cuda, c1, c4):
    """B4 in float32 on inputs where both convs cancel a large common offset
    (`packed_cancel_inputs`), so a single TF32 pass would miss 1e-4 of
    max|ref| by ~30x (tests/test_torch_tf32_split.py): the 3xTF32 products
    meet it, for z2 and rgb."""
    a, ref_args = packed_operands(cuda, 1, 64, 64, c1, c4, torch.float32, seed=c1,
                                  inputs=packed_cancel_inputs)
    check_packed_stage(a, ref_args, PACKED_TOL)


@pytest.mark.cuda
def test_packed_stage_bf16_rounds_x_s1_on_card(cuda):
    """bfloat16 B4 against the plain version in float32 on conv1's input
    as JAX rounds it: x * s1 in bfloat16 (s1 rounded first), s1 then 1."""
    a, ref_args = packed_operands(cuda, 2, 64, 64, 64, 128, torch.bfloat16, seed=11)
    ref_args["x"] = (a["x"] * a["s1"][:, None, None, :].to(torch.bfloat16)).float()
    ref_args["s1"] = torch.ones_like(ref_args["s1"])
    check_packed_stage(a, ref_args, PACKED_TOL_BF16)


@pytest.mark.cuda
def test_packed_conv_bf16_rounds_x_s_in_on_card(cuda):
    """bfloat16 B3 rounds x * s_in as JAX does: s_in to bfloat16 first,
    then the product. With s_in = 1 + 2^-8, which bfloat16 rounds to 1, an
    identity kernel and no noise or bias, the output is lrelu(x) * sqrt(2)
    in float32 rounded once to bfloat16: within 2^-8 of each value (8
    significant bits). A kernel that multiplies by the unrounded s_in moves
    values by 2^-8 before that rounding, and many by up to 2^-7 after it."""
    b, h, w, c = 2, 32, 32, 64
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(b, h, w, c, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.zeros(3, 3, c, c, device=cuda)
    k[1, 1] = torch.eye(c, device=cuda)
    s_in = torch.full((b, c), 1.0 + 2.0 ** -8, device=cuda)
    ones, zeros = torch.ones(b, c, device=cuda), torch.zeros(c, device=cuda)
    noise = torch.zeros(b, h, w, 4, device=cuda)
    out = packed_conv.fused_conv3x3_act(x, noise, k.to(torch.bfloat16), s_in, ones, zeros)
    xf = x.float()
    ref = math.sqrt(2.0) * torch.where(xf >= 0, xf, 0.2 * xf)   # the plain epilogue on x
    torch.cuda.synchronize()
    assert float(((out.float() - ref).abs() / ref.abs()).max()) <= 2.0 ** -8


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
# (2C = 1024, 1024, 512, 256), and ragged cases: H, W off the pixel tile, and
# C not a multiple of 8 (nor 16), so that one of B2a's chunks of input
# channels straddles the s/t halves of x1
SAMM_CASES = [(1, 512, 32, 32), (1, 512, 64, 64), (1, 256, 128, 128),
              (1, 128, 256, 256), (2, 48, 19, 27), (2, 37, 19, 27), (1, 12, 100, 90)]
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


def conv1_ops(a):
    return [a[k] for k in ("s", "t", "coeffs", "k1", "alpha")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alignnet_conv1_at_32px_slot_bitwise(cuda, dtype):
    """B2a at 32px, C = 512 (the grid of small tiles), b = 3: each slot is
    bit-identical to that sample alone, and within tolerance of the plain
    version."""
    a, r = samm_operands(cuda, 3, 512, 32, 32, dtype, seed=3)
    z = alignnet.alignnet_conv1(*conv1_ops(a))
    for s in range(3):
        one = {k: (v[s:s + 1].contiguous() if k in ("s", "t", "coeffs") else v)
               for k, v in a.items()}
        assert torch.equal(z[s:s + 1], alignnet.alignnet_conv1(*conv1_ops(one))), s
    assert rel_err(z, alignnet.alignnet_conv1_reference(*conv1_ops(r))) <= SAMM_TOL[dtype]


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


def b5_and_b2b(x, k, alpha, act):
    """{kernel: (its output, the plain version's)} for B5 and B2b on the same
    operands: B5's output, and B2b's y2 with its two moments."""
    y2, part = alignnet.alignnet_conv2(x, k)
    y2_ref, part_ref = alignnet.alignnet_conv2_reference(x.float(), k.float())
    return {"B5": ([samm_conv.conv3x3_act(x, k, alpha, act)],
                   [samm_conv.conv3x3_act_reference(x.float(), k.float(), alpha, act)]),
            "B2b": ([y2, part[:, 0], part[:, 1]], [y2_ref, part_ref[:, 0], part_ref[:, 1]])}


@pytest.mark.cuda
def test_samm_kernels_float32_accuracy_on_card(cuda):
    """B5, B2b and B2a at the 64px 1024 -> 1024 shape on inputs where one
    TF32 pass misses 1e-4 of max|ref| by >10x (tests/test_torch_tf32_split.py):
    x = 1 + 0.1 noise, weights summing to 0 over ci. B2a gets x through its
    x1 prologue: s and t are x's two halves and the coefficients
    [1, 0, 0, 1, 0] give x1 = x. The 3xTF32 products meet the float32
    tolerance."""
    x, k = (torch.from_numpy(v).to(cuda) for v in tf32_cancel_inputs(1, 1024, 1024, 64, 64))
    for name, (outs, refs) in b5_and_b2b(x, k, None, "none").items():
        for got, ref in zip(outs, refs):
            assert rel_err(got, ref) <= SAMM_TOL[torch.float32], name
    coeffs = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0], device=cuda)[None, :, None].expand(
        1, 5, 512).contiguous()
    conv1 = (x[:, :512].contiguous(), x[:, 512:].contiguous(), coeffs, k,
             torch.full((1024,), 0.25, device=cuda))
    z = alignnet.alignnet_conv1(*conv1)
    assert rel_err(z, alignnet.alignnet_conv1_reference(*conv1)) <= SAMM_TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_samm_kernels_at_32px_slot_bitwise(cuda, dtype):
    """The 32px 1024 -> 1024 launch (the grid of small tiles) at b = 1 and
    b = 3: each slot of the batch of 3 is bit-identical to that sample
    alone, for B5 and B2b (moments included), and within tolerance of the
    plain version."""
    x, k, alpha = (torch.from_numpy(v).to(cuda)
                   for v in conv_act_inputs(3, 1024, 1024, 32, 32, seed=32))
    x, k = x.to(dtype), k.to(dtype)
    batch = b5_and_b2b(x, k, alpha, "prelu")
    for s in range(3):
        alone = b5_and_b2b(x[s:s + 1].contiguous(), k, alpha, "prelu")
        for name in batch:
            for got, one in zip(batch[name][0], alone[name][0]):
                assert torch.equal(got[s:s + 1], one), (name, s)
    tol = {"B5": SAMM_TOL[dtype], "B2b": SAMM_TOL[torch.float32]}
    for name, (outs, refs) in batch.items():
        for got, ref in zip(outs, refs):
            assert rel_err(got, ref) <= tol[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,ci,co,h,w", [
    (2, 37, 100, 19, 27),      # small tiles; odd Ci: 4-byte / plain weight loads
    (1, 37, 136, 100, 90),     # big tiles, ragged rows, columns and channel block
    (2, 36, 36, 19, 27),       # B2b's Ci = Co; 16-byte (fp32) / 8-byte (bf16) copies
    (1, 140, 140, 100, 90)])
def test_samm_kernels_ragged_on_card(cuda, b, ci, co, h, w, dtype):
    """Ci not a multiple of 8 and Co not a multiple of the channel block,
    H and W not multiples of the pixel tile: B5 (lrelu) where Ci != Co, B5
    and B2b where Ci = Co, against their plain versions."""
    x, k, alpha = (torch.from_numpy(v).to(cuda) for v in conv_act_inputs(b, ci, co, h, w, seed=ci))
    x, k = x.to(dtype), k.to(dtype)
    if ci != co:
        out = samm_conv.conv3x3_act(x, k, alpha, "lrelu")
        ref = samm_conv.conv3x3_act_reference(x.float(), k.float(), alpha, "lrelu")
        assert out.dtype == dtype and out.shape == (b, co, h, w)
        assert rel_err(out, ref) <= SAMM_TOL[dtype]
        return
    tol = {"B5": SAMM_TOL[dtype], "B2b": SAMM_TOL[torch.float32]}
    for name, (outs, refs) in b5_and_b2b(x, k, alpha, "prelu").items():
        for got, ref in zip(outs, refs):
            assert rel_err(got, ref) <= tol[name], name


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


# ------------------------------------------- backward through the Functions

def grad_case(dev, name, main):
    """(wrapper, plain version, arguments, Function name, counter) of one
    kernel at a main-path shape (main) or a ragged one, float32."""
    if name == "warp_blend":
        x, grid, alpha = (torch.from_numpy(a).to(dev) for a in
                          (warp_inputs(1, 128, 256, 0.08, seed=1) if main else
                           warp_inputs(2, 19, 36, 0.08, seed=2, at_bound=True)))
        return warp_blend, warp_blend_reference, (x, grid, alpha), "WarpBlend", warp_blend
    if name in ("fused_conv3x3_act", "fused_packed_stage"):
        shape = (1, 256, 256, 128, 256) if main else (2, 19, 27, 12, 20)
        a, _ = packed_operands(dev, *shape, torch.float32, seed=3)
        if name == "fused_conv3x3_act":
            args = tuple(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1"))
            return (packed_conv.fused_conv3x3_act, packed_conv.packed_conv3x3_act_reference,
                    args, "PackedConv3x3Act", packed_conv.fused_conv3x3_act)
        return (packed_conv.fused_packed_stage, packed_conv.packed_stage_reference,
                tuple(a.values()), "PackedStage", packed_conv.fused_packed_stage)
    if name in ("alignnet_conv1", "alignnet_conv2"):
        a, _ = samm_operands(dev, *((1, 512, 32, 32) if main else (2, 37, 19, 27)),
                             torch.float32, seed=4)
        if name == "alignnet_conv1":
            return (alignnet.alignnet_conv1, alignnet.alignnet_conv1_reference, conv1_ops(a),
                    "AlignNetConv1", alignnet.alignnet_conv1)
        z = alignnet.alignnet_conv1_reference(*conv1_ops(a))
        return (alignnet.alignnet_conv2, alignnet.alignnet_conv2_reference, (z, a["k2"]),
                "AlignNetConv2", alignnet.alignnet_conv2)
    if name == "conv3x3_act":
        b, ci, co, h, w, act = (1, 1024, 1024, 32, 32, "prelu") if main else \
            (2, 40, 136, 19, 27, "lrelu")
        x, k, alpha = (torch.from_numpy(v).to(dev) for v in conv_act_inputs(b, ci, co, h, w, 5))
        alpha = alpha if act == "prelu" else None
        return (samm_conv.conv3x3_act, samm_conv.conv3x3_act_reference, (x, k, alpha, act),
                "Conv3x3Act", samm_conv.conv3x3_act)
    h, w = (32, 32) if main else (37, 45)
    x = torch.from_numpy(conv_act_inputs(1, 1, 1, h, w, seed=6)[0][0, 0]).to(dev)
    return halo_probe.box3x3, halo_probe.box3x3_reference, (x,), "Box3x3", halo_probe.box3x3


def twin_grads(fn, args, cotangents):
    """(outputs, gradients of sum(out * cotangent) for every tensor
    argument) of fn on fresh leaves of args; a None cotangent drops its
    output from the loss."""
    leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) else a
              for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    used = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
    wrt = [v for v in leaves if isinstance(v, torch.Tensor)]
    grads = torch.autograd.grad([o for o, _ in used], wrt, [c for _, c in used],
                                allow_unused=True)
    return outs, grads


KERNELS = ["warp_blend", "fused_conv3x3_act", "fused_packed_stage", "alignnet_conv1",
           "alignnet_conv2", "conv3x3_act", "box3x3"]


@pytest.mark.cuda
@pytest.mark.parametrize("main", [True, False], ids=["main", "ragged"])
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_gradients_on_card(cuda, name, main):
    """With grad on, each wrapper's CUDA output comes from its Function
    (grad_fn), launches the kernel once, equals the kernel's output without
    grad bit for bit, and its gradients equal the plain version's own
    autograd gradients on the same inputs within 1e-5 of max|ref| (the same
    computation; cuDNN's and the gathers' backward sum in run-dependent
    order). For two outputs (B2b, B4) the second output's cotangent is
    None: the loss reads the first only."""
    fn, twin, args, fname, counter = grad_case(cuda, name, main)
    with torch.no_grad():
        direct = fn(*args)
    direct = direct if isinstance(direct, tuple) else (direct,)
    g = torch.Generator(device=cuda).manual_seed(7)
    cotangents = [torch.randn(o.shape, generator=g, device=cuda).to(o.dtype) for o in direct]
    if len(cotangents) == 2:
        cotangents[1] = None
    before = counter.launches
    outs, grads = twin_grads(fn, args, cotangents)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert type(outs[0].grad_fn).__name__ == fname + "Backward"
    for got, ref in zip(outs, direct):
        assert torch.equal(got, ref)
    _, ref_grads = twin_grads(twin, args, cotangents)
    for i, (got, ref) in enumerate(zip(grads, ref_grads)):
        assert (got is None) == (ref is None), i
        if ref is not None:
            assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), i


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_kernel_grad_of_grad_on_card(cuda, name):
    """Under create_graph each wrapper's gradients differentiate again: at
    the ragged shape, sum(grad * v) differentiated once more through the
    Function equals the same through the plain version within 1e-5 of
    max|ref|."""
    fn, twin, args, _, _ = grad_case(cuda, name, False)
    g = torch.Generator(device=cuda).manual_seed(8)

    def second_order(f):
        leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) else a
                  for a in args]
        wrt = [v for v in leaves if isinstance(v, torch.Tensor)]
        outs = f(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g.manual_seed(8)
        cts = [torch.randn(o.shape, generator=g, device=cuda) for o in outs]
        grads = torch.autograd.grad(outs, wrt, cts, create_graph=True)
        loss = sum((d * torch.randn(d.shape, generator=g, device=cuda)).sum() for d in grads)
        if not loss.requires_grad:          # a linear function: no second order
            return [None] * len(wrt)
        return torch.autograd.grad(loss, wrt, allow_unused=True)

    got, ref = second_order(fn), second_order(twin)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert (a is None) == (r is None), i
        if r is not None:
            assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max()), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_forward_has_no_batch_dependent_op_on_card(cuda, dtype):
    """Every op of a batched per-seed forward on the card gives each sample
    the bits of that sample computed alone (tests/torch_slots.py): cuDNN,
    cuBLAS and PyTorch's reductions pick their summation order by shape,
    batch size included, so the engine runs those ops sample by sample."""
    from torch_slots import batch_dependent_ops

    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    opt = {"network_g": {"type": "ood_faceGAN_e4e", "out_size": 256, "channel_multiplier": 1,
                         "narrow": 0.25, "encoder_num_layers": 4, "cycle_align": 2,
                         "warp_scale": 0.08, "ModSize": 128, "dtype": dtype}}
    assert batch_dependent_ops(InversionEngine(opt, device="cuda")) == {}
