"""The port's hand-written CUDA kernels (warp-blend in its three
instantiations, the packed conv B3, the packed stage B4, also on bands
(B4 and B3 in both dtypes through the TMA kernel, their repack and
conv1's z operand), the
AlignNet body0 kernels B2a and B2b, the conv3x3 + activation B5 (all three
in both dtypes through the TMA kernel and its repack pass, B2a's in its x1
mode) and the halo probe) against their plain PyTorch versions on
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
    taps fall outside the image: float32 within 1e-5 of max|target| of the
    plain version, bfloat16 bit for bit the plain version on the same
    bfloat16 target (it samples in bfloat16 arithmetic, as that does)."""
    x, grid, alpha = (torch.from_numpy(a).to(cuda) for a in
                      warp_inputs(3, 19, c, 0.08, seed=c, at_bound=True))
    x, grid, alpha = x[:, :, :17].contiguous(), grid[:, :, :17].contiguous(), \
        alpha[:, :, :17].contiguous()
    xt = x.to(dtype)
    out = warp_blend(xt, grid, alpha)
    ref = warp_blend_reference(xt, grid, alpha)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (3, 19, 17, c)
    if dtype == torch.bfloat16:
        assert torch.equal(out, ref)
    else:
        assert float((out - ref).abs().max()) <= 1e-5 * float(x.abs().max())


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
@pytest.mark.parametrize("size,c", [(256, 128), (128, 256), (64, 512), (32, 512), (19, 36)])
def test_warp_blend_kernel_bf16_target(cuda, size, c):
    """A bfloat16 target (B1's dtype code 1) at the four SAMM scales and a
    ragged shape (19 x 17, C = 36, one-element path, flow at the bound): bit
    for bit its plain version, warp_blend_reference on the same bfloat16
    target, which samples in bfloat16 arithmetic as JAX's XLA grid sample
    does on a bfloat16 x."""
    x, grid, alpha = (torch.from_numpy(a).to(cuda) for a in
                      warp_inputs(2, size, c, 0.08, seed=size + c, at_bound=size == 19))
    if size == 19:
        x, grid, alpha = (t[:, :, :17].contiguous() for t in (x, grid, alpha))
    xb = x.to(torch.bfloat16)
    before = warp_blend.launches
    out = warp_blend(xb, grid, alpha)
    ref = warp_blend_reference(xb, grid, alpha)
    torch.cuda.synchronize()
    assert warp_blend.launches == before + 1
    assert out.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("size,c", [(256, 128), (128, 256), (64, 512), (32, 512), (19, 36)])
def test_warp_blend_taps_bf16_kernel_on_card(cuda, size, c):
    """B1's instantiation for samm_gather_bf16 (a float32 target sampled in
    JAX's gather4bf16 arithmetic, everything of the bilinear sample rounded
    to bfloat16) at the four SAMM scales and a ragged shape (19 x 17,
    C = 36, one-element path, flow at the bound): within 1e-6 of
    max|target| of its plain version (it computes the same roundings in
    the same order, so bit for bit is expected), which lies further than
    that from a sample that rounds only the taps and from the float32
    warp-blend."""
    from ood_gan_inversion_tpu_torch.ops.grid_sample import grid_sample_bilinear
    from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend_taps_bf16
    x, grid, alpha = (torch.from_numpy(a).to(cuda) for a in
                      warp_inputs(2, size, c, 0.08, seed=size + c, at_bound=size == 19))
    if size == 19:
        x, grid, alpha = (t[:, :, :17].contiguous() for t in (x, grid, alpha))
    before = (warp_blend.launches, warp_blend_taps_bf16.launches)
    out = warp_blend_taps_bf16(x, grid, alpha)
    torch.cuda.synchronize()
    assert (warp_blend.launches, warp_blend_taps_bf16.launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.float32
    plain = warp_blend_reference(x, grid, alpha, taps_bf16=True)
    taps_only = grid_sample_bilinear(x.bfloat16().float(), grid) * alpha + x * (1.0 - alpha)
    tol = 1e-6 * float(x.abs().max())
    assert float((out - plain).abs().max()) <= tol
    assert float((plain - taps_only).abs().max()) > tol
    assert float((plain - warp_blend_reference(x, grid, alpha)).abs().max()) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tail_kernel", ["pair", "stage"])
def test_banded_packed_tail_on_card(cuda, tail_kernel, dtype):
    """A 1024px generator (a quarter of the widths) with the packed tail,
    banded at min_h 512 over 2 and 4 slots of the card, against its
    unbanded decode: each band launches B3 twice ("pair") or B4 once
    ("stage") per packed stage, on its window of coarse rows; within 1e-5
    (float32) or 2^-7 (bfloat16) of max|ref|."""
    from ood_gan_inversion_tpu_torch.nn.layers import init_weights
    from ood_gan_inversion_tpu_torch.nn.stylegan2 import Generator, NoiseInjection
    from ood_gan_inversion_tpu_torch.parallel import Replicas, make_mesh, spatial
    with torch.device(cuda):
        gen = init_weights(Generator(1024, 512, 2, 0.25, n_mlp=2, packed_tail=True,
                                     tail_kernel=tail_kernel), 0).eval()
    for m in gen.modules():
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.1)
    g = torch.Generator(device=cuda).manual_seed(1)
    lat = (torch.randn(1, gen.n_latent, 512, generator=g, device=cuda) * 0.3).to(dtype)
    noise = gen.make_noise(1, g, cuda)
    counter = packed_conv.fused_conv3x3_act if tail_kernel == "pair" else \
        packed_conv.fused_packed_stage
    per_band = 2 if tail_kernel == "pair" else 1
    with torch.no_grad():
        before = counter.launches
        ref = gen(lat, noise)
        assert counter.launches - before == 2 * per_band
        for n in (2, 4):
            before = counter.launches
            with spatial.banding(make_mesh([cuda] * n, axes=("sp",)), Replicas(gen, cuda), 512):
                out = gen(lat, noise)
            torch.cuda.synchronize()
            assert counter.launches - before == 2 * per_band * n
            tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            assert rel_err(out, ref.float()) <= tol, n


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
    """float32 fused_packed_pair: two B3 calls, each one TMA conv launch."""
    a, ref_args = packed_operands(cuda, 2, 32, 32, 16, 32, torch.float32)
    before = packed_conv.fused_conv3x3_act.launches
    tma_before = tma_launches("packed_stage")
    out = packed_conv.fused_packed_pair(*(a[k] for k in PAIR_KEYS))
    ref = packed_conv.packed_pair_reference(*(ref_args[k] for k in PAIR_KEYS))
    torch.cuda.synchronize()
    assert packed_conv.fused_conv3x3_act.launches == before + 2
    assert tma_launches("packed_stage") == tma_before + 2
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


def stage_step(a, ptrs, step):
    """One step of B4 (ogi_packed_stage_step) on a's operands, in x's dtype."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import DTYPES, entry
    b, h, w, c1 = a["x"].shape
    err = entry("packed_stage", "ogi_packed_stage_step", 22, 7)(
        *ptrs, b, h, w, c1, a["k1"].shape[-1], DTYPES[a["x"].dtype], step,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, (step, err)


def per_slot(a, b, s):
    """Slot s of a's per-sample operands (the kernels k1, k2, k4 whole)."""
    return {k: (v[s:s + 1].contiguous() if v.dim() > 1 and v.shape[0] == b and k not in
                ("k1", "k2", "k4") else v) for k, v in a.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, PACKED_TOL),
                                       (torch.bfloat16, PACKED_TOL_BF16)])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("h,w,ci,co", [(256, 256, 128, 256),   # 512px stage conv1
                                       (256, 256, 256, 256),   # 512px stage conv2
                                       (512, 512, 64, 128),    # 1024px stage conv1
                                       (512, 512, 128, 128),   # 1024px stage conv2
                                       (37, 45, 12, 20),       # ragged: Ci, Co / 4 off 16
                                       (130, 70, 64, 128)])    # band-like: H % 4 != 0
def test_packed_conv_tma_slot_bitwise_both_dtypes(cuda, b, h, w, ci, co, dtype, tol):
    """B3 on the TMA kernel in float32 and bfloat16: one call launches it
    once (ogi_tma_conv_launches + 1), within PACKED_TOL (float32) or
    PACKED_TOL_BF16 (bfloat16) of max|ref| of its kernel's plain version on
    the same operands, each slot bit-identical to that sample alone."""
    names = ("x", "n1", "k1", "s1", "d1", "b1")
    a, _ = packed_operands(cuda, b, h, w, ci, co, dtype, seed=ci + h + b)
    before = tma_launches("packed_stage")
    out = packed_conv.fused_conv3x3_act(*(a[k] for k in names))
    torch.cuda.synchronize()
    assert tma_launches("packed_stage") == before + 1
    ref = packed_conv.packed_conv3x3_act_kernel_reference(*(a[k] for k in names))
    assert out.dtype == ref.dtype == dtype
    assert out.shape == ref.shape and rel_err(out, ref.float()) <= tol
    for s in range(b):
        one = per_slot(a, b, s)
        alone = packed_conv.fused_conv3x3_act(*(one[k] for k in names))
        torch.cuda.synchronize()
        assert torch.equal(out[s:s + 1], alone), s


def conv_step(args, xr, wr, out, step):
    """One step of B3 (ogi_packed_conv3x3_act_step) on the operands args,
    in x's dtype: 0 the repack into xr, wr; 1 the conv into out."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import DTYPES, entry
    x, n4, k, s, d, bias = args
    b, h, w, ci = x.shape
    co = k.shape[-1]
    ptrs = [t.data_ptr() for t in (x, n4, k, s, d, bias, out, xr, wr)]
    err = entry("packed_stage", "ogi_packed_conv3x3_act_step", 9, 7)(
        *ptrs, b, h, w, ci, co, DTYPES[x.dtype], step, torch.cuda.current_stream().cuda_stream)
    assert err == 0, (step, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ci,co", [(1, 64, 64, 128, 256), (2, 19, 27, 12, 20),
                                         (1, 33, 40, 37, 44)])
def test_packed_conv_bf16_operands_on_card(cuda, b, h, w, ci, co):
    """bfloat16 B3's operands on the card: its repack launch (B4's, with no
    k2) writes stage_input_words(x, s_in) (x * s_in rounded as JAX rounds
    it) and stage_weight_words(k) bit for bit, pad channels zero bits, into
    scratch that held other bits; the conv on them is the call's output bit
    for bit."""
    a, _ = packed_operands(cuda, b, h, w, ci, co, torch.bfloat16, seed=ci + co)
    x = a["x"]
    s, d, bias = (v.expand(b, -1).contiguous() for v in (a["s1"], a["d1"], a["b1"]))
    args = (x, a["n1"], a["k1"], s, d, bias)
    xr, wr = packed_conv.conv_scratch(x, co)
    xr.fill_(1.0)
    wr.fill_(1.0)
    out = x.new_empty((b, h, w, co))
    conv_step(args, xr, wr, out, 0)
    torch.cuda.synchronize()
    i16 = lambda v: v.view(torch.int16)
    assert torch.equal(i16(xr), i16(packed_conv.stage_input_words(x, a["s1"])))
    assert torch.equal(i16(wr), i16(packed_conv.stage_weight_words(a["k1"])))
    conv_step(args, xr, wr, out, 1)
    call = packed_conv.fused_conv3x3_act(*(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1")))
    torch.cuda.synchronize()
    assert torch.equal(out, call)


@pytest.mark.cuda
def test_packed_pair_bf16_repacks_z_times_s2(cuda):
    """bfloat16 fused_packed_pair: two B3 calls, each one TMA conv launch;
    the second call's repack scales conv1's bfloat16 output by s2 as JAX's
    `_scaled` does (s2 rounded first, the product rounded), so the pair is
    two calls of B3's kernel's plain version within PACKED_TOL_BF16 of
    max|ref|, and the second call alone on conv1's output gives the pair's
    bits."""
    a, _ = packed_operands(cuda, 2, 64, 64, 64, 128, torch.bfloat16, seed=13)
    before = tma_launches("packed_stage")
    out = packed_conv.fused_packed_pair(*(a[k] for k in PAIR_KEYS))
    torch.cuda.synchronize()
    assert tma_launches("packed_stage") == before + 2
    conv1 = tuple(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1"))
    conv2 = ("n2", "k2", "s2", "d2", "b2")
    z = packed_conv.fused_conv3x3_act(*conv1)
    assert torch.equal(out, packed_conv.fused_conv3x3_act(z, *(a[k] for k in conv2)))
    z_ref = packed_conv.packed_conv3x3_act_kernel_reference(*conv1)
    ref = packed_conv.packed_conv3x3_act_kernel_reference(z_ref, *(a[k] for k in conv2))
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == torch.bfloat16
    assert rel_err(out, ref.float()) <= PACKED_TOL_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c1,c4", [(1, 64, 64, 128, 256), (2, 64, 64, 64, 128),
                                         (2, 37, 45, 20, 24)])
def test_packed_pair_f32_on_cancelling_inputs(cuda, b, h, w, c1, c4):
    """float32 fused_packed_pair on `packed_cancel_inputs` (both convs
    cancel a large common offset; hi*hi alone misses by >10x,
    tests/test_torch_tma_packed.py): two TMA launches, within PACKED_TOL of
    max|ref| of packed_pair_reference, each slot bit-identical alone."""
    a, _ = packed_operands(cuda, b, h, w, c1, c4, torch.float32, seed=c1,
                           inputs=packed_cancel_inputs)
    before = tma_launches("packed_stage")
    out = packed_conv.fused_packed_pair(*(a[k] for k in PAIR_KEYS))
    torch.cuda.synchronize()
    assert tma_launches("packed_stage") == before + 2
    assert rel_err(out, packed_conv.packed_pair_reference(*(a[k] for k in PAIR_KEYS))) <= PACKED_TOL
    for s in range(b):
        one = per_slot(a, b, s)
        alone = packed_conv.fused_packed_pair(*(one[k] for k in PAIR_KEYS))
        torch.cuda.synchronize()
        assert torch.equal(out[s:s + 1], alone), s


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c1,c4", [(2, 256, 256, 128, 256),   # 512px stage
                                         (2, 512, 512, 64, 128),    # 1024px stage
                                         (2, 37, 45, 12, 20),       # ragged: C4 % 8 == 4
                                         (2, 19, 27, 37, 44),
                                         (2, 130, 70, 64, 128)])    # band-like: H % 4 != 0
def test_packed_stage_bf16_tma_slot_bitwise(cuda, b, h, w, c1, c4):
    """bfloat16 B4 on the TMA kernel: one call launches its two convs there
    (ogi_tma_conv_launches + 2); z2 and rgb within PACKED_TOL_BF16 of
    max|ref| of its kernels' plain version on the same operands; each slot
    bit-identical to that sample alone (b = 1)."""
    a, _ = packed_operands(cuda, b, h, w, c1, c4, torch.bfloat16, seed=c1 + h)
    before = tma_launches("packed_stage")
    rgb, z2 = packed_conv.fused_packed_stage(*a.values())
    torch.cuda.synchronize()
    assert tma_launches("packed_stage") == before + 2
    rgb_ref, z2_ref = packed_conv.packed_stage_kernel_reference(*a.values())
    assert rgb.dtype == z2.dtype == torch.bfloat16
    assert rel_err(z2, z2_ref.float()) <= PACKED_TOL_BF16
    assert rel_err(rgb, rgb_ref.float()) <= PACKED_TOL_BF16
    for s in range(b):
        rgb1, z21 = packed_conv.fused_packed_stage(*per_slot(a, b, s).values())
        torch.cuda.synchronize()
        assert torch.equal(rgb[s:s + 1], rgb1) and torch.equal(z2[s:s + 1], z21), s


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c1,c4", [(1, 64, 64, 128, 256), (2, 19, 27, 12, 20),
                                         (1, 33, 40, 37, 44)])
def test_packed_stage_bf16_operands_on_card(cuda, b, h, w, c1, c4):
    """bfloat16 B4's operands on the card: the repack launch writes
    stage_input_words(x, s1) (x * s1 rounded as JAX rounds it) and
    stage_weight_words(k1), (k2) bit for bit; conv1 writes z as conv2's
    operand, its pad channels zero bits, its channels within
    PACKED_TOL_BF16 of max|ref| of the plain version's z; then conv2 and
    the rgb pass give the call's z2 and rgb."""
    a, _ = packed_operands(cuda, b, h, w, c1, c4, torch.bfloat16, seed=c4)
    ptrs, rgb, z2, scratch = packed_conv.stage_pointers(*a.values())
    stage_step(a, ptrs, 0)
    torch.cuda.synchronize()
    i16 = lambda v: v.view(torch.int16)
    assert torch.equal(i16(scratch["xr"]), i16(packed_conv.stage_input_words(a["x"], a["s1"])))
    for key, k in (("w1r", "k1"), ("w2r", "k2")):
        assert torch.equal(i16(scratch[key]), i16(packed_conv.stage_weight_words(a[k]))), key
    stage_step(a, ptrs, 1)
    torch.cuda.synchronize()
    z = scratch["z"]
    assert z.shape[-1] % 8 == 0 and not i16(z[..., c4:]).any()
    z_ref = packed_conv._kernel_stage_z(*(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1", "s2")))
    assert rel_err(z[..., :c4], z_ref.float()) <= PACKED_TOL_BF16
    for step in (2, 3):
        stage_step(a, ptrs, step)
    rgb_call, z2_call = packed_conv.fused_packed_stage(*a.values())
    torch.cuda.synchronize()
    assert torch.equal(rgb, rgb_call) and torch.equal(z2, z2_call)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c1,c4", [(2, 256, 256, 128, 256),   # 512px stage
                                         (2, 512, 512, 64, 128),    # 1024px stage
                                         (2, 37, 45, 12, 20),       # ragged: C1, Cmid off 16
                                         (2, 130, 70, 64, 128)])    # band-like: H % 4 != 0
def test_packed_stage_f32_tma_slot_bitwise(cuda, b, h, w, c1, c4):
    """float32 B4 on the TMA kernel: one call launches its two convs there
    (ogi_tma_conv_launches + 2); z2 and rgb within PACKED_TOL of max|ref| of
    the plain version; each slot bit-identical to that sample alone."""
    a, ref_args = packed_operands(cuda, b, h, w, c1, c4, torch.float32, seed=c1 + h)
    before = tma_launches("packed_stage")
    check_packed_stage(a, ref_args, PACKED_TOL)
    assert tma_launches("packed_stage") == before + 2
    rgb, z2 = packed_conv.fused_packed_stage(*a.values())
    for s in range(b):
        rgb1, z21 = packed_conv.fused_packed_stage(*per_slot(a, b, s).values())
        torch.cuda.synchronize()
        assert torch.equal(rgb[s:s + 1], rgb1) and torch.equal(z2[s:s + 1], z21), s


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c1,c4", [(1, 64, 64, 128, 256), (2, 19, 27, 12, 20),
                                         (1, 33, 40, 37, 44)])
def test_packed_stage_f32_words_on_card(cuda, b, h, w, c1, c4):
    """float32 B4's words on the card: the repack launch writes
    stage_input_words(x, s1) and stage_weight_words(k1), (k2) bit for bit;
    conv1 writes z as words that split their own value hi + lo as
    tf32_words does (bit for bit, padded channels zero), within PACKED_TOL
    of max|ref| of the plain version's z; then conv2 and the rgb pass give
    the call's z2 and rgb."""
    from ood_gan_inversion_tpu_torch.ops import samm_conv
    a, _ = packed_operands(cuda, b, h, w, c1, c4, torch.float32, seed=c4)
    ptrs, rgb, z2, scratch = packed_conv.stage_pointers(*a.values())
    stage_step(a, ptrs, 0)
    torch.cuda.synchronize()
    i32 = lambda v: v.view(torch.int32)
    assert torch.equal(i32(scratch["xr"]), i32(packed_conv.stage_input_words(a["x"], a["s1"])))
    for key, k in (("w1r", "k1"), ("w2r", "k2")):
        assert torch.equal(i32(scratch[key]), i32(packed_conv.stage_weight_words(a[k]))), key
    stage_step(a, ptrs, 1)
    torch.cuda.synchronize()
    words = scratch["z"]
    g = words.reshape(*words.shape[:-1], -1, 2, 16)
    hi, lo = g[..., 0, :].flatten(-2), g[..., 1, :].flatten(-2)
    z = (hi + lo)[..., :c4]
    assert torch.equal(i32(words), i32(samm_conv.tf32_words(z, words.shape[-1] // 2)))
    z_ref = packed_conv._kernel_stage_z(*(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1", "s2")))
    assert rel_err(z, z_ref) <= PACKED_TOL
    for step in (2, 3):
        stage_step(a, ptrs, step)
    rgb_call, z2_call = packed_conv.fused_packed_stage(*a.values())
    torch.cuda.synchronize()
    assert torch.equal(rgb, rgb_call) and torch.equal(z2, z2_call)


# ------------------------------------------------ AlignNet body0 kernels

# (b, C, H, W): AlignNet body0 at the four SAMM scales of the 1024px model
# (2C = 1024, 1024, 512, 256), and ragged cases: H, W off the pixel tile, and
# C not a multiple of 8 (nor 16), so that one of B2a's chunks of input
# channels straddles the s/t halves of x1
SAMM_CASES = [(1, 512, 32, 32), (1, 512, 64, 64), (1, 256, 128, 128),
              (1, 128, 256, 256), (2, 48, 19, 27), (2, 37, 19, 27), (1, 12, 100, 90)]
# float32: sums over up to K = 9 * 1024 terms in another order than cuDNN's
# -> 1e-4 of max|ref|; bfloat16 operands against the kernel's plain version
# on the same operands (`*_kernel_reference`: float32 sums, one rounding)
# -> 2^-7 of max|ref| (a value whose sum lies near a rounding boundary may
# round the other way: one bfloat16 step, at most 2^-7 of max|ref|)
SAMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def bf16_step(ref):
    """One bfloat16 step at max|ref|: the spacing of bfloat16 values there,
    2^(floor(log2 max|ref|) - 7), between 2^-8 and 2^-7 of max|ref|."""
    return 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)


def samm_operands(dev, b, c, h, w, dtype, seed=0):
    """(kernel operands, float32 operands): s, t and the conv kernels
    rounded to `dtype`; the coefficients of (s, t) float32; the PReLU slopes
    float32, rounded to `dtype` first, as alignnet_conv1 reads them."""
    a = {k: torch.from_numpy(v).to(dev)
         for k, v in samm_body0_inputs(b, c, h, w, seed).items()}
    a["coeffs"] = alignnet._alignnet_coeffs(a["s"], a["t"], a["g1"], a["b1"], True, 1e-5)[0]
    for k in ("s", "t", "k1", "k2"):
        a[k] = a[k].to(dtype)
    a["alpha"] = a["alpha"].to(dtype).float()
    return a, {k: v.float() for k, v in a.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w", SAMM_CASES)
def test_alignnet_conv_kernels_on_card(cuda, b, c, h, w, dtype):
    """B2a against its plain version; B2b on B2a's output against its plain
    version (y2 and both moments), twice, bit-identical. The plain versions
    are the kernels' (`*_kernel_reference`) on the same operands."""
    a, _ = samm_operands(cuda, b, c, h, w, dtype, seed=c + h)
    before = (alignnet.alignnet_conv1.launches, alignnet.alignnet_conv2.launches)
    z = alignnet.alignnet_conv1(a["s"], a["t"], a["coeffs"], a["k1"], a["alpha"])
    z_ref = alignnet.alignnet_conv1_kernel_reference(*conv1_ops(a))
    y2, part = alignnet.alignnet_conv2(z, a["k2"])
    y2_ref, part_ref = alignnet.alignnet_conv2_kernel_reference(z, a["k2"])
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
    a, _ = samm_operands(cuda, 3, 512, 32, 32, dtype, seed=3)
    z = alignnet.alignnet_conv1(*conv1_ops(a))
    for s in range(3):
        one = {k: (v[s:s + 1].contiguous() if k in ("s", "t", "coeffs") else v)
               for k, v in a.items()}
        assert torch.equal(z[s:s + 1], alignnet.alignnet_conv1(*conv1_ops(one))), s
    assert rel_err(z, alignnet.alignnet_conv1_kernel_reference(*conv1_ops(a))) <= SAMM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,ci,co,h,w,act", [
    (1, 1024, 1024, 32, 32, "prelu"), (1, 1024, 1024, 64, 64, "none"),
    (1, 512, 512, 128, 128, "prelu"), (1, 256, 256, 256, 256, "none"),
    (2, 40, 136, 19, 27, "lrelu")])
def test_conv3x3_act_kernel_on_card(cuda, b, ci, co, h, w, act, dtype):
    """B5 against its kernel's plain version on the same operands."""
    x, k, alpha = (torch.from_numpy(v).to(cuda)
                   for v in conv_act_inputs(b, ci, co, h, w, seed=ci + h))
    x, k = x.to(dtype), k.to(dtype)
    before = samm_conv.conv3x3_act.launches
    out = samm_conv.conv3x3_act(x, k, alpha, act)
    ref = samm_conv.conv3x3_act_kernel_reference(x, k, alpha, act)
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
    """{kernel: (its output, its kernel's plain version's)} for B5 and B2b
    on the same operands: B5's output, and B2b's y2 with its two moments."""
    y2, part = alignnet.alignnet_conv2(x, k)
    y2_ref, part_ref = alignnet.alignnet_conv2_kernel_reference(x, k)
    return {"B5": ([samm_conv.conv3x3_act(x, k, alpha, act)],
                   [samm_conv.conv3x3_act_kernel_reference(x, k, alpha, act)]),
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
        ref = samm_conv.conv3x3_act_kernel_reference(x, k, alpha, "lrelu")
        assert out.dtype == dtype and out.shape == (b, co, h, w)
        assert rel_err(out, ref) <= SAMM_TOL[dtype]
        return
    tol = {"B5": SAMM_TOL[dtype], "B2b": SAMM_TOL[torch.float32]}
    for name, (outs, refs) in b5_and_b2b(x, k, alpha, "prelu").items():
        for got, ref in zip(outs, refs):
            assert rel_err(got, ref) <= tol[name], name


# the SAMM scales' body0 convs: (H = W, 2C)
SAMM_SCALES = [(32, 1024), (64, 1024), (128, 512), (256, 256)]


def tma_launches(lib):
    """ogi_tma_conv_launches of csrc/<lib>.cu: its TMA conv launches."""
    import ctypes
    from ood_gan_inversion_tpu_torch import build
    fn = build.load(lib).ogi_tma_conv_launches
    fn.restype = ctypes.c_longlong
    return fn()


@pytest.mark.cuda
@pytest.mark.parametrize("h,c2", SAMM_SCALES)
def test_samm_kernels_bf16_slot_bitwise_at_every_scale(cuda, h, c2):
    """bfloat16 B5 (PReLU) and B2b (y2 and both moments) at each SAMM
    scale, b = 3: each slot is bit-identical to that sample alone, and the
    batch is within tolerance of the plain version on the same rounded
    operands (B5 2^-7, B2b 1e-4 of max|ref|, each moment row against its
    own max)."""
    x, k, alpha = (torch.from_numpy(v).to(cuda)
                   for v in conv_act_inputs(3, c2, c2, h, h, seed=h + c2))
    x, k = x.bfloat16(), k.bfloat16()
    batch = b5_and_b2b(x, k, alpha, "prelu")
    for s in range(3):
        alone = b5_and_b2b(x[s:s + 1].contiguous(), k, alpha, "prelu")
        for name in batch:
            for got, one in zip(batch[name][0], alone[name][0]):
                assert torch.equal(got[s:s + 1], one), (name, s)
    tol = {"B5": SAMM_TOL[torch.bfloat16], "B2b": SAMM_TOL[torch.float32]}
    for name, (outs, refs) in batch.items():
        for got, ref in zip(outs, refs):
            assert rel_err(got, ref) <= tol[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,co,h,w", [(2, 37, 136, 19, 27), (1, 1024, 1024, 32, 32),
                                        (2, 36, 36, 19, 27), (1, 40, 100, 16, 16)])
def test_tma_repack_on_card(cuda, b, c, co, h, w):
    """The bfloat16 kernels' repack pass (NHWC input, tap-major weights,
    channels padded with zeros to a multiple of 8) is bit for bit its plain
    version, samm_conv.tma_operands: odd C, an odd H * W (the one-element
    path), C a multiple of 8 and a full SAMM weight."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import entry
    x, k, _ = (torch.from_numpy(v).to(cuda) for v in conv_act_inputs(b, c, co, h, w, seed=c))
    x, k = x.bfloat16(), k.bfloat16()
    xr, wr = samm_conv.tma_scratch(x, k)
    xr.fill_(1.0)
    wr.fill_(1.0)
    err = entry("samm_conv", "ogi_tma_repack", 4, 6)(
        x.data_ptr(), k.data_ptr(), xr.data_ptr(), wr.data_ptr(), b, c, h, w, co, xr.shape[3],
        torch.cuda.current_stream().cuda_stream)
    xr_ref, wr_ref = samm_conv.tma_operands(x, k)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(xr, xr_ref) and torch.equal(wr, wr_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,co,h,w", [(2, 37, 136, 19, 27), (1, 1024, 1024, 32, 32),
                                        (2, 36, 36, 19, 27), (1, 40, 100, 16, 16)])
def test_tma_repack_tf32_on_card(cuda, b, c, co, h, w):
    """The float32 form of the repack pass (each value split once into its
    hi and lo words, 16 channels of each per 128-byte row, channels padded
    with zeros to a multiple of 16) is bit for bit its plain version,
    samm_conv.tma_operands on float32: odd C, C a multiple of 16, C = 36
    (padded to 48) and a full SAMM weight."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import entry
    x, k, _ = (torch.from_numpy(v).to(cuda) for v in conv_act_inputs(b, c, co, h, w, seed=c))
    xr, wr = samm_conv.tma_scratch(x, k)
    xr.fill_(1.0)
    wr.fill_(1.0)
    err = entry("samm_conv", "ogi_tma_repack_tf32", 4, 6)(
        x.data_ptr(), k.data_ptr(), xr.data_ptr(), wr.data_ptr(), b, c, h, w, co,
        xr.shape[3] // 2, torch.cuda.current_stream().cuda_stream)
    xr_ref, wr_ref = samm_conv.tma_operands(x, k)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(xr.view(torch.int32), xr_ref.view(torch.int32))
    assert torch.equal(wr.view(torch.int32), wr_ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("h,c2", SAMM_SCALES)
def test_alignnet_conv1_bf16_slot_bitwise_at_every_scale(cuda, h, c2):
    """bfloat16 B2a (the x1 repack, then the TMA kernel in B5's mode) at
    each SAMM scale, b = 3: each slot is bit-identical to that sample
    alone, and the batch is within one bfloat16 step of max|ref| of its
    kernel's plain version on the same operands."""
    a, _ = samm_operands(cuda, 3, c2 // 2, h, h, torch.bfloat16, seed=h + c2)
    z = alignnet.alignnet_conv1(*conv1_ops(a))
    for s in range(3):
        one = {k: (v[s:s + 1].contiguous() if k in ("s", "t", "coeffs") else v)
               for k, v in a.items()}
        assert torch.equal(z[s:s + 1], alignnet.alignnet_conv1(*conv1_ops(one))), s
    ref = alignnet.alignnet_conv1_kernel_reference(*conv1_ops(a))
    assert z.dtype == ref.dtype == torch.bfloat16
    assert float((z.float() - ref.float()).abs().max()) <= bf16_step(ref.float())


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w", [(2, 37, 19, 27), (1, 512, 32, 32), (2, 12, 16, 16),
                                     (1, 20, 7, 9)])
def test_tma_x1_repack_on_card(cuda, b, c, h, w):
    """B2a's repack pass in its x1 mode is bit for bit its plain version,
    alignnet.tma_x1_operands: odd C (2C off the 8-channel granule) with an
    odd H * W (the one-element path), a full SAMM weight, 2C a multiple of
    8, and an odd H * W with 2C on the granule."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import entry
    a, _ = samm_operands(cuda, b, c, h, w, torch.bfloat16, seed=c)
    xr, wr = samm_conv.tma_scratch(a["s"], a["k1"])
    xr.fill_(1.0)
    wr.fill_(1.0)
    err = entry("alignnet_conv1", "ogi_tma_repack_x1", 6, 5)(
        *(a[k].data_ptr() for k in ("s", "t", "coeffs", "k1")), xr.data_ptr(), wr.data_ptr(),
        b, c, h, w, xr.shape[3], torch.cuda.current_stream().cuda_stream)
    xr_ref, wr_ref = alignnet.tma_x1_operands(a["s"], a["t"], a["coeffs"], a["k1"])
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(xr, xr_ref) and torch.equal(wr, wr_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w", [(2, 37, 19, 27), (1, 512, 32, 32), (2, 12, 16, 16),
                                     (1, 20, 7, 9)])
def test_tma_x1_repack_tf32_on_card(cuda, b, c, h, w):
    """B2a's repack pass in its x1 mode, float32 form, is bit for bit its
    plain version, alignnet.tma_x1_operands on float32: x1 in float32 with
    the plain version's roundings (no FMA contraction), then split; odd C
    with an odd H * W, a full SAMM weight, 2C off and on the 16-channel
    granule."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import entry
    a, _ = samm_operands(cuda, b, c, h, w, torch.float32, seed=c)
    xr, wr = samm_conv.tma_scratch(a["s"], a["k1"])
    xr.fill_(1.0)
    wr.fill_(1.0)
    err = entry("alignnet_conv1", "ogi_tma_repack_x1_tf32", 6, 5)(
        *(a[k].data_ptr() for k in ("s", "t", "coeffs", "k1")), xr.data_ptr(), wr.data_ptr(),
        b, c, h, w, xr.shape[3] // 2, torch.cuda.current_stream().cuda_stream)
    xr_ref, wr_ref = alignnet.tma_x1_operands(a["s"], a["t"], a["coeffs"], a["k1"])
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(xr.view(torch.int32), xr_ref.view(torch.int32))
    assert torch.equal(wr.view(torch.int32), wr_ref.view(torch.int32))


@pytest.mark.cuda
def test_bf16_calls_reach_the_tma_kernel_once(cuda):
    """A bfloat16 conv3x3_act, alignnet_conv1 or alignnet_conv2 call
    launches the TMA kernel of its library once and counts one launch on its
    wrapper; so does a float32 call of each (the TMA kernel's float32
    modes)."""
    x, k, alpha = (torch.from_numpy(v).to(cuda) for v in conv_act_inputs(1, 64, 64, 16, 16, 9))
    coeffs = torch.rand(1, 5, 32, device=cuda)

    def conv1(v, w):
        return alignnet.alignnet_conv1(v[:, :32].contiguous(), v[:, 32:].contiguous(), coeffs, w,
                                       alpha)

    for lib, call, counter in (
            ("samm_conv", lambda v, w: samm_conv.conv3x3_act(v, w, alpha, "prelu"),
             samm_conv.conv3x3_act),
            ("alignnet_conv1", conv1, alignnet.alignnet_conv1),
            ("alignnet_conv2", alignnet.alignnet_conv2, alignnet.alignnet_conv2)):
        for dtype, tma in ((torch.bfloat16, 1), (torch.float32, 1)):
            before = (counter.launches, tma_launches(lib))
            call(x.to(dtype), k.to(dtype))
            torch.cuda.synchronize()
            assert (counter.launches, tma_launches(lib)) == (before[0] + 1, before[1] + tma), \
                (lib, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("h,c2", SAMM_SCALES)
def test_alignnet_conv2_f32_slot_bitwise_at_every_scale(cuda, h, c2):
    """float32 B2b (the TMA kernel's AN_CONV2_TF32 mode: one launch of it
    per call) at each SAMM scale, b = 2: y2 and both moments within 1e-4 of
    max|ref| of its plain version (each moment row against its own max),
    and each slot bit-identical to that sample alone."""
    x, k, _ = (torch.from_numpy(v).to(cuda) for v in conv_act_inputs(2, c2, c2, h, h, seed=h))
    before = tma_launches("alignnet_conv2")
    y2, part = alignnet.alignnet_conv2(x, k)
    torch.cuda.synchronize()
    assert tma_launches("alignnet_conv2") == before + 1
    y2_ref, part_ref = alignnet.alignnet_conv2_kernel_reference(x, k)
    assert rel_err(y2, y2_ref) <= SAMM_TOL[torch.float32]
    for m in range(2):
        assert rel_err(part[:, m], part_ref[:, m]) <= SAMM_TOL[torch.float32], m
    for s in range(2):
        y2s, part_s = alignnet.alignnet_conv2(x[s:s + 1].contiguous(), k)
        assert torch.equal(y2[s:s + 1], y2s) and torch.equal(part[s:s + 1], part_s), s


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


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{"modulation_type": "ADD"},
                                  {"mod_btn": "style_bottleneck_IR"}], ids=["add", "mod_btn"])
def test_samm_options_launch_warp_blend_on_card(cuda, opts):
    """A 64px E4E arch with ADD or the SAMM bottleneck forwards on the card
    through B1 (one launch per SAMM block and cycle: 2 x 2), and its
    outputs equal, within 1e-4 of max|ref|, those of the same forward with
    the plain twin in B1's place."""
    from ood_gan_inversion_tpu_torch.archs import build_network
    from ood_gan_inversion_tpu_torch.nn import samm
    from ood_gan_inversion_tpu_torch.nn.layers import init_weights
    with torch.device(cuda):
        arch = build_network({"type": "ood_faceGAN_e4e", "out_size": 64,
                              "channel_multiplier": 1, "narrow": 0.25,
                              "encoder_num_layers": 4, "cycle_align": 2,
                              "warp_scale": 0.08, **opts})
    init_weights(arch, 0).eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(cuda) * 2 - 1
    noise = arch.make_noise(2, torch.Generator(device=cuda).manual_seed(2), cuda)

    def forward():
        with torch.no_grad():
            return arch(x, mod_size=64, noise=noise)

    before = warp_blend.launches
    out = forward()
    torch.cuda.synchronize()
    assert warp_blend.launches == before + 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(samm, "warp_blend", warp_blend_reference)
        ref = forward()
    for k in ("image", "mask"):
        assert float((out[k] - ref[k]).abs().max()) <= 1e-4 * float(ref[k].abs().max()), k


@pytest.mark.cuda
def test_deform_conv2d_on_card(cuda):
    """deform_conv2d at an IR-SE 128-channel 64px shape with offsets of
    scale 0.7, a mask and a bias: the card's result within 1e-5 of max|ref|
    of the CPU's on the same inputs (float32, TF32 off)."""
    from ood_gan_inversion_tpu_torch.ops.deform_conv import deform_conv2d
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 128, 64, 64, generator=g)
    off = torch.randn(2, 18, 64, 64, generator=g) * 0.7
    mask = torch.rand(2, 9, 64, 64, generator=g)
    w = torch.randn(128, 128, 3, 3, generator=g) / 34.0
    b = torch.randn(128, generator=g)
    ref = deform_conv2d(x, off, w, mask, b)
    got = deform_conv2d(*(a.to(cuda) for a in (x, off, w, mask, b)))
    assert float((got.cpu() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_spans_time_a_traced_batched_forward_on_card(cuda):
    """A batched per-seed E4E forward at 256px under a CUDA-only profiler
    records the port's spans (utils/trace.py turns on with any profiler
    session): each with a device time of at least 0, the children of each
    span within its device time (1%, plus the events' resolution), and at
    least 99% of the CUDA runtime calls the profiler records during the
    call inside the call's spans: the spans share the trace's clock."""
    import collections
    import time

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.utils import trace
    opt = {"network_g": {"type": "ood_faceGAN_e4e", "out_size": 256, "channel_multiplier": 1,
                         "narrow": 0.25, "encoder_num_layers": 4, "cycle_align": 2,
                         "warp_scale": 0.08, "ModSize": 128}}
    eng = InversionEngine(opt, device="cuda")
    rs = np.random.RandomState(0)
    imgs = [rs.rand(256, 256, 3).astype(np.float32) for _ in range(4)]
    eng.invert_batch_perkey(imgs, [0, 1, 2, 3])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        eng.invert_batch_perkey(imgs, [4, 5, 6, 7])
        t1 = time.time_ns()
        torch.cuda.synchronize()
    got = [s for s in trace.spans() if s.t0_ns >= t0]
    # 8 spans besides 7 stages (4..256px) and 3 SAMM blocks (32..128px)
    assert len(got) == 18 and all(s.n == 4 for s in got)
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "invert"
    dev = {s.id: s.device_ms for s in got}
    assert min(dev.values()) >= 0.0
    children = collections.defaultdict(float)
    for s in got:
        if s.parent is not None:
            children[s.parent] += dev[s.id]
    for sid, total in children.items():
        assert total <= 1.01 * dev[sid] + 0.01, (sid, total, dev[sid])
    api = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if "CUDA" not in str(e.device_type()) and e.name().startswith("cu")]
    during = [(s, e) for s, e in api if t0 <= s < t1]
    inside = [1 for s, e in during if root.t0_ns <= s and e <= root.t1_ns]
    assert len(during) > 100 and len(inside) >= 0.99 * len(during)


# ------------------------------------------- the engine's default body0 route

# the default float32 engine's replies against an explicit algebraic one's on
# the same weights (chip_smoke.py's BODY0_RTOL): SAMM moves the flows, so a
# float32 difference in body0 moves sample positions
BODY0_RTOL = 1e-3


def small_engine(cuda, dtype="float32", **kwargs):
    """A 256px E4E engine on the card (narrow 0.125: SAMM C 64, 64, 32 at
    32..128px; ModSize 128), seeded weights with every noise strength 0.1
    so that a reply depends on its seed."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.nn.stylegan2 import NoiseInjection
    opt = {"network_g": {"type": "ood_faceGAN_e4e", "out_size": 256, "channel_multiplier": 1,
                         "narrow": 0.125, "encoder_num_layers": 4, "cycle_align": 2,
                         "warp_scale": 0.08, "ModSize": 128, "dtype": dtype}}
    eng = InversionEngine(opt, seed=3, device=cuda, **kwargs)
    for m in eng.net.modules():
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.1)
    return eng


def small_images(n):
    import numpy as np
    rs = np.random.RandomState(4)
    return [rs.rand(256, 256, 3).astype(np.float32) for _ in range(n)]


def body0_counts():
    return (alignnet.alignnet_conv1.launches, alignnet.alignnet_conv2.launches,
            warp_blend.launches)


@pytest.mark.cuda
def test_default_engine_routes_body0_through_b2_on_card(cuda, monkeypatch):
    """A float32 engine on the card without samm_body0 takes the fused
    route: with the channel floor lowered so that every SAMM block (3, at
    cycle_align 2) takes it, one forward launches B2a and B2b once per
    block per align cycle, as often as B1."""
    monkeypatch.setattr(alignnet, "FUSED_MIN_CHANNELS", 16)
    eng = small_engine(cuda)
    imgs = small_images(2)
    assert eng.samm_body0 == "fused"
    eng.invert(imgs[0], seed=0)
    torch.cuda.synchronize()
    before = body0_counts()
    eng.invert_batch_perkey(imgs, [1, 2])
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(body0_counts(), before)) == (6, 6, 6)


@pytest.mark.cuda
def test_default_engine_replies_are_batch_invariant_on_card(cuda, monkeypatch):
    """The fused route keeps the engine's contract: each seed's reply from
    a batched forward at b = 2 and 4, in either order of the batch, is bit
    for bit the lone request's, and no op of a batched forward computes a
    sample differently from that sample alone (tests/torch_slots.py)."""
    from torch_slots import batch_dependent_ops
    monkeypatch.setattr(alignnet, "FUSED_MIN_CHANNELS", 16)
    eng = small_engine(cuda)
    imgs, seeds = small_images(4), [11, 12, 13, 14]
    keys = ("image", "gen_image", "mask", "lats")
    alone = [eng.invert(imgs[i], seed=seeds[i]) for i in range(4)]
    assert not torch.equal(alone[0]["image"], alone[1]["image"])
    for order in ([0, 1], [0, 1, 2, 3], [3, 1, 0, 2]):
        out = eng.invert_batch_perkey([imgs[i] for i in order], [seeds[i] for i in order])
        for slot, i in enumerate(order):
            for k in keys:
                assert torch.equal(out[k][slot], alone[i][k][0]), (order, slot, k)
    assert batch_dependent_ops(eng) == {}


@pytest.mark.cuda
def test_default_engine_matches_the_algebraic_body0_on_card(cuda, monkeypatch):
    """The default float32 engine (B2a and B2b at every SAMM block) against
    an explicit samm_body0="algebraic" engine on the same weights, images
    and seeds: the latents bit for bit (the encoder runs before any SAMM
    block), image, gen_image and mask within BODY0_RTOL of max|ref|."""
    monkeypatch.setattr(alignnet, "FUSED_MIN_CHANNELS", 16)
    eng = small_engine(cuda)
    ref_eng = small_engine(cuda, samm_body0="algebraic")
    ref_eng.net.load_state_dict(eng.net.state_dict())
    imgs, seeds = small_images(2), [5, 6]
    before = body0_counts()
    ref = ref_eng.invert_batch_perkey(imgs, seeds)
    torch.cuda.synchronize()
    assert body0_counts()[:2] == before[:2]
    got = eng.invert_batch_perkey(imgs, seeds)
    assert torch.equal(got["lats"], ref["lats"])
    for k in ("image", "gen_image", "mask"):
        assert rel_err(got[k], ref[k]) <= BODY0_RTOL, k
    assert not torch.equal(got["image"], ref["image"])


@pytest.mark.cuda
def test_default_bf16_engine_launches_no_body0_kernel_on_card(cuda, monkeypatch):
    """A bfloat16 engine on the card without samm_body0 keeps the algebraic
    form (JAX's bfloat16 inference default), whatever the channel floor:
    B1 launches, B2a and B2b do not."""
    monkeypatch.setattr(alignnet, "FUSED_MIN_CHANNELS", 16)
    eng = small_engine(cuda, "bfloat16")
    assert eng.samm_body0 == "algebraic"
    before = body0_counts()
    eng.invert(small_images(1)[0], seed=0)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(body0_counts(), before)) == (0, 0, 6)
