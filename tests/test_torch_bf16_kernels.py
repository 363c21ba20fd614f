"""The bfloat16 kernel wrappers of the port on the CPU, against the JAX
package's Pallas kernels in interpret mode on the same bfloat16 operands:
B5 (`conv3x3_act`), B2a and B2b (`alignnet_conv1`, `alignnet_conv2`), the
fused body0 that composes them, B3 (`fused_conv3x3_act`, alone and as the
pair) and B4 (`fused_packed_stage`).

JAX's kernels sum the taps in float32 (`preferred_element_type`), run the
epilogue in float32 and round once to the output dtype; B2b keeps y2 and
its moments in float32. The port's CUDA kernels compute the same, and on
CPU tensors each wrapper runs the kernel's plain version
(`*_kernel_reference`), which does too. Tolerances:
  * bfloat16 outputs within 2^-8 of max|ref|, and at most 1% of the values
    differing: the two sides sum in other orders, so a value near a
    rounding boundary may round the other way (an output rounded twice, or
    a product with a rounded slope, differs in 10-70% of its values);
  * float32 outputs (B2b's y2 and moments) within 1e-5 of max|ref|.
On float32 operands each wrapper's CPU result is its differentiated plain
version's (`*_reference`) bit for bit.

Then the x1 repack of bfloat16 B2a (csrc/tma_conv.cuh): its plain version
`alignnet.tma_x1_operands` and the conv rebuilt from it against B2a's plain
version at ragged shapes. The kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_samm_tma import repacked_conv3x3
from torch_inputs import conv_act_inputs, packed_stage_inputs, samm_body0_inputs

from ood_gan_inversion_tpu_torch.ops import alignnet, packed_conv, samm_conv

j_pk = importlib.import_module("ood_gan_inversion_tpu.ops.pallas_kernels")
BF16_TOL = 2.0 ** -8
BF16_DIFFERING = 0.01
F32_TOL = 1e-5
T = torch.from_numpy
STAGE_KEYS = ("x", "n1", "n2", "skip", "k1", "s1", "d1", "b1", "k2", "s2", "d2", "b2",
              "k3sr", "b3", "k4")
PAIR_KEYS = ("x", "n1", "n2", "k1", "s1", "d1", "b1", "k2", "s2", "d2", "b2")
# the operands of the packed kernels that take the activation dtype
PACKED_BF16 = ("x", "skip", "k1", "k2", "k3sr", "k4")


def bf16(a):
    """A float32 array rounded to bfloat16, as (torch bfloat16, jax bfloat16)."""
    t = T(np.ascontiguousarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def to_np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t.astype(jnp.float32),
                      np.float64)


def rel(got, ref):
    got, ref = to_np(got), to_np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1)


def b5_case(act):
    x, k, alpha = conv_act_inputs(2, 24, 16, 16, 16, seed=3)
    xt, xj = bf16(x)
    kt, kj = bf16(k)
    ref = j_pk.conv3x3_act(jnp.transpose(xj, (0, 2, 3, 1)), jnp.transpose(kj, (2, 3, 1, 0)),
                           jnp.asarray(alpha), act)
    got = samm_conv.conv3x3_act(xt, kt, T(alpha) if act == "prelu" else None, act)
    return [(f"B5 {act}", nchw_to_nhwc(got), ref, BF16_TOL)]


def alignnet_case(diff_f_and_g=True):
    """B2a's z and B2b's (y2, part), JAX's two kernels through
    _alignnet_pallas (two bands each, so B2b's moments add across bands),
    the port's B2b on JAX's z."""
    a = samm_body0_inputs(2, 12, 16, 16, seed=5)
    (st, sj), (tt, tj), (k1t, k1j), (k2t, k2j) = (bf16(a[k]) for k in ("s", "t", "k1", "k2"))
    coeffs = alignnet._alignnet_coeffs(st.float(), tt.float(), T(a["g1"]), T(a["b1"]),
                                       diff_f_and_g, 1e-5)[0]
    outs, pallas_call = [], j_pk.pl.pallas_call

    def spy(*args, **kwargs):
        run = pallas_call(*args, **kwargs)
        return lambda *ops: outs.append(run(*ops)) or outs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pk.pl, "pallas_call", spy)
        nhwc = lambda v: jnp.transpose(v, (0, 2, 3, 1))
        hwio = lambda v: jnp.transpose(v, (2, 3, 1, 0))
        j_pk._alignnet_pallas(nhwc(sj), nhwc(tj), jnp.asarray(coeffs.numpy()), hwio(k1j),
                              jnp.asarray(a["alpha"]), hwio(k2j), band_a=8, band_b=8,
                              cast_bf16=False, interpret=True)
    z_ref, (y2_ref, part_ref) = outs
    z = alignnet.alignnet_conv1(st, tt, coeffs, k1t, T(a["alpha"]))
    z_in = T(np.array(z_ref.astype(jnp.float32))).bfloat16().permute(0, 3, 1, 2).contiguous()
    y2, part = alignnet.alignnet_conv2(z_in, k2t)
    assert z.dtype == torch.bfloat16 and y2.dtype == part.dtype == torch.float32
    return [("B2a z", nchw_to_nhwc(z), z_ref, BF16_TOL),
            ("B2b y2", nchw_to_nhwc(y2), y2_ref, F32_TOL),
            ("B2b sum y2", part[:, 0], part_ref[:, 0], F32_TOL),
            ("B2b sum y2^2", part[:, 1], part_ref[:, 1], F32_TOL)]


def body0_case(diff_f_and_g):
    a = samm_body0_inputs(2, 12, 16, 16, seed=6)
    (st, sj), (tt, tj) = bf16(a["s"]), bf16(a["t"])
    names = ("g1", "b1", "k1", "alpha", "k2", "g2", "b2")
    jw = [jnp.asarray(a[k].transpose(2, 3, 1, 0) if k in ("k1", "k2") else a[k]) for k in names]
    ref = j_pk.fused_alignnet_body0(jnp.transpose(sj, (0, 2, 3, 1)), jnp.transpose(tj, (0, 2, 3, 1)),
                                    *jw, diff_f_and_g)
    got = alignnet.fused_alignnet_body0(st, tt, *(T(a[k]) for k in names), diff_f_and_g)
    assert got.dtype == torch.bfloat16
    return [(f"body0 diff_f_and_g={diff_f_and_g}", nchw_to_nhwc(got), ref, BF16_TOL)]


def packed_operands(b=2, h=16, c1=8, c4=16, seed=7):
    """packed_stage_inputs with the activation-dtype operands rounded to
    bfloat16: ({key: torch}, {key: jax})."""
    a = packed_stage_inputs(b, h, h, c1, c4, seed)
    tj = {k: bf16(v) if k in PACKED_BF16 else (T(v), jnp.asarray(v)) for k, v in a.items()}
    return {k: v[0] for k, v in tj.items()}, {k: v[1] for k, v in tj.items()}


def b3_case():
    t, j = packed_operands()
    keys = ("x", "n1", "k1", "s1", "d1", "b1")
    bias = jnp.broadcast_to(j["b1"][None], (2, 16))
    ref = j_pk.fused_conv3x3_act(*(j[k] for k in keys[:5]), bias, band=8, interpret=True)
    got = packed_conv.fused_conv3x3_act(*(t[k] for k in keys))
    return [("B3", got, ref, BF16_TOL)]


def pair_case():
    t, j = packed_operands(seed=8)
    ref = j_pk.fused_packed_pair(*(j[k] for k in PAIR_KEYS))
    got = packed_conv.fused_packed_pair(*(t[k] for k in PAIR_KEYS))
    return [("B3 pair", got, ref, BF16_TOL)]


def b4_case():
    t, j = packed_operands(seed=9)
    rgb_ref, z2_ref = j_pk.fused_packed_stage(*(j[k] for k in STAGE_KEYS))
    rgb, z2 = packed_conv.fused_packed_stage(*(t[k] for k in STAGE_KEYS))
    assert rgb.dtype == z2.dtype == torch.bfloat16
    return [("B4 rgb", rgb, rgb_ref, BF16_TOL), ("B4 z2", z2, z2_ref, BF16_TOL)]


CASES = {
    "B5 prelu": lambda: b5_case("prelu"),
    "B5 lrelu": lambda: b5_case("lrelu"),
    "B5 none": lambda: b5_case("none"),
    "B2a B2b": alignnet_case,
    "body0": lambda: body0_case(True),
    "body0 sn": lambda: body0_case(False),
    "B3": b3_case,
    "B3 pair": pair_case,
    "B4": b4_case,
}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_wrapper_matches_jax_kernel(case):
    """Each bfloat16 kernel wrapper's CPU result against JAX's Pallas kernel
    in interpret mode on the same bfloat16 operands."""
    for what, got, ref, tol in CASES[case]():
        assert tuple(got.shape) == tuple(ref.shape), what
        assert rel(got, ref) <= tol, (what, rel(got, ref))
        if tol == BF16_TOL:
            differing = float(np.mean(to_np(got) != to_np(ref)))
            assert differing <= BF16_DIFFERING, (what, differing)


def f32_calls():
    """{what: (wrapper call, call of the plain version its Function
    differentiates)} on float32 operands, one per wrapper."""
    x, k, alpha = (T(v) for v in conv_act_inputs(2, 24, 16, 16, 16, seed=3))
    a = {k_: T(v) for k_, v in samm_body0_inputs(2, 12, 16, 16, seed=5).items()}
    coeffs = alignnet._alignnet_coeffs(a["s"], a["t"], a["g1"], a["b1"], True, 1e-5)[0]
    conv1 = (a["s"], a["t"], coeffs, a["k1"], a["alpha"])
    z = alignnet.alignnet_conv1_reference(*conv1)
    body0 = [a[k_] for k_ in ("s", "t", "g1", "b1", "k1", "alpha", "k2", "g2", "b2")]
    p = {k_: T(v) for k_, v in packed_stage_inputs(2, 16, 16, 8, 16, seed=7).items()}
    b3 = [p[k_] for k_ in ("x", "n1", "k1", "s1", "d1", "b1")]
    pair, stage = [p[k_] for k_ in PAIR_KEYS], [p[k_] for k_ in STAGE_KEYS]
    calls = {f"B5 {act}": (lambda act=act: samm_conv.conv3x3_act(
                 x, k, alpha if act == "prelu" else None, act),
             lambda act=act: samm_conv.conv3x3_act_reference(x, k, alpha, act))
             for act in samm_conv.ACTS}
    calls.update({
        "B2a": (lambda: alignnet.alignnet_conv1(*conv1),
                lambda: alignnet.alignnet_conv1_reference(*conv1)),
        "B2b": (lambda: alignnet.alignnet_conv2(z, a["k2"]),
                lambda: alignnet.alignnet_conv2_reference(z, a["k2"])),
        "body0": (lambda: alignnet.fused_alignnet_body0(*body0),
                  lambda: fused_body0_of_references(*body0)),
        "B3": (lambda: packed_conv.fused_conv3x3_act(*b3),
               lambda: packed_conv.packed_conv3x3_act_reference(*b3)),
        "B3 pair": (lambda: packed_conv.fused_packed_pair(*pair),
                    lambda: packed_conv.packed_pair_reference(*pair)),
        "B4": (lambda: packed_conv.fused_packed_stage(*stage),
               lambda: packed_conv.packed_stage_reference(*stage))})
    return calls


def fused_body0_of_references(*args):
    """fused_alignnet_body0 with B2a and B2b replaced by the plain versions
    that their Functions differentiate."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(alignnet, "alignnet_conv1", alignnet.alignnet_conv1_reference)
        mp.setattr(alignnet, "alignnet_conv2", alignnet.alignnet_conv2_reference)
        return alignnet.fused_alignnet_body0(*args)


@pytest.mark.parametrize("what", ["B5 prelu", "B5 lrelu", "B5 none", "B2a", "B2b", "body0", "B3",
                                  "B3 pair", "B4"])
def test_float32_wrappers_are_their_twins_bit_for_bit(what):
    """On float32 operands each wrapper's CPU result is the plain version
    its Function differentiates, bit for bit."""
    call, twin = f32_calls()[what]
    got, ref = call(), twin()
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and torch.equal(g, r), what


# (b, C, H, W): odd C with 2C off the 8-channel granule, an odd H * W (the
# kernel's one-pixel path), 2C on the granule, H and W off the pixel tile
X1_RAGGED = [(2, 9, 7, 9), (1, 12, 6, 10), (2, 11, 19, 17), (1, 8, 5, 6)]


def x1_operands(b, c, h, w, dtype):
    a = {k: T(v) for k, v in samm_body0_inputs(b, c, h, w, seed=c + h).items()}
    coeffs = alignnet._alignnet_coeffs(a["s"], a["t"], a["g1"], a["b1"], True, 1e-5)[0]
    return a["s"].to(dtype), a["t"].to(dtype), coeffs, a["k1"].to(dtype), a["alpha"]


@pytest.mark.parametrize("b,c,h,w", X1_RAGGED)
def test_tma_x1_operands_layout(b, c, h, w):
    """xr holds x1 = [as*s + at*t + b1, ct*t + b2] as B2a's plain version
    computes it, NHWC, the channels past 2C zero; wr is k1 tap-major, as
    samm_conv.tma_operands lays it out."""
    s, t, coeffs, k1, _ = x1_operands(b, c, h, w, torch.bfloat16)
    xr, wr = alignnet.tma_x1_operands(s, t, coeffs, k1)
    cp = samm_conv.tma_channels(2 * c)
    assert xr.shape == (b, h, w, cp) and wr.shape == (3, 3, 2 * c, cp)
    assert xr.dtype == wr.dtype == torch.bfloat16 and xr.is_contiguous()
    assert torch.equal(xr[..., :2 * c], alignnet.alignnet_x1(s, t, coeffs).permute(0, 2, 3, 1))
    assert not xr[..., 2 * c:].any() and not wr[..., 2 * c:].any()
    for dx in range(3):
        for dy in range(3):
            assert torch.equal(wr[dx, dy, :, :2 * c], k1[:, :, dy, dx])
    xs, ws = samm_conv.tma_scratch(s, k1)
    assert (xs.shape, ws.shape, xs.dtype) == (xr.shape, wr.shape, xr.dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,w", X1_RAGGED)
def test_conv_from_x1_operands_matches_b2a(b, c, h, w, dtype):
    """PReLU of the conv rebuilt from the x1 repack's operands (zeros
    outside the image: TMA's fill is x1's padding, not the affine image of
    zero-padded s and t) is B2a's plain version: to float64 rounding, and
    on bfloat16 operands within the output's one rounding, 2^-8 of
    max|ref|."""
    s, t, coeffs, k1, alpha = x1_operands(b, c, h, w, dtype)
    alpha = alpha.to(dtype).float()          # as alignnet_conv1 rounds the slopes
    conv = repacked_conv3x3(*alignnet.tma_x1_operands(s, t, coeffs, k1))
    got = torch.where(conv >= 0, conv, alpha.double()[:, None, None] * conv)
    ref = alignnet.alignnet_conv1_kernel_reference(s, t, coeffs, k1, alpha)
    assert ref.shape == got.shape == (b, 2 * c, h, w) and ref.dtype == dtype
    tol = 1e-12 if dtype == torch.float64 else BF16_TOL
    assert float((got - ref.double()).abs().max()) <= tol * float(ref.double().abs().max())
