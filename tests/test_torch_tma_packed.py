"""B4 and B3 in both dtypes and float32 B2b on the TMA core
(csrc/tma_conv.cuh) on the CPU.

B4: the plain versions of its words -- `packed_conv.stage_input_words` (x *
s1 in float32, split once into hi and lo words, 16 channels of each per
128-byte row, channels padded with zeros to a multiple of 16),
`stage_weight_words` (HWIO k1, k2 as the core's (3 [dx], 3 [dy], Co, 2 Cp)
words) and `stage_z_words` (conv1's activation as conv2's words) -- and the
stage that the kernels compute from them: each conv emulated from the words
in float64 (lo*hi + hi*lo + hi*hi over the nine shifted windows, the tensor
cores reading the top 19 bits of each word), the epilogues in float64,
conv2 reading the words of the emulated z. It is held against the kernels'
plain version within the float32 tolerance at ragged shapes and on
`packed_cancel_inputs`, where hi*hi alone misses by more than 10x, and once
against JAX's `fused_packed_stage` (its Pallas kernel in interpret mode).

float32 B3: the same words of x * s_in and k, the conv emulated from them
and its epilogue, against B3's kernel's plain version at ragged shapes and
on the cancelling inputs, the pair as two such convs (the second repacking
the first's float32 output times s2) against `packed_pair_reference`, and
once against JAX's `fused_conv3x3_act` in interpret mode.

bfloat16 B4: the same plain versions on bfloat16 operands (x * s1 rounded
as `_scaled` rounds it, channels padded with zeros to a multiple of 8, no
split), and the stage emulated from them in float64 with each output
rounded once to bfloat16, against `packed_stage_kernel_reference` within
2^-7 of max|ref|.

bfloat16 B3: the same operands for one conv (no k2) in `conv_scratch`'s
shapes, B3 emulated from them (float64 sums, one rounding) against B3's
kernel's plain version within 2^-7 of max|ref|, and the pair as two such
calls (the second repacking the first's bfloat16 output times s2) against
`packed_pair_reference`.

B2b: the moments of the conv emulated from `samm_conv.tma_operands(z, k2)`
against `alignnet_conv2_kernel_reference`'s. The kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_samm_tma import repacked_conv3x3
from test_torch_tma_tf32 import LOW, TOL, bits, emulated_conv, planes, rel_err
from torch_inputs import (PAIR_KEYS, conv_act_inputs, packed_cancel_inputs,
                          packed_stage_inputs, tf32_cancel_inputs)

from ood_gan_inversion_tpu.ops import pallas_kernels as j_pk
from ood_gan_inversion_tpu_torch.ops import alignnet, packed_conv, samm_conv

# (b, H, W, C1, C4): C1 off the 16-channel granule, odd H and W, Cmid = C4 /
# 4 not a multiple of 16 (C4 off the granule too), and one case on it
RAGGED = [(2, 7, 9, 12, 20), (1, 5, 11, 37, 44), (2, 6, 6, 16, 32)]
CANCEL = [(1, 12, 12, 32, 64), (2, 7, 9, 20, 24)]
ORDER = ("x", "n1", "n2", "skip", "k1", "s1", "d1", "b1", "k2", "s2", "d2", "b2",
         "k3sr", "b3", "k4")
ALL = ("lo*hi", "hi*lo", "hi*hi")
CONV1 = ("x", "n1", "k1", "s1", "d1", "b1")
TOL_BF16 = 2.0 ** -7    # bfloat16 outputs, of max|ref| (tests/test_torch_cuda.py)
BF16_KEYS = ("x", "skip", "k1", "k2", "k3sr", "k4")


def stage_inputs(case, inputs=packed_stage_inputs):
    return {k: torch.from_numpy(v) for k, v in inputs(*case, seed=sum(case)).items()}


def nhwc_conv(xr, wr, passes=ALL):
    """The TMA conv emulated from its words (float64), NHWC."""
    return emulated_conv(xr, wr, passes).permute(0, 2, 3, 1)


def emulated_stage(a, passes=ALL):
    """(rgb, z2, z) of float32 B4 as its kernels compute them from the
    words, in float64: conv1 from the words of x * s1 and k1, its epilogue,
    times s2, rounded to float32 (z, as STAGE1_TF32 stores it before the
    split); conv2 from the words of z and k2, its epilogue (z2); toRGB of z2
    and the skip upsample."""
    d = {k: v.double() for k, v in a.items()}
    y1 = nhwc_conv(packed_conv.stage_input_words(a["x"], a["s1"]),
                   packed_conv.stage_weight_words(a["k1"]), passes)
    z = (packed_conv._epilogue(y1, d["n1"], d["d1"], d["b1"])
         * packed_conv._per_sample(d["s2"], y1.shape[0])).float()
    cp4 = samm_conv.tma_channels(z.shape[-1], torch.float32)
    y2 = nhwc_conv(samm_conv.tf32_words(z, cp4), packed_conv.stage_weight_words(a["k2"]), passes)
    z2 = packed_conv._epilogue(y2, d["n2"], d["d2"], d["b2"])
    return packed_conv._rgb(z2, d["k3sr"], d["b3"], d["skip"], d["k4"]), z2, z


def check_words(words, want, c):
    """words (..., 2 Cp): hi words with their low 13 bits clear, hi + lo ==
    want (..., c) bit for bit, zero words past c."""
    hi, lo = planes(words)
    assert hi.shape[-1] % 16 == 0 and c <= hi.shape[-1] < c + 16
    assert not (bits(hi) & LOW).any()
    assert torch.equal(bits((hi + lo)[..., :c]), bits(want.contiguous()))
    assert not bits(hi[..., c:]).any() and not bits(lo[..., c:]).any()


@pytest.mark.parametrize("case", RAGGED)
def test_stage_words_layout(case):
    """The repack's plain versions: x * s1 and k1, k2 as words, at ragged
    shapes; the scratch of a float32 call has their shapes."""
    b, h, w, c1, c4 = case
    a = stage_inputs(case)
    xr = packed_conv.stage_input_words(a["x"], a["s1"])
    assert xr.shape[:3] == (b, h, w) and xr.dtype == torch.float32 and xr.is_contiguous()
    check_words(xr, a["x"] * a["s1"][:, None, None, :], c1)
    for k, ci in (("k1", c1), ("k2", c4)):
        wr = packed_conv.stage_weight_words(a[k])
        assert wr.shape[:3] == (3, 3, c4) and wr.is_contiguous()
        for dx in range(3):
            for dy in range(3):
                check_words(wr[dx, dy], a[k][dy, dx].T, ci)
    scratch = packed_conv.stage_scratch(a["x"], c4)
    zr = packed_conv.stage_z_words(*(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1", "s2")))
    for key, ref in (("xr", xr), ("w1r", packed_conv.stage_weight_words(a["k1"])),
                     ("w2r", packed_conv.stage_weight_words(a["k2"])), ("z", zr)):
        assert scratch[key].shape == ref.shape and scratch[key].dtype == ref.dtype, key
    # float32 B3's scratch: the same words for its one conv
    for t, ref in zip(packed_conv.conv_scratch(a["x"], c4), (xr, scratch["w1r"])):
        assert t.shape == ref.shape and t.dtype == ref.dtype


@pytest.mark.parametrize("case", RAGGED)
def test_z_words_are_the_plain_z_split(case):
    """What conv1 writes for conv2: the plain version's z (conv1 and its
    epilogue times s2, as packed_stage_kernel_reference computes it) as
    tf32_words, bit for bit, its padded channels zero; conv2 on z is that
    reference's z2."""
    c4 = case[4]
    a = stage_inputs(case)
    conv1 = [a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1", "s2")]
    z = packed_conv._kernel_stage_z(*conv1)
    zr = packed_conv.stage_z_words(*conv1)
    check_words(zr, z, c4)
    cp4 = samm_conv.tma_channels(c4, torch.float32)
    assert torch.equal(bits(zr), bits(samm_conv.tf32_words(z, cp4)))
    _, z2 = packed_conv.packed_stage_kernel_reference(*(a[k] for k in ORDER))
    assert torch.equal(z2, packed_conv._kernel_conv_act(z, a["n2"], a["k2"], a["d2"], a["b2"]))


@pytest.mark.parametrize("case", RAGGED)
def test_conv1_from_words_matches_b3(case):
    """conv1 emulated from the words, with B3's epilogue (no s2), is B3's
    kernel's plain version within TOL of max|ref|."""
    a = stage_inputs(case)
    d = {k: v.double() for k, v in a.items()}
    y1 = nhwc_conv(packed_conv.stage_input_words(a["x"], a["s1"]),
                   packed_conv.stage_weight_words(a["k1"]))
    got = packed_conv._epilogue(y1, d["n1"], d["d1"], d["b1"])
    ref = packed_conv.packed_conv3x3_act_kernel_reference(
        *(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1")))
    assert got.shape == ref.shape
    assert rel_err(got, ref) <= TOL


@pytest.mark.parametrize("case", RAGGED)
def test_stage_from_words_matches_b4(case):
    """The whole stage emulated from the words (z2 and rgb) is B4's plain
    version within TOL of max|ref|."""
    a = stage_inputs(case)
    rgb, z2, _ = emulated_stage(a)
    rgb_ref, z2_ref = packed_conv.packed_stage_kernel_reference(*(a[k] for k in ORDER))
    assert rel_err(z2, z2_ref) <= TOL and rel_err(rgb, rgb_ref) <= TOL


@pytest.mark.parametrize("case", CANCEL)
def test_stage_from_words_on_cancelling_inputs(case):
    """On packed_cancel_inputs (both convs cancel a large common offset) the
    three products stay within TOL of B4's plain version for z2 and rgb,
    while hi*hi alone misses z2 by more than 10x."""
    a = stage_inputs(case, packed_cancel_inputs)
    rgb_ref, z2_ref = packed_conv.packed_stage_kernel_reference(*(a[k] for k in ORDER))
    rgb, z2, _ = emulated_stage(a)
    assert rel_err(z2, z2_ref) <= TOL and rel_err(rgb, rgb_ref) <= TOL
    assert rel_err(emulated_stage(a, ("hi*hi",))[1], z2_ref) > 10 * TOL


def test_stage_from_words_matches_jax():
    """The emulated stage against JAX's fused_packed_stage (its Pallas stage
    kernel in interpret mode) at a micro size: within 2e-5, absolute plus
    relative, as tests/test_torch_packed.py holds the port's stage."""
    a = stage_inputs((1, 16, 16, 8, 16))
    rgb, z2, _ = emulated_stage(a)
    rgb_ref, z2_ref = j_pk.fused_packed_stage(*(jnp.asarray(a[k].numpy()) for k in ORDER))
    np.testing.assert_allclose(z2.numpy(), np.asarray(z2_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ float32 B3

def emulated_b3(args, passes=ALL):
    """float32 B3 as its kernels compute it, in float64: the conv from the
    words of x * s_in and k (the repack launch's), then the epilogue (no
    s2); args as packed_conv3x3_act_reference's."""
    x, n4, k, s, d, bias = args
    y = nhwc_conv(packed_conv.stage_input_words(x, s), packed_conv.stage_weight_words(k), passes)
    return packed_conv._epilogue(y, n4.double(), d.double(), bias.double())


def pair_convs(a):
    """The argument tuples of the pair's two B3 calls, conv2 on conv1's
    output as its plain version computes it."""
    conv1 = tuple(a[k] for k in CONV1)
    z = packed_conv.packed_conv3x3_act_kernel_reference(*conv1)
    return conv1, (z, a["n2"], a["k2"], a["s2"], a["d2"], a["b2"])


@pytest.mark.parametrize("case", CANCEL)
def test_b3_from_words_on_cancelling_inputs(case):
    """float32 B3 on packed_cancel_inputs, at both convs of the pair (each
    cancels a large common offset): the three products stay within TOL of
    B3's kernel's plain version, while hi*hi alone misses conv2 by more
    than 10x and conv1, whose output carries b1's offset of 4, by more than
    TOL."""
    a = stage_inputs(case, packed_cancel_inputs)
    for args, miss in zip(pair_convs(a), (TOL, 10 * TOL)):
        ref = packed_conv.packed_conv3x3_act_kernel_reference(*args)
        assert rel_err(emulated_b3(args), ref) <= TOL
        assert rel_err(emulated_b3(args, ("hi*hi",)), ref) > miss


@pytest.mark.parametrize("case,inputs", [(c, packed_stage_inputs) for c in RAGGED]
                         + [(c, packed_cancel_inputs) for c in CANCEL])
def test_pair_from_words_matches_plain(case, inputs):
    """fused_packed_pair as the float32 kernels compute it: two B3 calls,
    the second repacking the first's float32 output times s2 (the words of
    its x * s_in), within TOL of packed_pair_reference, at ragged shapes and
    on the cancelling inputs, where hi*hi alone misses by more than 10x."""
    a = stage_inputs(case, inputs)
    conv1, conv2 = pair_convs(a)
    ref = packed_conv.packed_pair_reference(*(a[k] for k in PAIR_KEYS))

    def pair(passes):
        z = emulated_b3(conv1, passes).float()       # what the first call stores
        return emulated_b3((z,) + conv2[1:], passes)
    assert rel_err(pair(ALL), ref) <= TOL
    if inputs is packed_cancel_inputs:
        assert rel_err(pair(("hi*hi",)), ref) > 10 * TOL


def test_b3_from_words_matches_jax():
    """The emulated B3 against JAX's fused_conv3x3_act (its Pallas kernel in
    interpret mode) at a micro size: within 2e-5, absolute plus relative."""
    a = stage_inputs((2, 8, 12, 12, 16))
    args = tuple(a[k] for k in CONV1)
    got = emulated_b3(args)
    j = [jnp.asarray(v.numpy()) for v in args]
    j[5] = jnp.broadcast_to(j[5][None], (2, j[5].shape[0]))     # bias (B, Co)
    ref = j_pk.fused_conv3x3_act(*j, band=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# ----------------------------------------------------------- bfloat16 B4

def bf16_inputs(case):
    """stage_inputs with x, skip and the kernels rounded to bfloat16."""
    a = stage_inputs(case)
    for k in BF16_KEYS:
        a[k] = a[k].to(torch.bfloat16)
    return a


def check_padded(t, want, c):
    """t (..., Cp) bfloat16: want (..., c) bit for bit, then zero bits, Cp
    the multiple of 8 at or above c."""
    assert t.dtype == torch.bfloat16 and t.is_contiguous()
    assert t.shape[-1] % 8 == 0 and c <= t.shape[-1] < c + 8
    assert torch.equal(t[..., :c].view(torch.int16), want.contiguous().view(torch.int16))
    assert not t[..., c:].view(torch.int16).any()


@pytest.mark.parametrize("case", RAGGED)
def test_bf16_stage_operands_layout(case):
    """The bfloat16 repack's plain versions at ragged shapes: x * s1 with s1
    rounded to bfloat16 first, then the product rounded (which differs from
    rounding the float32 product), channels padded with zeros to a multiple
    of 8; k1, k2 laid out [dx, dy, co, ci] likewise; conv1's z operand is
    _kernel_stage_z padded with zeros, bit for bit; the scratch of a
    bfloat16 call has their shapes and dtype."""
    b, h, w, c1, c4 = case
    a = bf16_inputs(case)
    xr = packed_conv.stage_input_words(a["x"], a["s1"])
    assert xr.shape[:3] == (b, h, w)
    xs = a["x"] * a["s1"].to(torch.bfloat16)[:, None, None, :]
    check_padded(xr, xs, c1)
    unrounded = (a["x"].float() * a["s1"][:, None, None, :]).to(torch.bfloat16)
    assert not torch.equal(xs, unrounded)
    w1r, w2r = (packed_conv.stage_weight_words(a[k]) for k in ("k1", "k2"))
    for wr, k, ci in ((w1r, "k1", c1), (w2r, "k2", c4)):
        assert wr.shape[:3] == (3, 3, c4)
        for dx in range(3):
            for dy in range(3):
                check_padded(wr[dx, dy], a[k][dy, dx].T, ci)
    conv1 = [a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1", "s2")]
    zr = packed_conv.stage_z_words(*conv1)
    check_padded(zr, packed_conv._kernel_stage_z(*conv1), c4)
    scratch = packed_conv.stage_scratch(a["x"], c4)
    for key, ref in (("xr", xr), ("w1r", w1r), ("w2r", w2r), ("z", zr)):
        assert scratch[key].shape == ref.shape and scratch[key].dtype == ref.dtype, key


def emulated_stage_bf16(a):
    """(rgb, z2, z) of bfloat16 B4 as its kernels compute it from the
    operands, in float64 with one rounding to bfloat16 per output: conv1
    from stage_input_words and stage_weight_words, its epilogue times s2
    (z); conv2 from z's padded operand; toRGB of z2 as stored and the skip
    upsample."""
    d = {k: v.double() for k, v in a.items()}
    bf = lambda v: v.float().to(torch.bfloat16)
    y1 = repacked_conv3x3(packed_conv.stage_input_words(a["x"], a["s1"]),
                          packed_conv.stage_weight_words(a["k1"])).permute(0, 2, 3, 1)
    z = bf(packed_conv._epilogue(y1, d["n1"], d["d1"], d["b1"])
           * packed_conv._per_sample(d["s2"], y1.shape[0]))
    y2 = repacked_conv3x3(F.pad(z, (0, samm_conv.tma_channels(z.shape[-1]) - z.shape[-1])),
                          packed_conv.stage_weight_words(a["k2"])).permute(0, 2, 3, 1)
    z2 = bf(packed_conv._epilogue(y2, d["n2"], d["d2"], d["b2"]))
    rgb = bf(packed_conv._rgb(z2.double(), d["k3sr"], d["b3"], d["skip"], d["k4"]))
    return rgb, z2, z


@pytest.mark.parametrize("case", RAGGED)
def test_bf16_stage_from_operands_matches_b4(case):
    """bfloat16 B4 emulated from its operands: z, z2 and rgb within 2^-7 of
    max|ref| of the kernels' plain version (packed_stage_kernel_reference,
    _kernel_stage_z) in bfloat16."""
    a = bf16_inputs(case)
    rgb, z2, z = emulated_stage_bf16(a)
    rgb_ref, z2_ref = packed_conv.packed_stage_kernel_reference(*(a[k] for k in ORDER))
    z_ref = packed_conv._kernel_stage_z(*(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1", "s2")))
    assert rgb.dtype == rgb_ref.dtype == z2_ref.dtype == torch.bfloat16
    for got, ref in ((z, z_ref), (z2, z2_ref), (rgb, rgb_ref)):
        assert got.shape == ref.shape and rel_err(got, ref) <= TOL_BF16


# ----------------------------------------------------------- bfloat16 B3

def emulated_b3_bf16(args):
    """bfloat16 B3 as its kernels compute it: the conv from the repack's
    operands (stage_input_words of x * s_in, stage_weight_words of k) in
    float64, the epilogue (no s2), one rounding to bfloat16; args as
    packed_conv3x3_act_reference's."""
    x, n4, k, s, d, bias = args
    y = repacked_conv3x3(packed_conv.stage_input_words(x, s),
                         packed_conv.stage_weight_words(k)).permute(0, 2, 3, 1)
    return packed_conv._epilogue(y, n4.double(), d.double(), bias.double()).float().to(
        torch.bfloat16)


@pytest.mark.parametrize("case", RAGGED)
def test_bf16_b3_operands_layout(case):
    """bfloat16 B3's repack, one conv (no k2), at both convs of the pair:
    x * s_in with s_in rounded to bfloat16 first, then the product rounded,
    and k laid out [dx, dy, co, ci], channels padded with zero bits to a
    multiple of 8, in conv_scratch's shapes and dtype."""
    b, h, w, c1, c4 = case
    a = bf16_inputs(case)
    z = packed_conv.packed_conv3x3_act_kernel_reference(*(a[k] for k in CONV1))
    assert z.dtype == torch.bfloat16
    for x, s, k, ci in ((a["x"], a["s1"], a["k1"], c1), (z, a["s2"], a["k2"], c4)):
        xr, wr = packed_conv.stage_input_words(x, s), packed_conv.stage_weight_words(k)
        check_padded(xr, x * s.to(torch.bfloat16)[:, None, None, :], ci)
        assert xr.shape[:3] == (b, h, w) and wr.shape[:3] == (3, 3, c4)
        for dx in range(3):
            for dy in range(3):
                check_padded(wr[dx, dy], k[dy, dx].T, ci)
        for t, ref in zip(packed_conv.conv_scratch(x, c4), (xr, wr)):
            assert t.shape == ref.shape and t.dtype == ref.dtype == torch.bfloat16


@pytest.mark.parametrize("case", RAGGED)
def test_bf16_b3_from_operands_matches_plain(case):
    """bfloat16 B3 emulated from its operands is B3's kernel's plain version
    within 2^-7 of max|ref| at both convs of the pair; the pair as two such
    calls, the second on the first's bfloat16 output (repacked times s2),
    is packed_pair_reference's within 2^-7 of max|ref|."""
    a = bf16_inputs(case)
    conv1, conv2 = pair_convs(a)
    for args in (conv1, conv2):
        got = emulated_b3_bf16(args)
        ref = packed_conv.packed_conv3x3_act_kernel_reference(*args)
        assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
        assert rel_err(got, ref) <= TOL_BF16
    z = emulated_b3_bf16(conv1)
    pair = emulated_b3_bf16((z,) + conv2[1:])
    ref = packed_conv.packed_pair_reference(*(a[k] for k in PAIR_KEYS))
    assert pair.dtype == ref.dtype and rel_err(pair, ref) <= TOL_BF16


def moments(y):
    return torch.stack([y.sum((2, 3)), (y * y).sum((2, 3))], 1)


@pytest.mark.parametrize("case,cancel", [((2, 37, 37, 19, 27), False), ((1, 48, 48, 16, 16), False),
                                         ((1, 64, 64, 12, 12), True), ((2, 36, 36, 9, 11), True)])
def test_b2b_moments_from_tf32_operands(case, cancel):
    """float32 B2b (AN_CONV2_TF32): y2 and its moments from the conv
    emulated from tma_operands(z, k2) are alignnet_conv2_kernel_reference's
    within TOL of max|ref| (each moment row against its own), at ragged
    shapes and on tf32_cancel_inputs, where hi*hi alone misses y2 by more
    than 10x."""
    b, ci, co, h, w = case
    if cancel:
        z, k = (torch.from_numpy(v) for v in tf32_cancel_inputs(b, ci, co, h, w, seed=ci + h))
    else:
        z, k = (torch.from_numpy(v) for v in conv_act_inputs(b, ci, co, h, w, seed=ci)[:2])
    y2_ref, part_ref = alignnet.alignnet_conv2_kernel_reference(z, k)
    y2 = emulated_conv(*samm_conv.tma_operands(z, k))
    assert rel_err(y2, y2_ref) <= TOL
    part = moments(y2)
    for m in range(2):
        assert rel_err(part[:, m], part_ref[:, m]) <= TOL, m
    if cancel:
        assert rel_err(emulated_conv(*samm_conv.tma_operands(z, k), ("hi*hi",)), y2_ref) > 10 * TOL
