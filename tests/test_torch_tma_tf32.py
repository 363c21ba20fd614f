"""The float32 operands of the TMA conv kernel (csrc/tma_conv.cuh, B5's and
B2a's float32 path) on the CPU: the plain version of its repack pass
(`samm_conv.tma_operands`, `alignnet.tma_x1_operands` on float32), which
splits each value once into hi = v rounded to TF32 (half away from zero)
and lo = v - hi and lays them out as words, per 16 channels their hi words
then their lo words, channels padded with zeros to a multiple of 16; and
the conv that the kernel computes from those words -- lo*hi + hi*lo + hi*hi
over the nine shifted NHWC windows, the tensor cores reading the top 19
bits of each word -- emulated in float64 against the kernels' plain
versions within their float32 tolerance, at ragged shapes and on inputs
where one TF32 pass misses it by more than 10x. Bits are read through
int32 views, as tests/test_torch_tf32_split.py does. The kernel and its
repack pass are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest
import torch

from test_torch_samm_tma import RAGGED, repacked_conv3x3
from torch_inputs import conv_act_inputs, samm_body0_inputs, tf32_cancel_inputs

from ood_gan_inversion_tpu_torch.ops import alignnet, samm_conv

TOL = 1e-4          # the float32 SAMM kernels' tolerance, of max|ref|
LOW = 0x1FFF        # the 13 mantissa bits below TF32's 10
CANCEL = [(1, 64, 64, 16, 16), (2, 48, 40, 11, 13)]
# (b, C, H, W) of B2a: odd C (2C off the 16-channel granule), 2C on it, an
# odd H * W
X1_RAGGED = [(2, 37, 19, 27), (1, 8, 5, 6), (2, 9, 7, 9)]


def bits(v):
    return v.contiguous().view(torch.int32)


def planes(words):
    """(hi, lo) of the kernel's words (..., 2 Cp): each (..., Cp)."""
    g = words.reshape(*words.shape[:-1], -1, 2, samm_conv.TF32_CHANNELS)
    return g[..., 0, :].reshape(*words.shape[:-1], -1), g[..., 1, :].reshape(*words.shape[:-1], -1)


def truncated(v):
    """What the tensor cores read of a float32 word: its top 19 bits."""
    return (bits(v) & ~LOW).view(torch.float32)


def emulated_conv(xr, wr, passes=("lo*hi", "hi*lo", "hi*hi")):
    """The kernel's conv from its words in float64: the chosen products of
    the weights' and the input's planes over the nine shifted windows."""
    xh, xl = (truncated(p) for p in planes(xr))
    wh, wl = (truncated(p) for p in planes(wr))
    pairs = {"lo*hi": (xh, wl), "hi*lo": (xl, wh), "hi*hi": (xh, wh)}
    return sum(repacked_conv3x3(*pairs[p]) for p in passes)


def rel_err(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def prelu64(v, alpha):
    return torch.where(v >= 0, v, alpha.double()[:, None, None] * v)


def test_split_tf32_rounds_half_away_from_zero():
    """hi + lo == v bit for bit, hi's low 13 bits are zero, and hi is v
    rounded to a 10-bit mantissa half away from zero (ties included, where
    round-to-even would differ), over eight decades and both signs."""
    g = torch.Generator().manual_seed(0)
    v = (torch.randn(4096, generator=g, dtype=torch.float64)
         * 10.0 ** torch.randint(-4, 4, (4096,), generator=g)).float()
    ulp = 2.0 ** -10
    ties = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2, 2 * (1 + 5 * ulp / 2),
                         -0.5 * (1 + ulp / 2)], dtype=torch.float32)
    v = torch.cat([v, ties, torch.zeros(1)])
    hi, lo = samm_conv.split_tf32(v)
    assert torch.equal(bits(hi + lo), bits(v))
    assert not (bits(hi) & LOW).any()
    m, e = torch.frexp(v.double().abs())               # |v| = m 2^e, m in [0.5, 1)
    step = torch.ldexp(torch.ones_like(m), e - 11)      # TF32's last mantissa bit
    want = torch.sign(v.double()) * torch.floor(v.double().abs() / step + 0.5) * step
    assert torch.equal(hi.double(), want)
    assert hi[-6:-1].tolist() == [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 2 * (1 + 3 * ulp),
                                  -0.5 * (1 + ulp)]


@pytest.mark.parametrize("b,ci,co,h,w", RAGGED)
def test_tf32_operands_layout(b, ci, co, h, w):
    """xr[b, y, x] and wr[dx, dy, o] hold x[b, :, y, x] and k[o, :, dy, dx]
    as hi and lo words, 16 channels of hi then 16 of lo, hi + lo the value
    bit for bit; the channels past Ci are zero words; the scratch has the
    same shapes."""
    x, k, _ = (torch.from_numpy(v) for v in conv_act_inputs(b, ci, co, h, w, seed=ci + co))
    xr, wr = samm_conv.tma_operands(x, k)
    cp = samm_conv.tma_channels(ci, torch.float32)
    assert cp % 16 == 0 and ci <= cp < ci + 16
    assert xr.shape == (b, h, w, 2 * cp) and wr.shape == (3, 3, co, 2 * cp)
    assert xr.dtype == wr.dtype == torch.float32 and xr.is_contiguous() and wr.is_contiguous()
    for words, want in ((xr, x.permute(0, 2, 3, 1)), (wr, k.permute(3, 2, 0, 1))):
        hi, lo = planes(words)
        assert not (bits(hi) & LOW).any()
        assert torch.equal(bits((hi + lo)[..., :ci]), bits(want))
        assert not bits(hi[..., ci:]).any() and not bits(lo[..., ci:]).any()
    xs, ws = samm_conv.tma_scratch(x, k)
    assert (xs.shape, ws.shape, xs.dtype, ws.dtype) == (xr.shape, wr.shape, xr.dtype, wr.dtype)


def x1_operands(b, c, h, w):
    a = {k: torch.from_numpy(v) for k, v in samm_body0_inputs(b, c, h, w, seed=c + h).items()}
    coeffs = alignnet._alignnet_coeffs(a["s"], a["t"], a["g1"], a["b1"], True, 1e-5)[0]
    return a["s"], a["t"], coeffs, a["k1"], a["alpha"]


def cancel_x1_operands(b, c2, h, w):
    """B2a's operands whose x1 is tf32_cancel_inputs' x: s and t its two
    halves, the coefficients [1, 0, 0, 1, 0]."""
    x, k = (torch.from_numpy(v) for v in tf32_cancel_inputs(b, c2, c2, h, w, seed=c2 + h))
    c = c2 // 2
    coeffs = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0])[None, :, None].expand(b, 5, c).contiguous()
    return x[:, :c].contiguous(), x[:, c:].contiguous(), coeffs, k, torch.full((c2,), 0.25)


@pytest.mark.parametrize("b,c,h,w", X1_RAGGED)
def test_tf32_x1_operands_layout(b, c, h, w):
    """The x1 mode: xr's words are x1 = alignnet_x1(s, t, coeffs) in
    float32, split, hi + lo == x1 bit for bit, the channels past 2C zero;
    wr is k1's words as tma_operands lays them out."""
    s, t, coeffs, k1, _ = x1_operands(b, c, h, w)
    xr, wr = alignnet.tma_x1_operands(s, t, coeffs, k1)
    cp = samm_conv.tma_channels(2 * c, torch.float32)
    assert xr.shape == (b, h, w, 2 * cp) and wr.shape == (3, 3, 2 * c, 2 * cp)
    hi, lo = planes(xr)
    x1 = alignnet.alignnet_x1(s, t, coeffs)
    assert x1.dtype == torch.float32
    assert torch.equal(bits((hi + lo)[..., :2 * c]), bits(x1.permute(0, 2, 3, 1)))
    assert not bits(hi[..., 2 * c:]).any() and not bits(lo[..., 2 * c:]).any()
    assert torch.equal(wr, samm_conv.tma_operands(x1, k1)[1])


@pytest.mark.parametrize("b,ci,co,h,w", RAGGED)
def test_conv_from_tf32_operands_matches_b5(b, ci, co, h, w):
    """PReLU of the conv emulated from the words is B5's plain version on
    the same float32 operands within TOL of max|ref|."""
    x, k, alpha = (torch.from_numpy(v) for v in conv_act_inputs(b, ci, co, h, w, seed=ci + co))
    got = prelu64(emulated_conv(*samm_conv.tma_operands(x, k)), alpha)
    ref = samm_conv.conv3x3_act_kernel_reference(x, k, alpha, "prelu")
    assert got.shape == ref.shape == (b, co, h, w)
    assert rel_err(got, ref) <= TOL


@pytest.mark.parametrize("b,ci,co,h,w", CANCEL)
def test_conv_from_tf32_operands_on_cancelling_inputs(b, ci, co, h, w):
    """On tf32_cancel_inputs the emulated three products stay within TOL of
    B5's plain version, where the hi*hi pass alone misses it by >10x."""
    x, k = (torch.from_numpy(v) for v in tf32_cancel_inputs(b, ci, co, h, w, seed=ci + h))
    ref = samm_conv.conv3x3_act_kernel_reference(x, k, None, "none")
    xr, wr = samm_conv.tma_operands(x, k)
    assert rel_err(emulated_conv(xr, wr), ref) <= TOL
    assert rel_err(emulated_conv(xr, wr, ("hi*hi",)), ref) > 10 * TOL


@pytest.mark.parametrize("case", [*X1_RAGGED, *CANCEL])
def test_conv_from_tf32_x1_operands_matches_b2a(case):
    """The same for B2a: PReLU of the conv emulated from the x1 repack's
    words is its plain version within TOL of max|ref|, at ragged shapes and
    on the cancelling inputs (x1 = the cancelling x), where one pass misses
    by >10x."""
    if len(case) == 4:
        args = x1_operands(*case)
    else:
        b, ci, _, h, w = case
        args = cancel_x1_operands(b, ci, h, w)
    s, t, coeffs, k1, alpha = args
    xr, wr = alignnet.tma_x1_operands(s, t, coeffs, k1)
    ref = alignnet.alignnet_conv1_kernel_reference(s, t, coeffs, k1, alpha)
    assert rel_err(prelu64(emulated_conv(xr, wr), alpha), ref) <= TOL
    if len(case) == 5:
        assert rel_err(prelu64(emulated_conv(xr, wr, ("hi*hi",)), alpha), ref) > 10 * TOL
