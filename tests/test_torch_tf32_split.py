"""Why the SAMM conv kernel multiplies float32 operands as three TF32
products: on the inputs of `torch_inputs.tf32_cancel_inputs` a single TF32
pass misses the kernels' float32 tolerance (1e-4 of max|ref|) by more than
an order of magnitude, and the split hi*hi + hi*lo + lo*hi meets it. TF32
rounding (round to nearest even onto a 10-bit mantissa) is emulated in
torch on the CPU and the products are summed in float64, so only the
operand rounding differs between the cases. The card test
`test_torch_cuda.py::test_samm_kernels_float32_accuracy_on_card` runs the
kernels on the same kind of inputs at the 64px 1024 -> 1024 shape. The
packed stage kernel (B4) contracts over K = 9 * 64, 9 * 128 and 9 * 256 at
the packed stages of the 1024px generator; its float32 tolerance is the
same 1e-4, and one pass misses it there by ~30x too
(`test_torch_cuda.py::test_packed_stage_float32_accuracy_on_card`)."""

import pytest
import torch
import torch.nn.functional as F

from torch_inputs import conv_act_inputs, tf32_cancel_inputs

TOL = 1e-4       # the conv kernels' float32 tolerance (SAMM and packed), of max|ref|


def tf32(t):
    """float32 -> the nearest TF32 value (ties to even), still float32."""
    u = t.contiguous().view(torch.int32)
    u = (u + 0xFFF + ((u >> 13) & 1)) & ~0x1FFF
    return u.view(torch.float32)


def conv64(x, k):
    return F.conv2d(x.double(), k.double(), padding=1)


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def one_pass(x, k):
    return conv64(tf32(x), tf32(k))


def three_pass(x, k):
    xh, kh = tf32(x), tf32(k)
    xl, kl = tf32(x - xh), tf32(k - kh)
    return conv64(xh, kh) + conv64(xh, kl) + conv64(xl, kh)


def test_tf32_rounding_emulation():
    """10-bit mantissa, ties to even, sign kept; TF32 values are fixed."""
    one = 1.0 + 2.0 ** -10
    v = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11), one,
                      1.0 + 2.0 ** -11 + 2.0 ** -20], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 * 2.0 ** -10, -1.0, one, one], dtype=torch.float32)
    assert torch.equal(tf32(v), want)
    assert torch.equal(tf32(want), want)


@pytest.mark.parametrize("b,ci,co,h,w", [
    (1, 64, 64, 16, 16), (2, 48, 40, 11, 13),
    # the packed stage kernel's contraction lengths K = 9 * 64, 9 * 128, 9 * 256
    (1, 64, 16, 12, 12), (1, 128, 16, 12, 12), (1, 256, 16, 12, 12)])
def test_one_tf32_pass_fails_and_three_pass(b, ci, co, h, w):
    x, k = (torch.from_numpy(v) for v in tf32_cancel_inputs(b, ci, co, h, w, seed=ci + h))
    ref = conv64(x, k)
    # the offset cancels at every pixel, the border ones included
    assert float(conv64(torch.ones_like(x), k).abs().max()) <= 1e-6 * float(ref.abs().max())
    err1, err3 = rel_err(one_pass(x, k), ref), rel_err(three_pass(x, k), ref)
    assert err1 > 10 * TOL
    assert err3 <= TOL / 10


def test_ordinary_inputs_do_not_tell_the_two_apart():
    """On the other card tests' inputs (zero-mean activations) a single TF32
    pass would already miss the 1e-4 limit, but only by a few times: the
    cancelling case is the one that separates the two by a wide margin."""
    x, k, _ = (torch.from_numpy(v) for v in conv_act_inputs(1, 64, 64, 16, 16, seed=3))
    ref = conv64(x, k)
    err1, err3 = rel_err(one_pass(x, k), ref), rel_err(three_pass(x, k), ref)
    assert err3 <= TOL / 10
    assert TOL < err1 < 10 * TOL
