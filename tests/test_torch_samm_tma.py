"""The layout of the bfloat16 SAMM conv kernel (csrc/tma_conv.cuh, B5's and
B2b's bfloat16 path) on the CPU: its repack pass's plain version
(`samm_conv.tma_operands`: NHWC input, tap-major weights, channels padded
with zeros to a multiple of 8), and the conv that the kernel computes from
those operands -- nine shifted NHWC windows with a zero halo, each against
one tap's (Co, Cp) weights -- against the plain versions of B5 and B2b at
ragged shapes. The kernel itself, and its repack pass, are held against
these on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest
import torch
import torch.nn.functional as F

from torch_inputs import conv_act_inputs

from ood_gan_inversion_tpu_torch.ops import alignnet, samm_conv

# (b, Ci, Co, H, W): odd Ci, Ci a multiple of 8, Co off the 128-channel
# block, H and W off the 32-column pixel tile
RAGGED = [(2, 37, 136, 19, 27), (1, 40, 136, 19, 27), (2, 36, 36, 19, 27), (1, 8, 8, 5, 6)]


def repacked_conv3x3(xr, wr):
    """What the kernel computes from its operands, in float64: out[b, co, y,
    x] = sum over dx, dy, ci of wr[dx, dy, co, ci] * xr[b, y + dy - 1, x + dx
    - 1, ci], zero outside the image (TMA's out-of-bounds fill)."""
    b, h, w, _ = xr.shape
    xp = F.pad(xr.double(), (0, 0, 1, 1, 1, 1))
    out = 0.0
    for dx in range(3):
        for dy in range(3):
            win = xp[:, dy:dy + h, dx:dx + w]
            out = out + torch.einsum("bhwc,oc->bohw", win, wr[dx, dy].double())
    return out


def operands(b, ci, co, h, w, dtype=torch.float64):
    x, k, alpha = (torch.from_numpy(v) for v in conv_act_inputs(b, ci, co, h, w, seed=ci + co))
    return x.to(dtype), k.to(dtype), alpha


@pytest.mark.parametrize("b,ci,co,h,w", RAGGED)
def test_tma_operands_layout(b, ci, co, h, w):
    """xr[b, y, x, c] = x[b, c, y, x] and wr[dx, dy, o, c] = k[o, c, dy, dx];
    the padded channels are zero; the channel count is a multiple of 8."""
    x, k, _ = operands(b, ci, co, h, w, torch.bfloat16)
    xr, wr = samm_conv.tma_operands(x, k)
    cp = samm_conv.tma_channels(ci)
    assert cp % 8 == 0 and ci <= cp < ci + 8
    assert xr.shape == (b, h, w, cp) and wr.shape == (3, 3, co, cp)
    assert xr.dtype == wr.dtype == torch.bfloat16 and xr.is_contiguous() and wr.is_contiguous()
    assert torch.equal(xr[..., :ci], x.permute(0, 2, 3, 1))
    for dx in range(3):
        for dy in range(3):
            assert torch.equal(wr[dx, dy, :, :ci], k[:, :, dy, dx])
    assert not xr[..., ci:].any() and not wr[..., ci:].any()
    xs, ws = samm_conv.tma_scratch(x, k)
    assert (xs.shape, ws.shape, xs.dtype, ws.dtype) == (xr.shape, wr.shape, xr.dtype, wr.dtype)


@pytest.mark.parametrize("b,ci,co,h,w", RAGGED)
def test_conv_from_repacked_operands_matches_b5(b, ci, co, h, w):
    """The conv rebuilt from the repacked operands is B5's plain version
    (act none) on the same operands, to float64 rounding."""
    x, k, _ = operands(b, ci, co, h, w)
    got = repacked_conv3x3(*samm_conv.tma_operands(x, k))
    ref = samm_conv.conv3x3_act_reference(x, k, None, "none")
    assert got.shape == ref.shape == (b, co, h, w)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("b,ci,co,h,w", [c for c in RAGGED if c[1] == c[2]])
def test_conv_from_repacked_operands_matches_b2b(b, ci, co, h, w):
    """... and B2b's y2 and its moments, sums of that conv over H, W; B2b's
    plain version returns them in float32, so within 1e-6 of max|ref|."""
    x, k, _ = operands(b, ci, co, h, w)
    got = repacked_conv3x3(*samm_conv.tma_operands(x, k))
    y2, part = alignnet.alignnet_conv2_reference(x, k)
    assert float((got - y2).abs().max()) <= 1e-6 * float(y2.abs().max())
    moments = torch.stack([got.sum((2, 3)), (got * got).sum((2, 3))], 1)
    for m in range(2):
        assert float((moments[:, m] - part[:, m]).abs().max()) <= \
            1e-6 * float(part[:, m].abs().max())
