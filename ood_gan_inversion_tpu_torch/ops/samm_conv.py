"""Pad-1 conv3x3 with a fused activation, the SAMM AlignNet hot conv
(counterpart of ops/pallas_kernels.py: `conv3x3_act`,
`conv3x3_act_reference`, `conv3x3_act_supported`), NCHW tensors and OIHW
kernels as everywhere in the port's SAMM.

`conv3x3_act` launches the hand-written CUDA kernel `csrc/samm_conv.cu` for
CUDA tensors and runs the plain version for CPU tensors; there is no
fallback between the two. `.launches` counts wrapper calls that launched
the kernel. Operands are float32 or bfloat16 (x and k alike), PReLU slopes
float32; the kernel multiplies on the tensor cores, sums in float32 and
writes the output in x's dtype. Both dtypes run the TMA kernel of
csrc/tma_conv.cuh after a repack pass into NHWC input and tap-major
weights at every call (two launches; `tma_operands` is the pass's plain
version, `tma_scratch` its scratch): bfloat16 as one pass, float32 as three
TF32 products (lo*hi + hi*lo + hi*hi, for float32 accuracy), each operand
split into its hi and lo words once, in the repack pass.

Two plain versions: `conv3x3_act_kernel_reference` is the kernel's
function (the conv of the operands widened to float32, the activation in
float32, one rounding to x's dtype, as JAX's Pallas kernel computes it) and
is what the wrapper runs for CPU tensors; `conv3x3_act_reference` computes
in x's dtype throughout, as JAX's XLA oracle does, and is what the backward
(the Function `Conv3x3Act`) differentiates, as JAX's custom_vjp does. On
float32 operands the two are the same ops, bit for bit.
"""

import math

import torch
import torch.nn.functional as F

from . import batch_invariant as bi
from .cuda_call import activation, dispatch, entry, expect, launch, on_card, twin_function, widen

SQRT2 = math.sqrt(2.0)
ACTS = {"none": 0, "prelu": 1, "lrelu": 2}
# the channel floor of the conv3x3_act path (as in JAX); tests lower it to
# run narrow widths through the kernel path
CONV_ACT_MIN_CHANNELS = 64
# the TMA kernel's channel granules: its NHWC / tap-major copies are padded
# with zero channels to a multiple of 8 in bfloat16 (a TMA stride is a
# multiple of 16 bytes) and of 16 in float32 (one 128-byte row of the
# kernel's K-blocks holds 16 channels' hi and lo words)
TMA_CHANNELS = 8
TF32_CHANNELS = 16


def _activate(y, alpha, act):
    if act == "prelu":
        return torch.where(y >= 0, y, alpha.to(y.dtype)[:, None, None] * y)
    if act == "lrelu":
        return SQRT2 * torch.where(y >= 0, y, 0.2 * y)
    return y


def conv3x3_act_reference(x, k, alpha, act: str = "prelu"):
    """The plain version that the backward differentiates: x (B, Ci, H, W),
    k (Co, Ci, 3, 3), alpha (Co,) PReLU slopes (read only for act="prelu").
    Returns (B, Co, H, W) in x.dtype, every step in x.dtype."""
    return _activate(bi.conv2d(x, k.to(x.dtype), padding=1), alpha, act)


def conv3x3_act_kernel_reference(x, k, alpha, act: str = "prelu"):
    """The kernel's function, arguments as conv3x3_act_reference: the conv
    of x and k widened to float32 (bfloat16 products are exact there),
    the activation in float32, the slopes unrounded, one rounding to
    x.dtype."""
    xw = widen(x)
    return _activate(bi.conv2d(xw, k.to(xw.dtype), padding=1), alpha, act).to(x.dtype)


def conv3x3_act_supported(ci: int, co: int) -> bool:
    """Whether a ci -> co conv takes the kernel path. JAX also requires the
    whole (3, 3, Ci, Co) weight to fit in 3 MiB of TPU VMEM; the CUDA kernel
    streams the weight through shared memory in chunks, so the port keeps
    only the channel floor."""
    return ci >= CONV_ACT_MIN_CHANNELS and co >= CONV_ACT_MIN_CHANNELS


def tma_channels(c: int, dtype=torch.bfloat16) -> int:
    """c rounded up to a multiple of the TMA kernel's granule for operands
    of `dtype`: TF32_CHANNELS for float32, else TMA_CHANNELS."""
    g = TF32_CHANNELS if dtype == torch.float32 else TMA_CHANNELS
    return -(-c // g) * g


def split_tf32(v):
    """(hi, lo) of float32 v as the kernels split it (csrc/tma_conv.cuh:
    split_tf32): hi = v rounded to TF32, a 10-bit mantissa, half away from
    zero (2^12 added to the bit pattern, the low 13 bits cleared); lo = v -
    hi, exact in float32, so hi + lo == v."""
    u = v.contiguous().view(torch.int32)
    hi = ((u + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, v - hi


def tf32_words(v, cp):
    """v (..., C) float32 as the float32 kernel's rows (..., 2 cp): for each
    group of TF32_CHANNELS channels, their hi words, then their lo words
    (split_tf32); the channels past C zero in both."""
    hi, lo = split_tf32(F.pad(v, (0, cp - v.shape[-1])))
    groups = hi.shape[:-1] + (cp // TF32_CHANNELS, 1, TF32_CHANNELS)
    return torch.cat([hi.reshape(groups), lo.reshape(groups)], -2).reshape(*hi.shape[:-1], 2 * cp)


def tma_rows(v):
    """v (..., C) as rows of the TMA kernel's operands: float32 as
    tf32_words (Cp = tma_channels(C, float32), 2 Cp words a row), the values
    split once; any other dtype (the bfloat16 kernel's) as it lies, Cp =
    tma_channels(C) channels. The channels past C are zero."""
    cp = tma_channels(v.shape[-1], v.dtype)
    if v.dtype == torch.float32:
        return tf32_words(v, cp)
    return F.pad(v, (0, cp - v.shape[-1])).contiguous()


def tma_row_len(c, dtype):
    """The elements of a tma_rows row of c channels of `dtype`."""
    return tma_channels(c, dtype) * (2 if dtype == torch.float32 else 1)


def tma_operands(x, k):
    """The operands of the TMA kernel (csrc/tma_conv.cuh) from x (B, C, H, W)
    and k (Co, C, 3, 3): x as NHWC (B, H, W, .) and k as (3, 3, Co, .)
    indexed [dx, dy, co, .], so that [dx, dy] = k[:, :, dy, dx], each channel
    row as tma_rows. The plain version of the kernel's repack pass
    (tma_conv.cuh:repack_kernel, repack_tf32_kernel)."""
    return tma_rows(x.permute(0, 2, 3, 1)), tma_rows(k.permute(3, 2, 0, 1))


def tma_scratch(x, k):
    """Uninitialised tensors of tma_operands' shapes for the input of x's
    batch and image size and the weights k (Co, Ci, 3, 3), which the repack
    pass fills."""
    b, _, h, w = x.shape
    n = tma_row_len(k.shape[1], x.dtype)
    return x.new_empty((b, h, w, n)), k.new_empty((3, 3, k.shape[0], n))


def _run(x, k, alpha, act):
    """B5's kernel for CUDA tensors, its plain version for CPU tensors."""
    operands = [x, k] + ([alpha] if act == "prelu" else [])
    if not on_card("conv3x3_act", operands):
        return conv3x3_act_kernel_reference(x, k, alpha, act)
    b, ci, h, w = x.shape
    co = k.shape[0]
    out = x.new_empty((b, co, h, w))
    slopes = alpha.data_ptr() if act == "prelu" else None
    xr, wr = tma_scratch(x, k)
    name = "ogi_conv3x3_act_tma" if x.dtype == torch.bfloat16 else "ogi_conv3x3_act"
    launch(conv3x3_act, "conv3x3_act", entry("samm_conv", name, 6, 6), x,
           x.data_ptr(), k.data_ptr(), xr.data_ptr(), wr.data_ptr(), slopes, out.data_ptr(),
           b, h, w, ci, co, ACTS[act])
    return out


Conv3x3Act = twin_function("Conv3x3Act", _run, conv3x3_act_reference)


def conv3x3_act(x, k, alpha=None, act: str = "prelu"):
    """act(conv3x3(x, k)), zero padding 1 (B5). x (B, Ci, H, W) float32 or
    bfloat16; k (Co, Ci, 3, 3) in x.dtype; alpha (Co,) float32 PReLU slopes,
    needed for act="prelu" only; act in "prelu", "lrelu" (lrelu(0.2) *
    sqrt(2)), "none". Returns (B, Co, H, W) in x.dtype. Unlike JAX's kernel,
    it takes weights of any size (the 2C = 1024 SAMM scales included):
    conv3x3_act_supported keeps only JAX's channel floor."""
    if act not in ACTS:
        raise ValueError(f"act {act!r} not in {tuple(ACTS)}")
    activation(x, "conv3x3_act")
    co, ci = k.shape[0], x.shape[1]
    expect("k", k, (co, ci, 3, 3), x.dtype)
    if act == "prelu":
        expect("alpha", alpha, (co,), torch.float32)
    else:
        alpha = None
    return dispatch(Conv3x3Act, x, k, alpha, act)


conv3x3_act.launches = 0
