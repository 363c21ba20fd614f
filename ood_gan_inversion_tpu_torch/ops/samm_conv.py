"""Pad-1 conv3x3 with a fused activation, the SAMM AlignNet hot conv
(counterpart of ops/pallas_kernels.py: `conv3x3_act`,
`conv3x3_act_reference`, `conv3x3_act_supported`), NCHW tensors and OIHW
kernels as everywhere in the port's SAMM.

`conv3x3_act` launches the hand-written CUDA kernel `csrc/samm_conv.cu` for
CUDA tensors and runs the plain version for CPU tensors; there is no
fallback between the two. `.launches` counts kernel launches. Operands are
float32 or bfloat16 (x and k alike), PReLU slopes float32; the kernel
multiplies on the tensor cores (float32 operands as three TF32 products,
hi*hi + hi*lo + lo*hi, for float32 accuracy), sums in float32 and writes
the output in x's dtype. Its backward (the Function `Conv3x3Act`)
differentiates the plain version, as JAX's custom_vjp does.
"""

import math

import torch

from . import batch_invariant as bi
from .cuda_call import activation, dispatch, entry, expect, launch, on_card, twin_function

SQRT2 = math.sqrt(2.0)
ACTS = {"none": 0, "prelu": 1, "lrelu": 2}
# the channel floor of the conv3x3_act path (as in JAX); tests lower it to
# run narrow widths through the kernel path
CONV_ACT_MIN_CHANNELS = 64


def conv3x3_act_reference(x, k, alpha, act: str = "prelu"):
    """The plain version: x (B, Ci, H, W), k (Co, Ci, 3, 3), alpha (Co,)
    PReLU slopes (read only for act="prelu"). Returns (B, Co, H, W) in
    x.dtype."""
    y = bi.conv2d(x, k.to(x.dtype), padding=1)
    if act == "prelu":
        return torch.where(y >= 0, y, alpha.to(y.dtype)[:, None, None] * y)
    if act == "lrelu":
        return SQRT2 * torch.where(y >= 0, y, 0.2 * y)
    return y


def conv3x3_act_supported(ci: int, co: int) -> bool:
    """Whether a ci -> co conv takes the kernel path. JAX also requires the
    whole (3, 3, Ci, Co) weight to fit in 3 MiB of TPU VMEM; the CUDA kernel
    streams the weight through shared memory in chunks, so the port keeps
    only the channel floor."""
    return ci >= CONV_ACT_MIN_CHANNELS and co >= CONV_ACT_MIN_CHANNELS


def _run(x, k, alpha, act):
    """B5's kernel for CUDA tensors, its plain version for CPU tensors."""
    operands = [x, k] + ([alpha] if act == "prelu" else [])
    if not on_card("conv3x3_act", operands):
        return conv3x3_act_reference(x, k, alpha, act)
    b, ci, h, w = x.shape
    co = k.shape[0]
    out = x.new_empty((b, co, h, w))
    launch(conv3x3_act, "conv3x3_act", entry("samm_conv", "ogi_conv3x3_act", 4, 7), x,
           x.data_ptr(), k.data_ptr(), alpha.data_ptr() if act == "prelu" else None,
           out.data_ptr(), b, h, w, ci, co, ACTS[act], activation(x, "conv3x3_act"))
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
