"""Style-modulated convolution by the scaled-input/scaled-output rewrite
(counterpart of ops/modulated.py):

    y[b] = conv(x[b] * s[b], scale * W) * d[b]
    d[b, o] = rsqrt((s[b]^2 . sum_k (scale * W)^2)[o] + 1e-8)

one convolution shared by the batch plus two per-channel scalings, the same
value as the per-sample demodulated weight. Weights are OIHW.
"""

import math

import torch

from . import batch_invariant as bi
from .upfirdn2d import blur as fir_blur


def pixel_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=dim, keepdim=True) + eps)


def equal_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None, lr_mul: float = 1.0) -> torch.Tensor:
    """y = x @ (weight * lr_mul / sqrt(in)).T + bias * lr_mul; weight is
    stored (out, in)."""
    scale = (1.0 / math.sqrt(weight.shape[1])) * lr_mul
    y = x @ (weight * scale).t()
    if bias is not None:
        y = y + bias * lr_mul
    return y


def demod_scale(weight_scaled: torch.Tensor,
                style_scale: torch.Tensor) -> torch.Tensor:
    """d[b, o] = rsqrt(sum_i s[b, i]^2 * sum_k w[o, i, k]^2 + 1e-8), in fp32.
    weight_scaled: (Cout, Cin, kh, kw), he scale applied; style_scale:
    (N, Cin). Returns (N, Cout)."""
    w2 = torch.sum(weight_scaled.float() ** 2, dim=(2, 3))      # (Cout, Cin)
    return torch.rsqrt(bi.matmul(style_scale.float() ** 2, w2.t()) + 1e-8)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     style_scale: torch.Tensor, demodulate: bool = True,
                     upsample: bool = False, blur_kernel=None) -> torch.Tensor:
    """x: (N, Cin, H, W); weight: (Cout, Cin, kh, kw), N(0, 1) init, the he
    scale is applied here; style_scale: (N, Cin). With `upsample` the conv
    is a stride-2 transposed conv followed by the FIR blur."""
    cout, cin, kh, kw = weight.shape
    w = weight * (1.0 / math.sqrt(cin * kh * kw))
    d = demod_scale(w, style_scale).to(x.dtype) if demodulate else None
    xm = x * style_scale.to(x.dtype)[:, :, None, None]
    w = w.to(x.dtype)
    if upsample:
        # stride-2 transposed conv, written as a forward conv of the
        # zero-stuffed input with the flipped kernel: cuDNN's deterministic
        # transposed-conv algorithms are slow, its forward ones are not
        factor = 2
        n, _, h, wd = xm.shape
        xz = xm.new_zeros(n, cin, factor * h - 1, factor * wd - 1)
        xz[:, :, ::factor, ::factor] = xm
        y = bi.conv2d(xz, w.flip(2, 3), padding=(kh - 1, kw - 1))
        p = (blur_kernel.shape[0] - factor) - (kh - 1)
        pad0 = (p + 1) // 2 + factor - 1
        pad1 = p // 2 + 1
        y = fir_blur(y, blur_kernel, pad=(pad0, pad1), upsample_factor=factor)
    else:
        y = bi.conv2d(xm, w, padding=kh // 2)
    if d is not None:
        y = y * d[:, :, None, None]
    return y
