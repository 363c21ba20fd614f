"""upfirdn2d: upsample -> pad -> FIR filter -> downsample, on NCHW tensors
(counterpart of ops/upfirdn2d.py).

Zero-insertion upsampling appends up-1 zeros after each sample, then the
input is padded (negative pads crop), correlated with the flipped kernel
(true convolution, one depthwise `conv2d`), and every `down`-th output is
kept starting at 0 -- the semantics of the JAX dilated-conv formulation.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import batch_invariant as bi


def make_kernel(k) -> np.ndarray:
    """Normalized 2-D FIR kernel from a 1-D or 2-D spec (a 1-D kernel becomes
    its outer product; the result sums to 1). Float32 numpy."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad=(0, 0)) -> torch.Tensor:
    """x: (N, C, H, W); kernel: (kh, kw) array (already gain-scaled);
    pad = (before, after) on both spatial axes."""
    n, c, h, w = x.shape
    pad0, pad1 = int(pad[0]), int(pad[1])
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, (max(pad0, 0), max(pad1, 0), max(pad0, 0), max(pad1, 0)))
    hh, ww = x.shape[2], x.shape[3]
    x = x[:, :, max(-pad0, 0):hh - max(-pad1, 0),
          max(-pad0, 0):ww - max(-pad1, 0)]
    k = np.asarray(kernel, dtype=np.float32)
    k = _flipped_kernel(k.tobytes(), k.shape, x.dtype, x.device)
    k = k[None, None].expand(c, 1, *k.shape)
    x = bi.conv2d(x, k, groups=c)
    if down > 1:
        x = x[:, :, ::down, ::down]
    return x


@lru_cache(maxsize=None)
def _flipped_kernel(data: bytes, shape, dtype, device) -> torch.Tensor:
    """The flipped FIR kernel as a tensor, uploaded once per device."""
    k = np.frombuffer(data, dtype=np.float32).reshape(shape)[::-1, ::-1]
    return torch.tensor(k.copy(), dtype=dtype, device=device)


def _resample_pads(k_len: int, factor: int):
    p = k_len - factor
    return (p + 1) // 2 + factor - 1, p // 2


def upsample2x(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """FIR upsample; `kernel` is the normalized 2-D kernel, the gain
    factor**2 is applied here."""
    pad0, pad1 = _resample_pads(np.asarray(kernel).shape[0], factor)
    return upfirdn2d(x, np.asarray(kernel) * (factor ** 2), up=factor,
                     pad=(pad0, pad1))


def blur(x: torch.Tensor, kernel, pad, upsample_factor: int = 1) -> torch.Tensor:
    """FIR blur (gain upsample_factor**2 when it follows an upsample)."""
    k = np.asarray(kernel)
    if upsample_factor > 1:
        k = k * (upsample_factor ** 2)
    return upfirdn2d(x, k, pad=pad)
