"""Deterministic resizing as two small matrix products on NCHW tensors
(counterpart of ops/resize.py): y = M_h @ x @ M_w^T with (out, in)
interpolation matrices built once in numpy."""

from functools import lru_cache

import numpy as np
import torch

from . import batch_invariant as bi


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch's bicubic, A=-0.75)."""
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
        np.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * a, 0.0),
    )


@lru_cache(maxsize=None)
def interp_matrix(in_size: int, out_size: int, method: str = "bilinear",
                  align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) row-stochastic resampling matrix, float32 numpy.
    'bilinear' is torch's half-pixel mapping with the negative coordinate
    clamped to 0; 'bicubic' torch's 4-tap Keys kernel with border-clamped
    taps; 'adaptive_avg' torch's AdaptiveAvgPool1d bins
    [floor(o * in / out), ceil((o + 1) * in / out))."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if method == "adaptive_avg":
        for o in range(out_size):
            lo = (o * in_size) // out_size
            hi = -((-(o + 1) * in_size) // out_size)
            m[o, lo:hi] = 1.0 / (hi - lo)
        return m.astype(np.float32)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = np.arange(out_size) * scale
    else:
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        if method == "bilinear":
            src = np.maximum(src, 0.0)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    rows = np.arange(out_size)
    if method == "bilinear":
        np.add.at(m, (rows, np.clip(i0, 0, in_size - 1)), 1.0 - frac)
        np.add.at(m, (rows, np.clip(i0 + 1, 0, in_size - 1)), frac)
    elif method == "bicubic":
        for tap in range(-1, 3):
            np.add.at(m, (rows, np.clip(i0 + tap, 0, in_size - 1)),
                      _cubic_weight(tap - frac))
    else:
        raise ValueError(f"unknown resize method {method!r}")
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def _matrix(in_size, out_size, method, align_corners, dtype, device):
    """interp_matrix as a tensor, uploaded once per device and dtype. Made
    outside inference mode whatever the caller's mode: a cached tensor made
    under `torch.inference_mode` (the engine's forward) could not be saved
    for a later backward (a train step of the same shapes)."""
    with torch.inference_mode(False):
        return torch.tensor(interp_matrix(in_size, out_size, method, align_corners),
                            dtype=dtype, device=device)


def _apply_separable(x: torch.Tensor, size, method: str,
                     align_corners: bool) -> torch.Tensor:
    (h, w), (oh, ow) = x.shape[-2:], size
    mh = _matrix(h, oh, method, align_corners, x.dtype, x.device)
    mw = _matrix(w, ow, method, align_corners, x.dtype, x.device)
    return bi.per_sample(lambda v: torch.matmul(torch.matmul(mh, v), mw.t()), x)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) on NCHW."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return _apply_separable(x, size, "bilinear", False)


def resize_bicubic_ac(x: torch.Tensor, size) -> torch.Tensor:
    """F.interpolate(mode='bicubic', align_corners=True) on NCHW."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return _apply_separable(x, size, "bicubic", True)


def adaptive_avg_pool(x: torch.Tensor, size) -> torch.Tensor:
    """F.adaptive_avg_pool2d on NCHW."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return _apply_separable(x, size, "adaptive_avg", False)
