"""Bias + LeakyReLU + sqrt(2) gain (counterpart of ops/fused_act.py)."""

import math

import torch

SQRT2 = math.sqrt(2.0)


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(C,) -> broadcastable over the channel axis (dim 1) of an ndim tensor."""
    return v.reshape((1, -1) + (1,) * (ndim - 2))


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2,
                     scale: float = SQRT2) -> torch.Tensor:
    """scale * leaky_relu(x + bias); bias broadcasts over dim 1 of an NCHW or
    (N, C) tensor."""
    if bias is not None:
        x = x + _channel_view(bias.to(x.dtype), x.ndim)
    return scale * torch.where(x >= 0, x, negative_slope * x)
