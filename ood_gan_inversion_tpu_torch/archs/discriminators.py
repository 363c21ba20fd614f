"""Discriminator archs (counterpart of archs/discriminators.py)."""

import torch
from torch import nn

from ..nn.layers import EqualLinear
from ..nn.stylegan2 import Discriminator


class StyleGAN2DiscriminatorMod(nn.Module):
    """Image discriminator: forward(x NHWC) -> (score (B, 1), features)."""

    def __init__(self, out_size=1024, channel_multiplier=2,
                 resample_kernel=(1, 3, 3, 1), stddev_group=4, narrow=1.0,
                 dtype=torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError(f"ported discriminator dtype: float32; got {dtype}")
        self.d = Discriminator(out_size, channel_multiplier, tuple(resample_kernel),
                               stddev_group, narrow=narrow)

    def forward(self, x):
        return self.d(x)


class LatentDiscriminator(nn.Module):
    """MLP over W+ (B, chn, dim): each of the dim columns projected chn ->
    hidden_chn, flattened (hidden_chn-major), then n_mlp + 1 fused-lrelu
    layers and a scalar score. forward returns (score (B, 1), None)."""

    def __init__(self, chn=18, dim=512, n_mlp=8, hidden_chn=4, dtype=torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError(f"ported discriminator dtype: float32; got {dtype}")
        self.hidden_chn = hidden_chn
        self.first_linear = EqualLinear(chn, hidden_chn, activation="fused_lrelu")
        self.layer = nn.ModuleList(
            EqualLinear(hidden_chn * dim if i == 0 else dim, dim, activation="fused_lrelu")
            for i in range(n_mlp + 1))
        self.final_linear = EqualLinear(dim, 1)

    def forward(self, x):
        b, c, n = x.shape
        h = self.first_linear(x.transpose(1, 2).reshape(-1, c))     # (B * dim, hidden)
        h = h.reshape(b, n, self.hidden_chn).transpose(1, 2).reshape(b, -1)
        for layer in self.layer:
            h = layer(h)
        return self.final_linear(h), None
