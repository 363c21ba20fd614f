"""GPEN-variant StyleGAN2 generator (counterpart of nn/stylegan2_gpen.py),
NCHW. Its noise injection concatenates the weighted full-channel noise
(`NoiseConcat`), so the feature feeding each next conv and toRGB is twice
the conv's width (feat_multiplier 2); the channel table carries `narrow`.
No shipped config builds it.

Noise is explicit, as in nn/stylegan2.py: `make_noise` draws the per-layer
full-channel (B, C, H, W) list from a `torch.Generator`."""

import math

import torch
from torch import nn

from .layers import EqualLinear, FusedLeakyReLU
from .stylegan2 import STYLEGAN2_CHANNELS, ModulatedConv2d, ToRGB
from ..ops.modulated import pixel_norm


class NoiseConcat(nn.Module):
    """concat([image, weight * noise]) over channels; noise (B, C, H, W)
    like the image, weight init 0."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    @torch.no_grad()
    def init_params(self, g):
        self.weight.zero_()

    def forward(self, image, noise):
        return torch.cat([image, self.weight.to(image.dtype) * noise.to(image.dtype)], dim=1)


class StyledConvGPEN(nn.Module):
    """ModulatedConv2d -> concatenated noise -> FusedLeakyReLU (2 out_ch
    wide)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, style_dim=512, upsample=False,
                 blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim,
                                    upsample=upsample, blur_kernel=blur_kernel)
        self.noise = NoiseConcat()
        self.activate = FusedLeakyReLU(out_ch * 2)

    def forward(self, x, style, noise):
        return self.activate(self.noise(self.conv(x, style), noise))


class GPENGenerator(nn.Module):
    """forward(latent W+ (B, n_latent, style_dim), noise) -> (B, 3, size,
    size). Each StyledConv's output is out_ch * 2 wide (concat noise).
    isconcat=False is refused: JAX's GPEN fails on it at its first call
    (its added-noise weight is created outside setup), so it has no
    reference."""

    def __init__(self, size=256, style_dim=512, n_mlp=8, channel_multiplier=2, narrow=1.0,
                 isconcat=True, blur_kernel=(1, 3, 3, 1), lr_mlp=0.01):
        super().__init__()
        channels = STYLEGAN2_CHANNELS(channel_multiplier, narrow)
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.isconcat = isconcat
        mult = 2 if isconcat else 1
        self.style = nn.ModuleList(
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu")
            for _ in range(n_mlp))
        self.input = nn.Parameter(torch.empty(1, channels[4], 4, 4))
        self.conv1 = self.styled_conv(channels[4], channels[4], style_dim, False, blur_kernel)
        self.to_rgb1 = ToRGB(channels[4] * mult, style_dim)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        in_ch = channels[4]
        self.widths = [channels[4]]
        for i in range(3, self.log_size + 1):
            out_ch = channels[2 ** i]
            self.convs.append(self.styled_conv(in_ch * mult, out_ch, style_dim, True,
                                               blur_kernel))
            self.convs.append(self.styled_conv(out_ch * mult, out_ch, style_dim, False,
                                               blur_kernel))
            self.to_rgbs.append(ToRGB(out_ch * mult, style_dim))
            self.widths += [out_ch, out_ch]
            in_ch = out_ch

    def styled_conv(self, in_ch, out_ch, style_dim, upsample, blur_kernel):
        if not self.isconcat:
            raise NotImplementedError("GPENGenerator: isconcat=False has no working reference")
        return StyledConvGPEN(in_ch, out_ch, 3, style_dim, upsample=upsample,
                              blur_kernel=blur_kernel)

    @torch.no_grad()
    def init_params(self, g):
        self.input.copy_(torch.randn(self.input.shape, generator=g, device=self.input.device))

    def style_mlp(self, z):
        w = pixel_norm(z)
        for layer in self.style:
            w = layer(w)
        return w

    def noise_shapes(self, batch):
        """(B, C, H, W) of each layer's noise, C its conv's width: conv1 at
        4px, then two per stage at 8, 16, ... size px."""
        sizes = [4] + [2 ** (3 + j // 2) for j in range(self.num_layers - 1)]
        return [(batch, c, s, s) for c, s in zip(self.widths, sizes)]

    def make_noise(self, batch, generator=None, device=None):
        """Per-layer noise drawn in layer order from `generator`."""
        device = self.input.device if device is None else device
        return [torch.randn(s, generator=generator, device=device)
                for s in self.noise_shapes(batch)]

    def forward(self, latent, noise):
        out = self.input.to(latent.dtype).expand(latent.shape[0], -1, -1, -1)
        out = self.conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * idx](out, latent[:, i], noise[1 + 2 * idx])
            out = self.convs[2 * idx + 1](out, latent[:, i + 1], noise[2 + 2 * idx])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip
