"""StyleGAN2 synthesis network (counterpart of nn/stylegan2.py), NCHW.

Every stage runs unpacked, as the plain StyledConv / ToRGB chain: the JAX
package's phase-packed >=512px stages (`Generator.packed_stage`) are the same
linear algebra arranged for the TPU's 128-lane matrix unit, and arrive here
with their kernels in a later slice. The style MLP is not on the inversion
path and is not ported yet.

Noise is explicit: `make_noise` draws the per-layer (B, 1, H, W) noise list
from a `torch.Generator`, and the decode functions take that list.
"""

import math

import torch
from torch import nn

from ..ops.modulated import modulated_conv2d
from ..ops.upfirdn2d import make_kernel, upsample2x
from .layers import EqualLinear, FusedLeakyReLU


def STYLEGAN2_CHANNELS(channel_multiplier: int = 2, narrow: float = 1.0):
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow),
        64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
        2048: int(8 * channel_multiplier * narrow),
    }


class ModulatedConv2d(nn.Module):
    """weight (out, in, k, k) N(0, 1); modulation EqualLinear, bias 1."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim=512,
                 demodulate=True, upsample=False, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.demodulate, self.upsample = demodulate, upsample
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0)
        self.blur_kernel = make_kernel(blur_kernel)

    @torch.no_grad()
    def init_params(self, g):
        self.weight.copy_(torch.randn(self.weight.shape, generator=g,
                                      device=self.weight.device))

    def forward(self, x, style):
        return modulated_conv2d(x, self.weight, self.modulation(style),
                                demodulate=self.demodulate,
                                upsample=self.upsample,
                                blur_kernel=self.blur_kernel)


class NoiseInjection(nn.Module):
    """image + weight * noise; noise (B, 1, H, W), weight init 0."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    @torch.no_grad()
    def init_params(self, g):
        self.weight.zero_()

    def forward(self, image, noise):
        return image + self.weight.to(image.dtype) * noise


class StyledConv(nn.Module):
    """ModulatedConv2d -> NoiseInjection -> FusedLeakyReLU. The submodules
    are called one by one where SAMM sits between the conv and the noise."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim=512,
                 upsample=False, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim,
                                    upsample=upsample, blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)

    def forward(self, x, style, noise):
        return self.activate(self.noise(self.conv(x, style), noise))


class ToRGB(nn.Module):
    def __init__(self, in_ch, style_dim=512, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(3))
        self.blur_kernel = make_kernel(blur_kernel)

    @torch.no_grad()
    def init_params(self, g):
        self.bias.zero_()

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias.to(x.dtype)[:, None, None]
        if skip is not None:
            out = out + upsample2x(skip, self.blur_kernel)
        return out


class Generator(nn.Module):
    """StyleGAN2 synthesis: forward(latent) decodes W+ (B, n_latent,
    style_dim) to (B, 3, size, size)."""

    def __init__(self, size=1024, style_dim=512, channel_multiplier=2,
                 narrow=1.0, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        channels = STYLEGAN2_CHANNELS(channel_multiplier, narrow)
        self.size = size
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2
        self.input = nn.Parameter(torch.empty(1, channels[4], 4, 4))
        self.conv1 = StyledConv(channels[4], channels[4], 3, style_dim,
                                blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(channels[4], style_dim)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        in_ch = channels[4]
        for i in range(3, self.log_size + 1):
            out_ch = channels[2 ** i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim,
                                         upsample=True, blur_kernel=blur_kernel))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim,
                                         blur_kernel=blur_kernel))
            self.to_rgbs.append(ToRGB(out_ch, style_dim))
            in_ch = out_ch

    @torch.no_grad()
    def init_params(self, g):
        self.input.copy_(torch.randn(self.input.shape, generator=g,
                                     device=self.input.device))

    def noise_shapes(self, batch):
        """(B, 1, H, W) shape of each layer's noise: conv1 at 4px, then two
        per stage at 8, 16, ... size px."""
        sizes = [4] + [2 ** (3 + j // 2) for j in range(self.num_layers - 1)]
        return [(batch, 1, s, s) for s in sizes]

    def make_noise(self, batch, generator=None, device=None):
        """Per-layer noise drawn in layer order from `generator`."""
        device = self.input.device if device is None else device
        return [torch.randn(s, generator=generator, device=device)
                for s in self.noise_shapes(batch)]

    def const_input(self, batch, dtype):
        return self.input.to(dtype).expand(batch, -1, -1, -1)

    def forward(self, latent, noise):
        """Plain (unconditioned) decode; noise from make_noise."""
        out = self.conv1(self.const_input(latent.shape[0], latent.dtype),
                         latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * idx](out, latent[:, i], noise[1 + 2 * idx])
            out = self.convs[2 * idx + 1](out, latent[:, i + 1], noise[2 + 2 * idx])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip
