"""StyleGAN2 synthesis network (counterpart of nn/stylegan2.py), NCHW.

Stages below 512px run unpacked, as the plain StyledConv / ToRGB chain.
With `packed_tail` the >=512px stages run phase-packed at their coarse
(input) resolution (`Generator.packed_stage`, the ops/polyphase.py
algebra): the same linear algebra, with conv2's packed kernel dense (4x the
MACs of the unpacked conv). `tail_kernel` picks how a packed stage is
computed: "none" (plain PyTorch), "pair" (the fused packed conv kernel,
twice) or "stage" (the whole-stage kernel). Off by default: on the H100 in
float32 the unpacked tail does fewer MACs. The style MLP is not on the
inversion path and is not ported yet.

Noise is explicit: `make_noise` draws the per-layer (B, 1, H, W) noise list
from a `torch.Generator`, and the decode functions take that list.
"""

import math

import torch
from torch import nn

from ..ops.fused_act import fused_leaky_relu
from ..ops.modulated import demod_scale, modulated_conv2d
from ..ops.packed_conv import fused_packed_pair, fused_packed_stage
from ..ops.polyphase import (conv1x1_packed_kernel, conv3x3_packed_kernel,
                             conv_packed, pack_space_to_depth,
                             skip_up_packed_kernel, tile_phase_major,
                             unpack_depth_to_space, upconv_blur_packed_kernel)
from ..ops.upfirdn2d import make_kernel, upsample2x
from .layers import EqualLinear, FusedLeakyReLU

# stages whose output is at least this many pixels wide run packed
_PACKED_MIN_RES = 512
TAIL_KERNELS = ("none", "pair", "stage")


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
    """image + weight * noise; noise (B, 1, H, W), weight init 0. Weight
    and noise are cast to the image's dtype first, so a bfloat16 image
    stays bfloat16 (JAX draws the noise in the image's dtype)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    @torch.no_grad()
    def init_params(self, g):
        self.weight.zero_()

    def forward(self, image, noise):
        return image + self.weight.to(image.dtype) * noise.to(image.dtype)


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
    style_dim) to (B, 3, size, size). packed_tail / tail_kernel: see the
    module docstring (the JAX flags OGI_PACKED_TAIL and OGI_PALLAS /
    OGI_PALLAS_STAGE)."""

    def __init__(self, size=1024, style_dim=512, channel_multiplier=2,
                 narrow=1.0, blur_kernel=(1, 3, 3, 1), packed_tail=False,
                 tail_kernel="none"):
        super().__init__()
        if tail_kernel not in TAIL_KERNELS:
            raise ValueError(f"tail_kernel {tail_kernel!r} not in {TAIL_KERNELS}")
        if tail_kernel != "none" and not packed_tail:
            raise ValueError(f"tail_kernel={tail_kernel!r} needs packed_tail=True")
        self.packed_tail, self.tail_kernel = packed_tail, tail_kernel
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

    def stage_is_packable(self, idx: int) -> bool:
        """With packed_tail, a stage runs packed when its output is >= 512px
        and it starts with a 3x3 upsampling conv."""
        conv = self.convs[2 * idx].conv
        return (self.packed_tail and 2 ** (idx + 3) >= _PACKED_MIN_RES
                and conv.weight.shape[-1] == 3 and conv.upsample)

    def packed_stage(self, idx, out, skip, l0, l1, l2, noise_a, noise_b,
                     unpack_out=True):
        """convs[2 idx] -> convs[2 idx + 1] -> to_rgbs[idx], computed
        phase-packed at the coarse resolution.

        out (B, Cin, H, W) and skip (B, 3, H, W) coarse; l0, l1, l2 the
        three styles; noise_a, noise_b the fine (B, 1, 2H, 2W) noise.
        Returns (out (B, Cmid, 2H, 2W), or the packed NHWC z2 (B, H, W,
        4 Cmid) when not unpack_out; skip (B, 3, 2H, 2W)); both NCHW views
        of NHWC tensors, so the next packed stage reads its input in place.
        """
        conv_a, conv_b, to_rgb = self.convs[2 * idx], self.convs[2 * idx + 1], self.to_rgbs[idx]
        ca, cb, cr = conv_a.conv, conv_b.conv, to_rgb.conv
        b, cin, h, w = out.shape
        cmid = ca.weight.shape[0]
        dt = out.dtype
        x = out.permute(0, 2, 3, 1).contiguous()
        skip = skip.permute(0, 2, 3, 1).contiguous()

        def packed_noise(noise, injection):
            n = pack_space_to_depth(noise.float().permute(0, 2, 3, 1))
            return n * injection.weight.float()

        def hwio(weight):
            return weight.permute(2, 3, 1, 0)

        n_a, n_b = packed_noise(noise_a, conv_a.noise), packed_noise(noise_b, conv_b.noise)
        # conv_a: modulated upsample-conv + FIR blur as one packed 3x3 conv.
        # The style scales go to the kernels in float32, as their other
        # per-channel operands: exact for bfloat16 latents, and each use
        # below rounds them to dt again where JAX does.
        s_a = ca.modulation(l0).float()
        w_a = ca.weight * (1.0 / math.sqrt(cin * 9))
        d_a = tile_phase_major(demod_scale(w_a, s_a))
        k1 = upconv_blur_packed_kernel(hwio(w_a), ca.blur_kernel).to(dt)
        # conv_b: same-resolution modulated 3x3, packed 4C -> 4C
        s_b = cb.modulation(l1).float()
        w_b = cb.weight * (1.0 / math.sqrt(cmid * 9))
        s_b, d_b = tile_phase_major(s_b), tile_phase_major(demod_scale(w_b, s_b))
        k2 = conv3x3_packed_kernel(hwio(w_b)).to(dt)
        b_a = tile_phase_major(conv_a.activate.bias)
        b_b = tile_phase_major(conv_b.activate.bias)
        # to_rgb (1x1, no demod) and the packed FIR upsample of the skip
        s_r = tile_phase_major(cr.modulation(l2).float())
        k3 = conv1x1_packed_kernel(hwio(cr.weight * (1.0 / math.sqrt(cmid))))[0, 0]
        b_r = tile_phase_major(to_rgb.bias)
        k4 = skip_up_packed_kernel(to_rgb.blur_kernel, 3, dt, out.device)

        if self.tail_kernel == "stage":
            k3sr = (s_r[:, :, None] * k3[None]).to(dt)
            rgb, z2 = fused_packed_stage(x, n_a, n_b, skip, k1, s_a, d_a, b_a,
                                         k2, s_b, d_b, b_b, k3sr, b_r, k4)
        else:
            if self.tail_kernel == "pair":
                z2 = fused_packed_pair(x, n_a, n_b, k1, s_a, d_a, b_a, k2, s_b, d_b, b_b)
            else:
                def add_noise_lrelu(z, n_packed, bias):
                    z = (z.reshape(b, h, w, 4, -1) + n_packed.to(dt)[..., None]
                         ).reshape(b, h, w, -1)
                    return fused_leaky_relu(z.permute(0, 3, 1, 2), bias).permute(0, 2, 3, 1)

                z = conv_packed(x * s_a[:, None, None, :].to(dt), k1)
                z = add_noise_lrelu(z * d_a.to(dt)[:, None, None, :], n_a, b_a)
                z2 = conv_packed(z * s_b.to(dt)[:, None, None, :], k2)
                z2 = add_noise_lrelu(z2 * d_b.to(dt)[:, None, None, :], n_b, b_b)
            rgb = conv_packed(z2 * s_r.to(dt)[:, None, None, :], k3[None, None].to(dt),
                              padding=0)
            rgb = rgb + b_r.to(dt) + conv_packed(skip, k4)
        skip_fine = unpack_depth_to_space(rgb, 3).permute(0, 3, 1, 2)
        if not unpack_out:
            return z2, skip_fine
        return unpack_depth_to_space(z2, cmid).permute(0, 3, 1, 2), skip_fine

    def forward(self, latent, noise):
        """Plain (unconditioned) decode; noise from make_noise."""
        out = self.conv1(self.const_input(latent.shape[0], latent.dtype),
                         latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            if self.stage_is_packable(idx):
                out, skip = self.packed_stage(
                    idx, out, skip, latent[:, i], latent[:, i + 1], latent[:, i + 2],
                    noise[1 + 2 * idx], noise[2 + 2 * idx],
                    unpack_out=idx < len(self.to_rgbs) - 1)
            else:
                out = self.convs[2 * idx](out, latent[:, i], noise[1 + 2 * idx])
                out = self.convs[2 * idx + 1](out, latent[:, i + 1], noise[2 + 2 * idx])
                skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip
