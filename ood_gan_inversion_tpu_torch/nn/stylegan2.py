"""StyleGAN2 synthesis network (counterpart of nn/stylegan2.py), NCHW.

Stages below 512px run unpacked, as the plain StyledConv / ToRGB chain.
With `packed_tail` the >=512px stages run phase-packed at their coarse
(input) resolution (`Generator.packed_stage`, the ops/polyphase.py
algebra): the same linear algebra, with conv2's packed kernel dense (4x the
MACs of the unpacked conv). `tail_kernel` picks how a packed stage is
computed: "none" (plain PyTorch), "pair" (the fused packed conv kernel,
twice) or "stage" (the whole-stage kernel). Off by default: on the H100 in
float32 the unpacked tail does fewer MACs. `packed_operands` makes a packed
stage's row-independent operands and `packed_rows` computes it on rows, so
that parallel/spatial.py can run it banded. The style MLP (`style_mlp`, z ->
W) is not on the inversion path; training draws the latent
discriminator's real latents from it. `Discriminator` is the StyleGAN2
image discriminator.

Noise is explicit: `make_noise` draws the per-layer (B, 1, H, W) noise list
from a `torch.Generator`, and the decode functions take that list.
"""

import math

import torch
from torch import nn

from ..ops.fused_act import fused_leaky_relu
from ..ops.modulated import demod_scale, modulated_conv2d, pixel_norm
from ..ops.packed_conv import fused_packed_pair, fused_packed_stage
from ..ops.polyphase import (conv1x1_packed_kernel, conv3x3_packed_kernel,
                             conv_packed, pack_space_to_depth,
                             skip_up_packed_kernel, tile_phase_major,
                             unpack_depth_to_space, upconv_blur_packed_kernel)
from ..ops.stats import minibatch_stddev
from ..ops.upfirdn2d import make_kernel, upsample2x
from ..parallel import spatial
from ..utils import trace
from .layers import ConvLayer, EqualLinear, FusedLeakyReLU, ResBlock

# stages whose output is at least this many pixels wide run packed
_PACKED_MIN_RES = 512
TAIL_KERNELS = ("none", "pair", "stage")
# the span of each decode stage, by index: 0 is conv1 + to_rgb1 (4px),
# 1 + idx the stage of to_rgbs[idx] (2 ** (idx + 3) px)
DECODE_SPANS = tuple(f"decode.{2 ** k}" for k in range(2, 12))


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
    OGI_PALLAS_STAGE). n_mlp: the style MLP's depth (its layers' learning
    rate multiplier is 0.01)."""

    def __init__(self, size=1024, style_dim=512, channel_multiplier=2,
                 narrow=1.0, blur_kernel=(1, 3, 3, 1), packed_tail=False,
                 tail_kernel="none", n_mlp=8):
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
        # registered last, so that init_weights draws the synthesis weights
        # as it did before the style MLP was ported
        self.style = nn.ModuleList(
            EqualLinear(style_dim, style_dim, lr_mul=0.01, activation="fused_lrelu")
            for _ in range(n_mlp))

    @torch.no_grad()
    def init_params(self, g):
        self.input.copy_(torch.randn(self.input.shape, generator=g,
                                     device=self.input.device))

    def style_mlp(self, z):
        """W = MLP(pixel_norm(z)), z (B, style_dim)."""
        w = pixel_norm(z)
        for layer in self.style:
            w = layer(w)
        return w

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
        ops = self.packed_operands(idx, l0, l1, l2, out.dtype)
        rgb, z2 = self.packed_rows(ops, out.permute(0, 2, 3, 1).contiguous(),
                                   skip.permute(0, 2, 3, 1).contiguous(), noise_a, noise_b)
        if not unpack_out:
            return z2, self.unpack(rgb, 3)
        return self.unpack(z2, self.convs[2 * idx].conv.weight.shape[0]), self.unpack(rgb, 3)

    @staticmethod
    def unpack(packed, c):
        """A packed NHWC (B, H, W, 4c) tensor as the NCHW view (B, c, 2H,
        2W) of its unpacked NHWC."""
        return unpack_depth_to_space(packed, c).permute(0, 3, 1, 2)

    def packed_operands(self, idx, l0, l1, l2, dt):
        """The operands of stage idx's packed computation that do not depend
        on rows: the style scales, demodulations, biases and noise
        strengths (float32) and the packed kernels (in dt, the activations'
        dtype), as the dict packed_rows takes."""
        conv_a, conv_b, to_rgb = self.convs[2 * idx], self.convs[2 * idx + 1], self.to_rgbs[idx]
        ca, cb, cr = conv_a.conv, conv_b.conv, to_rgb.conv
        cmid, cin = ca.weight.shape[:2]

        def hwio(weight):
            return weight.permute(2, 3, 1, 0)

        # conv_a: modulated upsample-conv + FIR blur as one packed 3x3 conv.
        # The style scales go to the kernels in float32, as their other
        # per-channel operands: exact for bfloat16 latents, and each use
        # in packed_rows rounds them to dt again where JAX does.
        s_a = ca.modulation(l0).float()
        w_a = ca.weight * (1.0 / math.sqrt(cin * 9))
        # conv_b: same-resolution modulated 3x3, packed 4C -> 4C
        s_b = cb.modulation(l1).float()
        w_b = cb.weight * (1.0 / math.sqrt(cmid * 9))
        ops = {"s_a": s_a, "d_a": tile_phase_major(demod_scale(w_a, s_a)),
               "k1": upconv_blur_packed_kernel(hwio(w_a), ca.blur_kernel).to(dt),
               "s_b": tile_phase_major(s_b), "d_b": tile_phase_major(demod_scale(w_b, s_b)),
               "k2": conv3x3_packed_kernel(hwio(w_b)).to(dt),
               "b_a": tile_phase_major(conv_a.activate.bias),
               "b_b": tile_phase_major(conv_b.activate.bias),
               "n_a": conv_a.noise.weight.float(), "n_b": conv_b.noise.weight.float(),
               # to_rgb (1x1, no demod) and the packed FIR upsample of the skip
               "s_r": tile_phase_major(cr.modulation(l2).float()),
               "k3": conv1x1_packed_kernel(hwio(cr.weight * (1.0 / math.sqrt(cmid))))[0, 0],
               "b_r": tile_phase_major(to_rgb.bias),
               "k4": skip_up_packed_kernel(to_rgb.blur_kernel, 3, dt, l0.device)}
        return ops

    def packed_rows(self, ops, x, skip, noise_a, noise_b):
        """The packed stage on rows: x (B, h, W, Cin) and skip (B, h, W, 3)
        NHWC coarse, noise_a / noise_b their fine (B, 1, 2h, 2W) rows, ops
        from packed_operands. Zero padding at the rows' border, as at the
        image's. Returns (rgb (B, h, W, 12), z2 (B, h, W, 4 Cmid)), packed,
        through tail_kernel's route."""
        b, h, w, _ = x.shape
        dt = x.dtype

        def packed_noise(noise, strength):
            return pack_space_to_depth(noise.float().permute(0, 2, 3, 1)) * strength

        n_a, n_b = packed_noise(noise_a, ops["n_a"]), packed_noise(noise_b, ops["n_b"])
        s_a, d_a, k1, b_a = ops["s_a"], ops["d_a"], ops["k1"], ops["b_a"]
        s_b, d_b, k2, b_b = ops["s_b"], ops["d_b"], ops["k2"], ops["b_b"]
        s_r, k3, b_r, k4 = ops["s_r"], ops["k3"], ops["b_r"], ops["k4"]
        if self.tail_kernel == "stage":
            k3sr = (s_r[:, :, None] * k3[None]).to(dt)
            return fused_packed_stage(x, n_a, n_b, skip, k1, s_a, d_a, b_a,
                                      k2, s_b, d_b, b_b, k3sr, b_r, k4)
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
        return rgb + b_r.to(dt) + conv_packed(skip, k4), z2

    def forward(self, latent, noise):
        """Plain (unconditioned) decode; noise from make_noise."""
        b = latent.shape[0]
        with trace.span(DECODE_SPANS[0], b):
            out = self.conv1(self.const_input(b, latent.dtype), latent[:, 0], noise[0])
            skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            with trace.span(DECODE_SPANS[idx + 1], b):
                if spatial.banded(out, False):
                    out, skip = spatial.banded_stage(
                        self, idx, out, skip, latent[:, i], latent[:, i + 1],
                        latent[:, i + 2], noise[1 + 2 * idx], noise[2 + 2 * idx])
                elif self.stage_is_packable(idx):
                    out, skip = self.packed_stage(
                        idx, out, skip, latent[:, i], latent[:, i + 1], latent[:, i + 2],
                        noise[1 + 2 * idx], noise[2 + 2 * idx],
                        unpack_out=idx < len(self.to_rgbs) - 1)
                else:
                    out = self.convs[2 * idx](out, latent[:, i], noise[1 + 2 * idx])
                    out = self.convs[2 * idx + 1](out, latent[:, i + 1], noise[2 + 2 * idx])
                    skip = to_rgb(out, latent[:, i + 2], skip)
                # banding anchor (parallel/spatial.py; nothing outside its
                # banding context): the >= min_h stages' outputs are H-banded
                out, skip = spatial.constrain(out), spatial.constrain(skip)
            i += 2
        return spatial.gather(skip)


def feature_modulation(gen_feats, conditions, clss=None, mod_type: str = "SFT"):
    """Condition injection other than NOISE: SFT applies (scale, shift), ADD
    adds the shift, FUSE gates the shift by sigmoid(scale). `conditions` is
    a (scale, shift) pair of tensors shaped like gen_feats (scale may be
    None for ADD); clss, optional (B,), scales both terms per sample (SFT,
    FUSE)."""
    dt = gen_feats.dtype
    c = 1.0 if clss is None else clss.reshape(-1, 1, 1, 1).to(dt)
    if mod_type == "SFT":
        return gen_feats * (1.0 + conditions[0].to(dt) * c) + conditions[1].to(dt) * c
    if mod_type == "ADD":
        return gen_feats + conditions[1].to(dt)
    if mod_type == "FUSE":
        return gen_feats + conditions[1].to(dt) * (torch.sigmoid(conditions[0].to(dt)) * c)
    raise NotImplementedError(f"unknown mod_type {mod_type}")


class Discriminator(nn.Module):
    """StyleGAN2 discriminator. forward(x NHWC) returns (score (B, 1),
    [body feature, final feature]), the features NHWC views of the NCHW
    activations. The final feature flattens in NCHW order (c, h, w) into
    final_linear0, as the JAX module does for converted torch weights."""

    def __init__(self, size=1024, channel_multiplier=2, blur_kernel=(1, 3, 3, 1),
                 stddev_group=4, stddev_feat=1, narrow=1.0):
        super().__init__()
        channels = STYLEGAN2_CHANNELS(channel_multiplier, narrow)
        self.stddev_group, self.stddev_feat = stddev_group, stddev_feat
        log_size = int(math.log2(size))
        self.conv0 = ConvLayer(3, channels[size], 1)
        self.res = nn.ModuleDict()
        in_ch = channels[size]
        for i in range(log_size, 2, -1):
            self.res[str(i)] = ResBlock(in_ch, channels[2 ** (i - 1)], blur_kernel)
            in_ch = channels[2 ** (i - 1)]
        self.final_conv = ConvLayer(in_ch + stddev_feat, channels[4], 3)
        self.final_linear0 = EqualLinear(channels[4] * 16, channels[4],
                                         activation="fused_lrelu")
        self.final_linear1 = EqualLinear(channels[4], 1)

    def forward(self, x):
        out = self.conv0(x.permute(0, 3, 1, 2))
        for block in self.res.values():
            out = block(out)
        body = out
        out = minibatch_stddev(out, self.stddev_group, self.stddev_feat)
        out = self.final_conv(out)
        score = self.final_linear1(self.final_linear0(out.reshape(out.shape[0], -1)))
        return score, [body.permute(0, 2, 3, 1), out.permute(0, 2, 3, 1)]
