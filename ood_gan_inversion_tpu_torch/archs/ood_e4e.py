"""OOD face-GAN inversion arch, E4E encoder family (counterpart of
archs/ood_e4e.py): encode -> W+ latent math -> SAMM-conditioned StyleGAN2
decode -> mask composite -> OOD blend.

`forward` takes and returns NHWC like the JAX arch; the work inside is
NCHW. Ported configuration: the E4E encoder, NOISE modulation without the
SAMM feature bottleneck -- the options of the shipped inference config;
other values raise.

dtype: the activation dtype, float32 or bfloat16 (JAX's serving config,
`bench.py`). The parameters stay float32 and each module casts them to its
input's dtype at use, as the JAX modules do; the input is cast to the
arch dtype at the top of `encode` and `decode_samm`. In bfloat16 the SAMM
blocks follow the arch dtype, JAX's inference default
(`OGI_SAMM_FP32_INFER=0`); what stays float32 inside them is said in
nn/samm.py.
"""

import math

import torch
from torch import nn

from ..nn.encoders.e4e import Encoder4Editing
from ..nn.layers import Conv2dTorch
from ..nn.samm import StyledScaleNShiftBlock, check_samm_options
from ..nn.stylegan2 import STYLEGAN2_CHANNELS, Generator
from ..ops.resize import resize_bilinear
from .common import blend_and_pack, cond_layers_for, conditioned_decode


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class OODFaceGANE4E(nn.Module):
    """Constructor keys mirror the `network_g` schema of the YAML configs;
    packed_tail and tail_kernel choose how the generator computes its
    >=512px stages (nn/stylegan2.py), samm_body0 and samm_conv_kernel how
    the SAMM blocks compute AlignNet's body0 (nn/samm.py); none of them adds
    a parameter."""

    def __init__(self, out_size=1024, style_dim=512, channel_multiplier=2,
                 narrow=1.0, encoder="E4E", encoder_num_layers=50,
                 enable_modulation=True, modulation_type="NOISE",
                 warp_scale=0.02, cycle_align=1, mod_btn=None, diff_fAndg=True,
                 blend_with_gen=True, blend_cnt=1, dtype=torch.float32,
                 packed_tail=False, tail_kernel="none", samm_body0="algebraic",
                 samm_conv_kernel=False):
        super().__init__()
        check_samm_options(samm_body0, samm_conv_kernel)
        if encoder != "E4E" or modulation_type != "NOISE" or mod_btn is not None:
            raise NotImplementedError(
                "ported: encoder='E4E', modulation_type='NOISE', mod_btn=None")
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"ported dtypes: float32, bfloat16; got {dtype}")
        self.dtype = dtype
        self.out_size, self.enable_modulation = out_size, enable_modulation
        self.blend_with_gen, self.blend_cnt = blend_with_gen, blend_cnt
        self.style_cnt = int(math.log2(out_size)) * 2 - 2
        channels = STYLEGAN2_CHANNELS(channel_multiplier, narrow)
        self.encoder = Encoder4Editing(encoder_num_layers, "ir_se", out_size)
        if enable_modulation:
            sizes, enc_ch = [256, 128, 64, 32], [64, 64, 128, 256]
            self.feats_conv = nn.ModuleList(
                Conv2dTorch(enc_ch[i], channels[sizes[i]], 1, 1, 0)
                for i in range(4))
            # SAMM blocks, coarse->fine order [256, 128, 64, 32] px
            self.modulation = nn.ModuleList(
                StyledScaleNShiftBlock(channels[s], warp_scale=warp_scale,
                                       cycle_align=cycle_align,
                                       diff_f_and_g=diff_fAndg,
                                       samm_body0=samm_body0,
                                       samm_conv_kernel=samm_conv_kernel)
                for s in sizes)
        self.generator = Generator(out_size, style_dim, channel_multiplier, narrow,
                                   packed_tail=packed_tail, tail_kernel=tail_kernel)
        self.avg_latent = nn.Parameter(torch.empty(1, style_dim))
        self.delta_latent = nn.Parameter(torch.empty(1, self.style_cnt, style_dim))

    @torch.no_grad()
    def init_params(self, g):
        self.avg_latent.zero_()
        self.delta_latent.zero_()

    def encode(self, x, truncation: float = 1.0):
        """x (B, 3, S, S) in [-1, 1] -> (W+ latents, adapted SAMM features)."""
        lats, feats = self.encoder(resize_bilinear(x.to(self.dtype), (256, 256)))
        avg = self.avg_latent[None].to(lats.dtype)
        lats = lats + avg + self.delta_latent.to(lats.dtype)
        if truncation < 1.0:
            lats = avg * (1.0 - truncation) + lats * truncation
        feats_c = ([conv(f) for conv, f in zip(self.feats_conv, feats)]
                   if self.enable_modulation else None)
        return lats, feats_c

    def decode_samm(self, lats, feats_c, x, mod_size: int = 256, noise=None):
        """(W+, adapted features) -> the output dict, NCHW."""
        x = x.to(self.dtype)
        if not self.enable_modulation or not cond_layers_for(mod_size):
            image = self.generator(lats, noise)
            return {"image": image, "lats": lats, "aligns": {}, "mask": None,
                    "gen_image": image}
        gen_image, aligns = conditioned_decode(self, lats, feats_c, mod_size, noise)
        return blend_and_pack(self, x, gen_image, lats, aligns)

    def forward(self, x, mod_size: int = 256, truncation: float = 1.0,
                noise=None, generator=None):
        """x: (B, S, S, 3) NHWC in [-1, 1]. noise: per-layer list of
        (B, 1, H, W) tensors (Generator.noise_shapes), cast to the
        activations' dtype where they are added; drawn from `generator`
        when None. Returns dict(image, lats, aligns, mask, gen_image) in the
        arch dtype with NHWC images; aligns maps the SAMM index (1 = 32px
        .. 4 = 256px) to (B, h, w, 3) [dx, dy, alpha] and out_size to the
        composited 3-channel mask."""
        x = x.permute(0, 3, 1, 2)
        if noise is None:
            noise = self.generator.make_noise(x.shape[0], generator, x.device)
        lats, feats_c = self.encode(x, truncation)
        out = self.decode_samm(lats, feats_c, x, mod_size, noise)
        return {"image": _nhwc(out["image"]), "lats": out["lats"],
                "aligns": {k: _nhwc(v) for k, v in out["aligns"].items()},
                "mask": None if out["mask"] is None else _nhwc(out["mask"]),
                "gen_image": _nhwc(out["gen_image"])}
