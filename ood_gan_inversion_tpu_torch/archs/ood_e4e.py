"""OOD face-GAN inversion arch, E4E encoder family (counterpart of
archs/ood_e4e.py): encode -> W+ latent math -> SAMM-conditioned StyleGAN2
decode -> mask composite -> OOD blend.

`forward` takes and returns NHWC like the JAX arch; the work inside is
NCHW. The ReStyle and FeatureStyle families (archs/ood_restyle.py,
archs/ood_featurestyle.py) are this class with another encoder.

SAMM options, as JAX takes them: `modulation_type` NOISE (the shipped
configs) or ADD (archs/common.py says how each injects); SFT and FUSE
build, with the blocks' out_ch doubled for SFT, and raise at decode, as
JAX's do. `mod_btn: style_bottleneck_IR` puts the feature bottleneck
(nn/samm.py:StyleBottleneckIR) in front of each block's SPMWarp.

dtype: the activation dtype, float32 or bfloat16 (JAX's serving config,
`bench.py`). The parameters stay float32 and each module casts them to its
input's dtype at use, as the JAX modules do; the input is cast to the
arch dtype at the top of `encode` and `decode_samm`. In bfloat16 the SAMM
blocks follow the arch dtype, JAX's inference default
(`OGI_SAMM_FP32_INFER=0`), unless `samm_fp32_infer` makes them a float32
island (JAX's `OGI_SAMM_FP32_INFER=1`); what stays float32 inside them
either way is said in nn/samm.py.
"""

import math

import torch
from torch import nn

from ..nn.encoders.e4e import PROGRESSIVE_INFERENCE, Encoder4Editing
from ..nn.layers import Conv2dTorch
from ..nn.samm import StyledScaleNShiftBlock, check_samm_options
from ..nn.stylegan2 import STYLEGAN2_CHANNELS, Generator
from ..ops.resize import resize_bilinear
from ..utils import trace
from .common import blend_and_pack, cond_layers_for, cond_noise_shapes, conditioned_decode


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def nhwc_outputs(out):
    """decode_samm's output dict with its images, mask and aligns as NHWC
    views."""
    return {"image": _nhwc(out["image"]), "lats": out["lats"],
            "aligns": {k: _nhwc(v) for k, v in out["aligns"].items()},
            "mask": None if out["mask"] is None else _nhwc(out["mask"]),
            "gen_image": _nhwc(out["gen_image"])}


class OODFaceGANE4E(nn.Module):
    """Constructor keys mirror the `network_g` schema of the YAML configs;
    packed_tail and tail_kernel choose how the generator computes its
    >=512px stages (nn/stylegan2.py), samm_body0 and samm_conv_kernel how
    the SAMM blocks compute AlignNet's body0 (nn/samm.py), samm_fp32_infer
    whether a bfloat16 arch runs them in float32 (archs/common.py), and
    samm_conv_bf16, samm_warp_bf16 and samm_gather_bf16 which of a float32
    arch's SAMM operands are bfloat16 (nn/samm.py); none of them adds a
    parameter. A family subclass sets `ENCODER` and builds its
    encoder in `build_encoder`; the `encoder` key must name that family."""
    ENCODER = "E4E"

    def __init__(self, out_size=1024, style_dim=512, n_mlp=8, channel_multiplier=2,
                 narrow=1.0, encoder="E4E", encoder_num_layers=50,
                 enable_modulation=True, modulation_type="NOISE",
                 warp_scale=0.02, cycle_align=1, mod_btn=None, diff_fAndg=True,
                 blend_with_gen=True, blend_cnt=1, optim_delta_latent=False,
                 dtype=torch.float32,
                 packed_tail=False, tail_kernel="none", samm_body0="algebraic",
                 samm_conv_kernel=False, samm_fp32_infer=False, samm_conv_bf16=False,
                 samm_warp_bf16="off", samm_gather_bf16=False):
        super().__init__()
        check_samm_options(samm_body0, samm_conv_kernel, samm_conv_bf16, samm_warp_bf16)
        if encoder != self.ENCODER:
            raise ValueError(
                f"{type(self).__name__} builds the {self.ENCODER} encoder; got "
                f"encoder={encoder!r} (each of E4E, ReStyle and FeatureStyle has its arch)")
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"ported dtypes: float32, bfloat16; got {dtype}")
        self.dtype = dtype
        self.modulation_type, self.samm_fp32_infer = modulation_type, samm_fp32_infer
        self.out_size, self.enable_modulation = out_size, enable_modulation
        self.style_dim, self.optim_delta_latent = style_dim, optim_delta_latent
        self.blend_with_gen, self.blend_cnt = blend_with_gen, blend_cnt
        self.style_cnt = int(math.log2(out_size)) * 2 - 2
        channels = STYLEGAN2_CHANNELS(channel_multiplier, narrow)
        self.encoder = self.build_encoder(encoder_num_layers)
        if enable_modulation:
            sizes, enc_ch = [256, 128, 64, 32], [64, 64, 128, 256]
            self.feats_conv = nn.ModuleList(
                Conv2dTorch(enc_ch[i], channels[sizes[i]], 1, 1, 0)
                for i in range(4))
            # SAMM blocks, coarse->fine index 0..3 = [256, 128, 64, 32] px,
            # each where the generator has that resolution (the blocks whose
            # parameters JAX's tree holds)
            chn_mul = 2 if modulation_type == "SFT" else 1
            self.modulation = nn.ModuleDict({
                str(i): StyledScaleNShiftBlock(channels[s], channels[s] * chn_mul,
                                               warp_scale=warp_scale,
                                               cycle_align=cycle_align, btn=mod_btn,
                                               diff_f_and_g=diff_fAndg,
                                               style_dim=style_dim,
                                               samm_body0=samm_body0,
                                               samm_conv_kernel=samm_conv_kernel,
                                               samm_conv_bf16=samm_conv_bf16,
                                               samm_warp_bf16=samm_warp_bf16,
                                               samm_gather_bf16=samm_gather_bf16)
                for i, s in enumerate(sizes) if s <= out_size})
        self.generator = Generator(out_size, style_dim, channel_multiplier, narrow,
                                   packed_tail=packed_tail, tail_kernel=tail_kernel,
                                   n_mlp=n_mlp)
        self.avg_latent = nn.Parameter(torch.empty(*self.avg_latent_shape()))
        self.delta_latent = nn.Parameter(torch.empty(1, self.style_cnt, style_dim))

    def build_encoder(self, num_layers):
        return Encoder4Editing(num_layers, "ir_se", self.out_size)

    def avg_latent_shape(self):
        """One W for every layer (the other families keep one per layer)."""
        return (1, self.style_dim)

    @torch.no_grad()
    def init_params(self, g):
        """avg_latent 0; delta_latent N(0, 1) * 0.1 when it is trained
        (optim_delta_latent), else 0."""
        self.avg_latent.zero_()
        if self.optim_delta_latent:
            self.delta_latent.copy_(torch.randn(self.delta_latent.shape, generator=g,
                                                device=self.delta_latent.device) * 0.1)
        else:
            self.delta_latent.zero_()

    def make_noise(self, batch, generator=None, device=None):
        """The noise of one forward, the SAMM-conditioned decode's, drawn in
        this order from `generator`: the generator's per-layer list
        (Generator.make_noise), then, for ADD, one N(0, 1) draw of each
        shape of common.py:cond_noise_shapes."""
        noise = self.generator.make_noise(batch, generator, device)
        device = noise[0].device
        return noise + [torch.randn(s, generator=generator, device=device)
                        for s in cond_noise_shapes(self, batch)]

    def split_noise(self, noise):
        """make_noise's list -> (the encoder's share, the final decode's):
        this encoder decodes nothing, so its share is None."""
        return None, noise

    def random_latents(self, z):
        """z (B, style_dim) -> W through the style MLP, repeated to W+."""
        w = self.generator.style_mlp(z)
        return w[:, None, :].repeat(1, self.style_cnt, 1)

    def encode(self, x, truncation: float = 1.0, stage: int = PROGRESSIVE_INFERENCE,
               freeze_encoder: bool = True, noise=None):
        """x (B, 3, S, S) in [-1, 1] -> (W+ latents, adapted SAMM features).
        stage: the progressive encoder stage (the first stage + 1 style
        heads are active). freeze_encoder: the encoder's latents and
        features carry no gradient (the reference runs the encoder under
        no_grad); the W+ offsets and the adapters after it still do.
        noise: split_noise's encoder share (None here)."""
        with trace.span("encoder", x.shape[0]):
            lats, feats = self.encoder(resize_bilinear(x.to(self.dtype), (256, 256)), stage)
        if freeze_encoder:
            lats, feats = lats.detach(), [f.detach() for f in feats]
        return self.offset_and_adapt(lats + self.avg_latent[None].to(lats.dtype), feats,
                                     truncation)

    def offset_and_adapt(self, lats, feats, truncation):
        """The encoder's W+ with avg_latent added -> (W+ + delta_latent,
        truncated toward avg_latent when truncation < 1; the SAMM features
        through their 1x1 adapters)."""
        with trace.span("adapt", lats.shape[0]):
            lats = lats + self.delta_latent.to(lats.dtype)
            if truncation < 1.0:
                lats = (self.avg_latent[None].to(lats.dtype) * (1.0 - truncation)
                        + lats * truncation)
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
                noise=None, generator=None, stage: int = PROGRESSIVE_INFERENCE,
                freeze_encoder: bool = True):
        """x: (B, S, S, 3) NHWC in [-1, 1]. noise: make_noise's list (the
        per-layer (B, 1, H, W) tensors of Generator.noise_shapes, then
        ADD's draws), cast to the activations' dtype where they are added;
        drawn from `generator` when None. Returns dict(image, lats, aligns, mask, gen_image) in the
        arch dtype with NHWC images; aligns maps the SAMM index (1 = 32px
        .. 4 = 256px) to (B, h, w, 3) [dx, dy, alpha] and out_size to the
        composited 3-channel mask."""
        x = x.permute(0, 3, 1, 2)
        if noise is None:
            noise = self.make_noise(x.shape[0], generator, x.device)
        enc_noise, dec_noise = self.split_noise(noise)
        lats, feats_c = self.encode(x, truncation, stage, freeze_encoder, enc_noise)
        return nhwc_outputs(self.decode_samm(lats, feats_c, x, mod_size, dec_noise))
