"""GCFSR-style generator (counterpart of nn/gcfsr.py), NCHW: the GPEN
concat-noise generator (nn/stylegan2_gpen.py) with
  * a per-layer `FeatureModulation`, when `merge` holds "modulation": given
    a target feature and a per-sample (sigma0, sigma1), the activation
    becomes source * sigma0 + conv3x3(target) * sigma1 before the fused
    lrelu;
  * condition injection at the layers `cond_ind` names, through
    nn/stylegan2.py:feature_modulation (SFT, ADD or FUSE).
No shipped config builds it. Noise is explicit, as for GPEN."""

import torch
from torch import nn

from .layers import EqualConv2d, FusedLeakyReLU
from .stylegan2 import ModulatedConv2d, feature_modulation
from .stylegan2_gpen import GPENGenerator


class FeatureModulation(nn.Module):
    """source * sigma[:, 0] + conv0(target) * sigma[:, 1]; the identity
    when target is None."""

    def __init__(self, channels, kernel_size=3):
        super().__init__()
        self.conv0 = EqualConv2d(channels, channels, kernel_size, 1, kernel_size // 2)

    def forward(self, source, target=None, sigma=None):
        if target is None:
            return source
        s0 = sigma[:, 0].reshape(-1, 1, 1, 1).to(source.dtype)
        s1 = sigma[:, 1].reshape(-1, 1, 1, 1).to(source.dtype)
        return source * s0 + self.conv0(target.to(source.dtype)) * s1


class StyledConvGCFSR(nn.Module):
    """ModulatedConv2d -> weighted full-channel noise, concatenated
    ("concat" in merge) or added -> FeatureModulation ("modulation" in
    merge) -> FusedLeakyReLU."""

    def __init__(self, in_ch, out_ch, kernel_size=3, style_dim=512, upsample=False,
                 blur_kernel=(1, 3, 3, 1), merge="concat"):
        super().__init__()
        self.isconcat = "concat" in merge
        mult = 2 if self.isconcat else 1
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim,
                                    upsample=upsample, blur_kernel=blur_kernel)
        self.noise_weight = nn.Parameter(torch.empty(1))
        self.feat_mod = (FeatureModulation(out_ch * mult, kernel_size)
                         if "modulation" in merge else None)
        self.activate = FusedLeakyReLU(out_ch * mult)

    @torch.no_grad()
    def init_params(self, g):
        self.noise_weight.zero_()

    def forward(self, x, style, noise, feat=None, sigma=None):
        out = self.conv(x, style)
        n = self.noise_weight.to(out.dtype) * noise.to(out.dtype)
        out = torch.cat([out, n], dim=1) if self.isconcat else out + n
        if self.feat_mod is not None:
            out = self.feat_mod(out, feat, sigma)
        return self.activate(out)


class GCFSRGenerator(GPENGenerator):
    """forward(latent W+, noise, feats=None, sigmas=None, conditions=None,
    cond_ind=None, mod_type="SFT") -> (B, 3, size, size). feats / sigmas:
    optional per-layer lists (num_layers entries, None where unused) for
    the FeatureModulations; conditions: (scale, shift) pairs applied after
    the first conv of the pair starting at each latent index in cond_ind.
    As in JAX, the pair's second conv gets the first's feature
    (feats[1 + 2 idx]) with its own sigma."""

    def __init__(self, size=512, style_dim=512, n_mlp=8, channel_multiplier=2, narrow=1.0,
                 blur_kernel=(1, 3, 3, 1), lr_mlp=0.01, merge="concat"):
        self.merge = merge
        super().__init__(size, style_dim, n_mlp, channel_multiplier, narrow,
                         isconcat="concat" in merge, blur_kernel=blur_kernel, lr_mlp=lr_mlp)
        self.feat_multiplier = 2 if self.isconcat else 1

    def styled_conv(self, in_ch, out_ch, style_dim, upsample, blur_kernel):
        return StyledConvGCFSR(in_ch, out_ch, 3, style_dim, upsample=upsample,
                               blur_kernel=blur_kernel, merge=self.merge)

    def forward(self, latent, noise, feats=None, sigmas=None, conditions=None,
                cond_ind=None, mod_type="SFT"):
        feats = feats or [None] * self.num_layers
        sigmas = sigmas or [None] * self.num_layers
        out = self.input.to(latent.dtype).expand(latent.shape[0], -1, -1, -1)
        out = self.conv1(out, latent[:, 0], noise[0], feats[0], sigmas[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * idx](out, latent[:, i], noise[1 + 2 * idx],
                                      feats[1 + 2 * idx], sigmas[1 + 2 * idx])
            if cond_ind is not None and conditions is not None and i in cond_ind:
                out = feature_modulation(out, conditions[cond_ind.index(i)],
                                         mod_type=mod_type)
            out = self.convs[2 * idx + 1](out, latent[:, i + 1], noise[2 + 2 * idx],
                                          feats[1 + 2 * idx], sigmas[2 + 2 * idx])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip
