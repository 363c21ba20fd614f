"""The plain reference of the FeatureStyle configuration (`"reference":
"featurestyle"`): the OOD face-GAN inverter with the Feature-Style encoder,
in float32 and plain PyTorch. It keeps the contract of
`portbench/reference/__init__.py` and imports nothing of the program under
test.

The encoder is fs_encoder_v2 of Yao et al., "Feature-Style Encoder for
Style-Based GAN Inversion" (arXiv 2202.02183), as the OOD-GAN-inversion
repository (AbnerVictor/OOD-GAN-inversion) builds it for
`options/test/FeatureStyle_Face_test.yml`:
  * its trunk is ArcFace's iresnet50 (insightface `arcface_torch`,
    `IBasicBlock`: BN, 3x3 conv, BN, PReLU, 3x3 conv with the stage's
    stride, BN, plus the shortcut; no SE module; BN eps 1e-5), run on the
    input average-pooled to 256 px;
  * four stages of (64, 3), (128, 4), (256, 14), (512, 3) blocks, the
    first block of each with stride 2 and a 1x1 conv + BN shortcut;
  * 18 linear heads, each mapping the four stage outputs pooled to 3x3,
    concatenated on channels and flattened in NCHW order (960 x 9 = 8640
    inputs), to one W (512);
  * the content branch on the 32 px stage output: BN, 3x3 conv to 512,
    BN, PReLU, 3x3 conv, BN.
Departures from the Feature-Style paper, both as the OOD repository has
them: the content branch's second conv has stride 2 (content at 16 px),
and the content is computed and never passed to the generator (no
injection; `inject_content` is refused).

After the encoder: W+ = heads + avg_latent (one W per layer) +
delta_latent; the 1x1 adapters map the input-block and first three stage
outputs (256, 128, 64, 32 px) to the generator's widths; the SAMM blocks
(`cycle_align` 3 as published), the generator and the blend are those of
`model.py`, unchanged.

Its parameter names are the program's state-dict keys
(`encoder.layer3.block.7.conv2.weight`, `encoder.style_11_weight`, ...).
Images are NHWC at the interface, NCHW inside.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .model import (BIAS, BatchNorm, Conv, Generator, OODInverter, PReLU, SAMMBlock,
                    batch_noise, generator_channels)

__all__ = ["build", "batch_noise", "FSEncoderV2", "FeatureStyleInverter"]

STAGES = ((64, 3), (128, 4), (256, 14), (512, 3))
# the heads' weights: N(0, 0.01), as the port and the JAX package draw them
HEAD_WEIGHT = ("normal", 0.01)


class IBasicBlock(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(cin, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.prelu = PReLU(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = BatchNorm(planes)
        if stride != 1 or cin != planes:
            self.downsample_conv = Conv(cin, planes, 1, stride, 0, bias=False)
            self.downsample_bn = BatchNorm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        shortcut = x if self.downsample_conv is None else self.downsample_bn(
            self.downsample_conv(x))
        return out + shortcut


class IResLayer(nn.Module):
    def __init__(self, cin, planes, blocks):
        super().__init__()
        self.block = nn.ModuleList(IBasicBlock(cin if i == 0 else planes, planes,
                                               2 if i == 0 else 1) for i in range(blocks))

    def forward(self, x):
        for blk in self.block:
            x = blk(x)
        return x


class FSEncoderV2(nn.Module):
    """forward(x (B, 3, 256, 256)) -> (W+ (B, n_styles, 512), content (B,
    512, 16, 16), [f0 (256 px, 64), f1 (128, 64), f2 (64, 128), f3 (32,
    256)])."""

    def __init__(self, n_styles=18):
        super().__init__()
        self.n_styles = n_styles
        self.input_conv = Conv(3, 64, 3, 1, 1, bias=False)
        self.input_bn = BatchNorm(64)
        self.input_prelu = PReLU(64)
        cin = 64
        for i, (planes, blocks) in enumerate(STAGES):
            setattr(self, f"layer{i + 1}", IResLayer(cin, planes, blocks))
            cin = planes
        self.content_bn0 = BatchNorm(256)
        self.content_conv0 = Conv(256, 512, 3, 1, 1, bias=False)
        self.content_bn1 = BatchNorm(512)
        self.content_prelu = PReLU(512)
        self.content_conv1 = Conv(512, 512, 3, 2, 1, bias=False)
        self.content_bn2 = BatchNorm(512)
        n_in = sum(planes for planes, _ in STAGES) * 9
        for i in range(n_styles):
            self.register_parameter(f"style_{i}_weight", nn.Parameter(torch.empty(512, n_in)))
            self.register_parameter(f"style_{i}_bias", nn.Parameter(torch.empty(512)))

    def init_specs(self):
        specs = {}
        for i in range(self.n_styles):
            specs[f"style_{i}_weight"], specs[f"style_{i}_bias"] = HEAD_WEIGHT, BIAS
        return specs

    def forward(self, x):
        f0 = self.input_prelu(self.input_bn(self.input_conv(x)))
        f1 = self.layer1(f0)
        f2 = self.layer2(f1)
        f3 = self.layer3(f2)
        f4 = self.layer4(f3)
        h = torch.cat([F.adaptive_avg_pool2d(f, 3) for f in (f1, f2, f3, f4)], dim=1).flatten(1)
        lats = torch.stack([h @ getattr(self, f"style_{i}_weight").t()
                            + getattr(self, f"style_{i}_bias") for i in range(self.n_styles)],
                           dim=1)
        c = self.content_prelu(self.content_bn1(self.content_conv0(self.content_bn0(f3))))
        content = self.content_bn2(self.content_conv1(c))
        return lats, content, [f0, f1, f2, f3]


class FeatureStyleInverter(nn.Module):
    """forward(x NHWC in [-1, 1], noises) -> dict(image, mask, gen_image
    NHWC, lats); one conditioned decode."""

    def __init__(self, out_size=1024, style_dim=512, n_mlp=8, channel_multiplier=2,
                 narrow=1.0, encoder="FeatureStyle", warp_scale=0.02, cycle_align=1,
                 ModSize=256, inject_content=False, **_):
        super().__init__()
        if encoder != "FeatureStyle":
            raise ValueError(f"encoder {encoder!r}: FeatureStyle")
        if inject_content:
            raise ValueError("inject_content: the published forward injects no content")
        self.mod_size, self.out_size = ModSize, out_size
        n_styles = int(math.log2(out_size)) * 2 - 2
        ch = generator_channels(channel_multiplier, narrow)
        self.encoder = FSEncoderV2(n_styles)
        sizes, enc_ch = (256, 128, 64, 32), (64, 64, 128, 256)
        self.feats_conv = nn.ModuleList(Conv(enc_ch[i], ch[sizes[i]], 1) for i in range(4))
        self.modulation = nn.ModuleDict({str(i): SAMMBlock(ch[s], warp_scale, cycle_align)
                                         for i, s in enumerate(sizes) if s <= out_size})
        self.generator = Generator(out_size, style_dim, channel_multiplier, narrow, n_mlp)
        self.avg_latent = nn.Parameter(torch.empty(n_styles, style_dim))
        self.delta_latent = nn.Parameter(torch.empty(1, n_styles, style_dim))

    init_specs = OODInverter.init_specs
    make_noise = OODInverter.make_noise

    def n_decodes(self):
        return 1

    def encode(self, x, noises):
        lats, _content, feats = self.encoder(F.adaptive_avg_pool2d(x, (256, 256)))
        lats = lats + self.avg_latent[None] + self.delta_latent
        return lats, [conv(f) for conv, f in zip(self.feats_conv, feats)]

    # the SAMM-conditioned decode and the blend of model.py's inverter
    forward = OODInverter.forward


def build(network_g):
    """The inverter of a configuration's `network_g`."""
    return FeatureStyleInverter(**{k: v for k, v in network_g.items() if k not in ("type", "dtype")})
