"""E4E (encoder4editing): IR-SE trunk + FPN + per-layer W deltas
(counterpart of nn/encoders/e4e.py), NCHW. Returns W+ (B, style_count, 512)
and the five trunk taps [256px/64, 128px/64, 64px/128, 32px/256, 16px/512].
At progressive stage s the first s + 1 style heads run and the others'
deltas are zero (stage 0, `WTraining`: one W for every layer); at
Inference every head runs. The heads run one after another, the JAX
default. Also pSp's `GradualStyleEncoder` and the single-W
`BackboneEncoderUsingLastLayerIntoW` on the same IR-SE trunk and heads
(no shipped config builds them)."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import batch_invariant as bi
from ..irse import IRSETrunk, trunk_taps
from ..layers import Conv2dTorch, EqualLinear
from ...ops.resize import resize_bicubic_ac

# the progressive stage at which every W delta is active
# (ProgressiveStage.Inference)
PROGRESSIVE_INFERENCE = 18


def _upsample_add(x, y):
    """Bicubic align_corners=True FPN merge."""
    return resize_bicubic_ac(x, tuple(y.shape[-2:])) + y


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 3x3 convs with LeakyReLU(0.01), then an
    EqualLinear on the 1x1 map."""

    def __init__(self, in_c=512, out_c=512, spatial=16):
        super().__init__()
        n = int(math.log2(spatial))
        self.conv = nn.ModuleList(
            Conv2dTorch(in_c if i == 0 else out_c, out_c, 3, 2, 1)
            for i in range(n))
        self.linear = EqualLinear(out_c, out_c)

    def forward(self, x):
        for conv in self.conv:
            x = F.leaky_relu(conv(x), 0.01)
        return self.linear(x.reshape(x.shape[0], -1))


class Encoder4Editing(nn.Module):
    def __init__(self, num_layers=50, mode="ir_se", stylegan_size=1024):
        super().__init__()
        self.num_layers = num_layers
        self.trunk = IRSETrunk(num_layers, mode)
        self.style_count = 2 * int(math.log2(stylegan_size)) - 2
        self.coarse_ind, self.middle_ind = 3, 7
        self.style = nn.ModuleList(
            GradualStyleBlock(512, 512, 16 if i < self.coarse_ind
                              else 32 if i < self.middle_ind else 64)
            for i in range(self.style_count))
        self.latlayer1 = Conv2dTorch(256, 512, 1, 1, 0)
        self.latlayer2 = Conv2dTorch(128, 512, 1, 1, 0)

    def forward(self, x, stage: int = PROGRESSIVE_INFERENCE):
        """stage: the progressive stage; the first stage + 1 style heads
        are active, the others give zero deltas (and their FPN maps are not
        built)."""
        _, feats = self.trunk(x, taps=trunk_taps(self.num_layers))
        c1, c2, c3 = feats[2], feats[3], feats[4]
        w0 = self.style[0](c3)
        deltas = [torch.zeros_like(w0)]
        features, p2 = c3, None
        for i in range(1, min(stage + 1, self.style_count)):
            if i == self.coarse_ind:
                p2 = _upsample_add(c3, self.latlayer1(c2))
                features = p2
            elif i == self.middle_ind:
                features = _upsample_add(p2, self.latlayer2(c1))
            deltas.append(self.style[i](features))
        deltas += [torch.zeros_like(w0)] * (self.style_count - len(deltas))
        return w0[:, None, :] + torch.stack(deltas, dim=1), feats


class GradualStyleEncoder(nn.Module):
    """pSp's FPN encoder: every one of the style_count W vectors predicted
    on its own (no w0 + delta), the coarse ones from the 16px map, the
    middle ones from the FPN-merged 32px map, the fine ones from the 64px
    map. forward(x (B, 3, 256, 256)) -> W+ (B, style_count, 512)."""

    def __init__(self, num_layers=50, mode="ir_se", stylegan_size=1024):
        super().__init__()
        self.num_layers = num_layers
        self.trunk = IRSETrunk(num_layers, mode)
        self.style_count = 2 * int(math.log2(stylegan_size)) - 2
        self.coarse_ind, self.middle_ind = 3, 7
        self.style = nn.ModuleList(
            GradualStyleBlock(512, 512, 16 if i < self.coarse_ind
                              else 32 if i < self.middle_ind else 64)
            for i in range(self.style_count))
        self.latlayer1 = Conv2dTorch(256, 512, 1, 1, 0)
        self.latlayer2 = Conv2dTorch(128, 512, 1, 1, 0)

    def forward(self, x):
        _, feats = self.trunk(x, taps=trunk_taps(self.num_layers)[1:])
        c1, c2, c3 = feats[1], feats[2], feats[3]
        p2 = _upsample_add(c3, self.latlayer1(c2))
        p1 = _upsample_add(p2, self.latlayer2(c1))
        maps = [c3] * self.coarse_ind + [p2] * (self.middle_ind - self.coarse_ind)
        maps += [p1] * (self.style_count - self.middle_ind)
        return torch.stack([head(m) for head, m in zip(self.style, maps)], dim=1)


class BackboneEncoderUsingLastLayerIntoW(nn.Module):
    """The single-W encoder: trunk -> global average pool -> EqualLinear ->
    that W repeated for every layer. forward(x) -> (B, style_count, 512)."""

    def __init__(self, num_layers=50, mode="ir_se", stylegan_size=1024):
        super().__init__()
        self.trunk = IRSETrunk(num_layers, mode)
        self.linear = EqualLinear(512, 512)
        self.style_count = 2 * int(math.log2(stylegan_size)) - 2

    def forward(self, x):
        y, _ = self.trunk(x, taps=())
        w = self.linear(bi.mean_hw(y))
        return w[:, None, :].repeat(1, self.style_count, 1)
