"""IR-SE ResNet blocks, trunk and the ArcFace identity net (counterpart of
nn/irse.py), NCHW. BatchNorm is eval-mode only: every IR-SE trunk is a
frozen pretrained net."""

from collections import namedtuple

import torch
from torch import nn

from ..ops import batch_invariant as bi
from .layers import BatchNorm1dEval, BatchNorm2dEval, Conv2dTorch, PReLU, SEModule

Bottleneck = namedtuple("Bottleneck", ["in_channel", "depth", "stride"])


def get_block(in_channel, depth, num_units, stride=2):
    return ([Bottleneck(in_channel, depth, stride)]
            + [Bottleneck(depth, depth, 1) for _ in range(num_units - 1)])


def get_blocks(num_layers):
    if num_layers == 50:
        return [get_block(64, 64, 3), get_block(64, 128, 4),
                get_block(128, 256, 14), get_block(256, 512, 3)]
    if num_layers == 100:
        return [get_block(64, 64, 3), get_block(64, 128, 13),
                get_block(128, 256, 30), get_block(256, 512, 3)]
    if num_layers == 152:
        return [get_block(64, 64, 3), get_block(64, 128, 8),
                get_block(128, 256, 36), get_block(256, 512, 3)]
    if num_layers == 4:
        # minimal trunk: one bottleneck per stage, same tap shapes
        return [get_block(64, 64, 1), get_block(64, 128, 1),
                get_block(128, 256, 1), get_block(256, 512, 1)]
    raise ValueError(f"num_layers must be 4/50/100/152, got {num_layers}")


def trunk_taps(num_layers):
    """Indices of the last unit of each stage (the E4E feature taps)."""
    idx, taps = -1, []
    for block in get_blocks(num_layers):
        idx += len(block)
        taps.append(idx)
    return tuple(taps)


class BottleneckIR(nn.Module):
    """shortcut: subsample (in == depth) or 1x1 conv + BN;
    residual: BN -> 3x3 -> PReLU -> 3x3(stride) -> BN -> SE. bn=False
    drops the three BNs (JAX's `bn=False`, the SAMM feature bottleneck's
    units)."""

    def __init__(self, in_ch, depth, stride=1, se=True, bn=True):
        super().__init__()
        self.stride = stride

        def norm(ch):
            return BatchNorm2dEval(ch) if bn else nn.Identity()

        if in_ch != depth:
            self.shortcut_conv = Conv2dTorch(in_ch, depth, 1, stride, 0, bias=False)
            self.shortcut_norm = norm(depth)
        else:
            self.shortcut_conv = None
        self.norm1 = norm(in_ch)
        self.conv1 = Conv2dTorch(in_ch, depth, 3, 1, 1, bias=False)
        self.prelu = PReLU(depth)
        self.conv2 = Conv2dTorch(depth, depth, 3, stride, 1, bias=False)
        self.norm2 = norm(depth)
        self.se = SEModule(depth, 16) if se else None

    def forward(self, x):
        if self.shortcut_conv is None:
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_norm(self.shortcut_conv(x))
        res = self.norm2(self.conv2(self.prelu(self.conv1(self.norm1(x)))))
        if self.se is not None:
            res = self.se(res)
        return res + shortcut


class IRSETrunk(nn.Module):
    """Input layer + body of the IR(-SE) nets. forward returns the body
    output and [input-layer output] + the outputs of the tapped units.
    input_ch: the input's channels (3; 6 for ReStyle's [x || decode])."""

    def __init__(self, num_layers=50, mode="ir_se", input_ch=3):
        super().__init__()
        self.input_conv = Conv2dTorch(input_ch, 64, 3, 1, 1, bias=False)
        self.input_norm = BatchNorm2dEval(64)
        self.input_prelu = PReLU(64)
        self.body = nn.ModuleList(
            BottleneckIR(u.in_channel, u.depth, u.stride, se=(mode == "ir_se"))
            for block in get_blocks(num_layers) for u in block)

    def forward(self, x, taps=(2, 6, 20, 23)):
        y = self.input_prelu(self.input_norm(self.input_conv(x)))
        feats = [y]
        for idx, unit in enumerate(self.body):
            y = unit(y)
            if idx in taps:
                feats.append(y)
        return y, feats


class ArcFaceBackbone(nn.Module):
    """The IR-SE-50 identity embedding: trunk, out_norm, NCHW flatten, a
    linear map to 512, out_norm1d, l2 normalization. forward(x (B, 3, 112,
    112)) -> (B, 512). Dropout is eval-mode (identity)."""

    def __init__(self, num_layers=50):
        super().__init__()
        self.trunk = IRSETrunk(num_layers, "ir_se")
        self.out_norm = BatchNorm2dEval(512)
        self.linear_weight = nn.Parameter(torch.empty(512, 512 * 7 * 7))
        self.linear_bias = nn.Parameter(torch.empty(512))
        self.out_norm1d = BatchNorm1dEval(512)

    @torch.no_grad()
    def init_params(self, g):
        self.linear_weight.copy_(torch.randn(self.linear_weight.shape, generator=g,
                                             device=self.linear_weight.device) * 0.01)
        self.linear_bias.zero_()

    def forward(self, x):
        y, _ = self.trunk(x, taps=())
        y = self.out_norm(y)
        y = bi.matmul(y.reshape(y.shape[0], -1), self.linear_weight.t()) + self.linear_bias
        y = self.out_norm1d(y)
        return y / torch.clamp(torch.linalg.vector_norm(y, dim=1, keepdim=True), min=1e-12)
