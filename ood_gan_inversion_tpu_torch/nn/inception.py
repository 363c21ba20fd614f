"""InceptionV3 pool3 feature extractor for FID (counterpart of
nn/inception.py), NCHW inside, eval-mode BatchNorm.

The pytorch-fid variant of torchvision's InceptionV3 as the JAX package
builds it with its default fields (resize_input True, normalize_input
False), which are fixed here: bilinear resize to 299 x 299 inside, no
input normalization, the Mixed_5b..Mixed_7c blocks, global average pool to
2048 features. Module names follow torchvision's (`Mixed_5b.branch5x5_1`),
with each BasicConv2d's kernel as its own `weight` beside its `bn`, as in
the JAX tree; `convert.from_jax_params(flat, "inception")` bridges it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import batch_invariant as bi
from ..ops.resize import resize_bilinear
from .layers import BatchNorm2dEval, _normal


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3) -> ReLU; weight init N(0,
    0.02), as the JAX module's."""

    def __init__(self, in_ch, out_ch, kernel=(3, 3), stride=1, padding=(0, 0)):
        super().__init__()
        self.stride, self.padding = stride, tuple(padding)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel))
        self.bn = BatchNorm2dEval(out_ch, eps=1e-3)

    @torch.no_grad()
    def init_params(self, g):
        self.weight.copy_(_normal(self.weight.shape, 0.02, g, self.weight.device))

    def forward(self, x):
        y = bi.conv2d(x, self.weight.to(x.dtype), None, stride=self.stride,
                      padding=self.padding)
        return torch.relu(self.bn(y))


def _avgpool3(x):
    """3 x 3 average, stride 1, zero padding counted (count_include_pad)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_ch, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(in_ch, pool_features, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avgpool3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _maxpool3s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, in_ch):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_ch, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgpool3(x))], dim=1)


class InceptionV3FID(nn.Module):
    """forward(x (N, H, W, 3) NHWC in [0, 1]) -> (N, 2048) pool3 features.
    The input is resized bilinearly to 299 x 299 and not normalized."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = resize_bilinear(x.permute(0, 3, 1, 2), (299, 299))
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool3s2(x)))
        x = _maxpool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return bi.mean_hw(x)
