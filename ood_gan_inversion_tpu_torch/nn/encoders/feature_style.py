"""FeatureStyle's encoder (counterpart of nn/encoders/feature_style.py),
NCHW: the ArcFace iresnet50 trunk, 18 linear style heads on its pooled
block features, and a content tensor from the 32px stage. Every
BatchNorm is eval-mode (a frozen pretrained subnet). The content branch
runs in its own span, `encoder.content`, inside the arch's `encoder`."""

import torch
from torch import nn

from ...ops import batch_invariant as bi
from ...ops.resize import adaptive_avg_pool
from ...utils import trace
from ..layers import BatchNorm2dEval, Conv2dTorch, PReLU, _normal

IRESNET50_LAYERS = (3, 4, 14, 3)


class IBasicBlock(nn.Module):
    """bn1 -> conv3x3 -> bn2 -> prelu -> conv3x3(stride) -> bn3, plus the
    input (or its 1x1 conv + bn where the stride or width changes)."""

    def __init__(self, in_ch, planes, stride=1):
        super().__init__()
        self.bn1 = BatchNorm2dEval(in_ch)
        self.conv1 = Conv2dTorch(in_ch, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2dEval(planes)
        self.prelu = PReLU(planes)
        self.conv2 = Conv2dTorch(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = BatchNorm2dEval(planes)
        if stride != 1 or in_ch != planes:
            self.downsample_conv = Conv2dTorch(in_ch, planes, 1, stride, 0, bias=False)
            self.downsample_bn = BatchNorm2dEval(planes)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        identity = (x if self.downsample_conv is None
                    else self.downsample_bn(self.downsample_conv(x)))
        return out + identity


class _IResLayer(nn.Module):
    """`blocks` IBasicBlocks, the first with the stride."""

    def __init__(self, in_ch, planes, blocks, stride=2):
        super().__init__()
        self.block = nn.ModuleList(
            IBasicBlock(in_ch if i == 0 else planes, planes, stride if i == 0 else 1)
            for i in range(blocks))

    def forward(self, x):
        for blk in self.block:
            x = blk(x)
        return x


class FSEncoderV2(nn.Module):
    """fs_encoder_v2 with the content layer at stride 2 (the JAX module's
    `content_stride` at its default, fixed here). forward(x (B, 3, 256,
    256)) -> (W+ (B, n_styles, 512), content (B, 512, 16, 16), SAMM
    features [256px/64, 128px/64, 64px/128, 32px/256])."""

    def __init__(self, n_styles=18):
        super().__init__()
        self.n_styles = n_styles
        self.input_conv = Conv2dTorch(3, 64, 3, 1, 1, bias=False)
        self.input_bn = BatchNorm2dEval(64)
        self.input_prelu = PReLU(64)
        self.layer1 = _IResLayer(64, 64, IRESNET50_LAYERS[0])
        self.layer2 = _IResLayer(64, 128, IRESNET50_LAYERS[1])
        self.layer3 = _IResLayer(128, 256, IRESNET50_LAYERS[2])
        self.layer4 = _IResLayer(256, 512, IRESNET50_LAYERS[3])
        self.content_bn0 = BatchNorm2dEval(256)
        self.content_conv0 = Conv2dTorch(256, 512, 3, 1, 1, bias=False)
        self.content_bn1 = BatchNorm2dEval(512)
        self.content_prelu = PReLU(512)
        self.content_conv1 = Conv2dTorch(512, 512, 3, 2, 1, bias=False)
        self.content_bn2 = BatchNorm2dEval(512)
        n_in = (64 + 128 + 256 + 512) * 9
        for i in range(n_styles):
            self.register_parameter(f"style_{i}_weight", nn.Parameter(torch.empty(512, n_in)))
            self.register_parameter(f"style_{i}_bias", nn.Parameter(torch.empty(512)))

    @torch.no_grad()
    def init_params(self, g):
        """Style heads: weight N(0, 0.01), bias 0, as the JAX module's."""
        for i in range(self.n_styles):
            w = getattr(self, f"style_{i}_weight")
            w.copy_(_normal(w.shape, 0.01, g, w.device))
            getattr(self, f"style_{i}_bias").zero_()

    def forward(self, x):
        y = self.input_prelu(self.input_bn(self.input_conv(x)))
        samm_feats, pooled = [y], []
        for layer in (self.layer1, self.layer2, self.layer3):
            y = layer(y)
            samm_feats.append(y)
            pooled.append(adaptive_avg_pool(y, (3, 3)))
        with trace.span("encoder.content", x.shape[0]):
            c = self.content_prelu(self.content_bn1(self.content_conv0(self.content_bn0(y))))
            content = self.content_bn2(self.content_conv1(c))
        pooled.append(adaptive_avg_pool(self.layer4(y), (3, 3)))
        h = torch.cat(pooled, dim=1).flatten(1)          # NCHW flatten order
        lats = [bi.matmul(h, getattr(self, f"style_{i}_weight").to(h.dtype).t())
                + getattr(self, f"style_{i}_bias").to(h.dtype) for i in range(self.n_styles)]
        return torch.stack(lats, dim=1), content, samm_feats
