"""ResNetArcFace, the grayscale ArcFace recognition net of ArcFaceLoss
(counterpart of nn/arcface_resnet.py), NCHW: 1-channel 128 x 128 input,
IRBlock [2, 2, 2, 2] trunk, 512-d embedding (not normalized). Every norm
is eval-mode, as the frozen pretrained net runs. The linear layers keep
torch's (out, in) layout; the bridge transposes JAX's `nn.Dense` kernels
into it."""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import batch_invariant as bi
from .layers import BatchNorm1dEval, BatchNorm2dEval, Conv2dTorch, PReLU


class Linear(nn.Module):
    """x @ weight.T + bias, weight (out, in) init N(0, 1 / in) (flax
    Dense's LeCun normal, untruncated), bias 0."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    @torch.no_grad()
    def init_params(self, g):
        self.weight.copy_(torch.randn(self.weight.shape, generator=g, device=self.weight.device)
                          / self.weight.shape[1] ** 0.5)
        self.bias.zero_()

    def forward(self, x):
        return bi.matmul(x, self.weight.to(x.dtype).t()) + self.bias.to(x.dtype)


class SEBlock(nn.Module):
    """Squeeze-excite with a PReLU between its two linear layers."""

    def __init__(self, channels, reduction=16):
        super().__init__()
        self.fc0 = Linear(channels, channels // reduction)
        self.prelu = PReLU(1)
        self.fc1 = Linear(channels // reduction, channels)

    def forward(self, x):
        y = torch.sigmoid(self.fc1(self.prelu(self.fc0(bi.mean_hw(x)))))
        return x * y[:, :, None, None]


class IRBlock(nn.Module):
    """bn0 -> conv3x3 -> bn1 -> prelu -> conv3x3(stride) -> bn2 (-> SE),
    plus the residual (1x1 conv + BN where the shape changes), -> prelu."""

    def __init__(self, in_ch, planes, stride=1, use_se=True):
        super().__init__()
        self.bn0 = BatchNorm2dEval(in_ch)
        self.conv1 = Conv2dTorch(in_ch, in_ch, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2dEval(in_ch)
        self.prelu = PReLU(1)
        self.conv2 = Conv2dTorch(in_ch, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2dEval(planes)
        self.se = SEBlock(planes) if use_se else None
        if stride != 1 or in_ch != planes:
            self.down_conv = Conv2dTorch(in_ch, planes, 1, stride, 0, bias=False)
            self.down_bn = BatchNorm2dEval(planes)
        else:
            self.down_conv = None
        self.prelu_out = PReLU(1)

    def forward(self, x):
        y = self.bn2(self.conv2(self.prelu(self.bn1(self.conv1(self.bn0(x))))))
        if self.se is not None:
            y = self.se(y)
        res = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return self.prelu_out(y + res)


class ResNetArcFace(nn.Module):
    """forward(x (B, 1, 128, 128)) -> (B, 512) embeddings."""

    def __init__(self, layers=(2, 2, 2, 2), use_se=False):
        super().__init__()
        self.conv1 = Conv2dTorch(1, 64, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2dEval(64)
        self.prelu = PReLU(1)
        in_ch = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = nn.ModuleList()
            for j in range(n):
                stride = 2 if li > 0 and j == 0 else 1
                blocks.append(IRBlock(in_ch, planes, stride, use_se))
                in_ch = planes
            self.add_module(f"layer{li + 1}", blocks)
        self.bn4 = BatchNorm2dEval(512)
        self.fc5 = Linear(512 * 8 * 8, 512)
        self.bn5 = BatchNorm1dEval(512)

    def forward(self, x):
        y = F.max_pool2d(self.prelu(self.bn1(self.conv1(x))), 2, 2)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                y = block(y)
        # dropout is eval-mode (the identity); the flatten is NCHW's order
        y = self.bn4(y)
        return self.bn5(self.fc5(y.reshape(y.shape[0], -1)))
