"""Equalized-lr, normalization and residual building blocks
(counterpart of nn/layers.py), NCHW.

Every module here creates its parameters empty and fills them in
`init_params(generator)` with the JAX package's initializer, drawn from an
explicit `torch.Generator`; `init_weights(model, seed)` does that for a whole
model. The JAX `...S` (setup-style) variants and the compact ones are one
class each here: a torch module always takes its input width explicitly.

BatchNorm is inference-only (the encoders are frozen pretrained subnets):
an affine transform by stored running statistics.
"""

import math

import torch
from torch import nn

from ..ops import batch_invariant as bi
from ..ops.fused_act import _channel_view, fused_leaky_relu
from ..ops.upfirdn2d import blur as fir_blur, make_kernel


def _uniform(shape, bound, g, device):
    return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * bound


def _normal(shape, std, g, device):
    return torch.randn(shape, generator=g, device=device) * std


class EqualLinear(nn.Module):
    """y = x @ (W * lr_mul / sqrt(in)).T + b * lr_mul, optionally followed by
    the fused lrelu. weight (out, in), init N(0, 1) / lr_mul."""

    def __init__(self, in_dim, out_dim, bias=True, bias_init=0.0, lr_mul=1.0,
                 activation=None):
        super().__init__()
        self.lr_mul, self.bias_init, self.activation = lr_mul, bias_init, activation
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None

    @torch.no_grad()
    def init_params(self, g):
        self.weight.copy_(_normal(self.weight.shape, 1.0 / self.lr_mul, g,
                                  self.weight.device))
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x):
        scale = (1.0 / math.sqrt(self.weight.shape[1])) * self.lr_mul
        y = bi.matmul(x, (self.weight * scale).to(x.dtype).t())
        b = None if self.bias is None else self.bias * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(y, b)
        return y if b is None else y + b.to(y.dtype)


class EqualConv2d(nn.Module):
    """conv(x, W / sqrt(fan_in)) + b; weight (out, in, k, k) init N(0, 1),
    bias 0."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=0,
                 bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    @torch.no_grad()
    def init_params(self, g):
        self.weight.copy_(_normal(self.weight.shape, 1.0, g, self.weight.device))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        w = self.weight * (1.0 / math.sqrt(self.weight[0].numel()))
        return bi.conv2d(x, w.to(x.dtype),
                         None if self.bias is None else self.bias.to(x.dtype),
                         stride=self.stride, padding=self.padding)


class Conv2dTorch(nn.Module):
    """Plain conv with torch nn.Conv2d's default init (kaiming uniform,
    a=sqrt(5)): U(+-1/sqrt(fan_in)) for weight and bias."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=0,
                 bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    @torch.no_grad()
    def init_params(self, g):
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.copy_(_uniform(self.weight.shape, bound, g,
                                   self.weight.device))
        if self.bias is not None:
            self.bias.copy_(_uniform(self.bias.shape, bound, g,
                                     self.bias.device))

    def forward(self, x):
        return bi.conv2d(x, self.weight.to(x.dtype),
                         None if self.bias is None else self.bias.to(x.dtype),
                         stride=self.stride, padding=self.padding)


class XavierConv(Conv2dTorch):
    """Conv with xavier-normal weights and zero bias (the SAMM convs)."""

    @torch.no_grad()
    def init_params(self, g):
        o, i, kh, kw = self.weight.shape
        std = math.sqrt(2.0 / (kh * kw * (i + o)))
        self.weight.copy_(_normal(self.weight.shape, std, g, self.weight.device))
        if self.bias is not None:
            self.bias.zero_()


class FusedLeakyReLU(nn.Module):
    """Learned per-channel bias + lrelu(0.2) * sqrt(2)."""

    def __init__(self, channels, negative_slope=0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.bias = nn.Parameter(torch.empty(channels))

    @torch.no_grad()
    def init_params(self, g):
        self.bias.zero_()

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, self.negative_slope)


class PReLU(nn.Module):
    """torch nn.PReLU(channels), init 0.25, over dim 1 of an NCHW or (N, C)
    input; PReLU(1) is nn.PReLU()'s one shared slope."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))

    @torch.no_grad()
    def init_params(self, g):
        self.weight.fill_(0.25)

    def forward(self, x):
        return torch.where(x >= 0, x, _channel_view(self.weight.to(x.dtype), x.ndim) * x)


class BatchNorm2dEval(nn.Module):
    """Inference-mode BatchNorm: (x - mean) * rsqrt(var + eps) * w + b."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    @torch.no_grad()
    def init_params(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = ((x.float() - _channel_view(self.running_mean, x.ndim))
             * _channel_view(inv, x.ndim) + _channel_view(self.bias, x.ndim))
        return y.to(x.dtype)


class BatchNorm1dEval(BatchNorm2dEval):
    """BatchNorm2dEval over (N, C)."""


class InstanceNorm2d(nn.Module):
    """torch nn.InstanceNorm2d (per sample and channel over H, W; biased
    variance), computed from single-pass moments in fp32 like the JAX
    module: var = max(E[x^2] - E[x]^2, 0)."""

    def __init__(self, channels, affine=False, eps=1e-5):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.empty(channels))
            self.bias = nn.Parameter(torch.empty(channels))
        else:
            self.weight = self.bias = None

    @torch.no_grad()
    def init_params(self, g):
        if self.weight is not None:
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        x32 = x.float()
        mean = bi.mean_hw(x32, keepdim=True)
        mean2 = bi.mean_hw(x32 * x32, keepdim=True)
        rstd = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + self.eps)
        if self.weight is not None:
            k = rstd * self.weight.float()[:, None, None]
            b = self.bias.float()[:, None, None] - mean * k
            return (x32 * k + b).to(x.dtype)
        return ((x32 - mean) * rstd).to(x.dtype)


class SEModule(nn.Module):
    """Squeeze-excite: mean -> 1x1 (no bias) -> relu -> 1x1 -> sigmoid gate."""

    def __init__(self, channels, reduction=16):
        super().__init__()
        self.fc1 = Conv2dTorch(channels, channels // reduction, 1, bias=False)
        self.fc2 = Conv2dTorch(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = bi.mean_hw(x, keepdim=True)
        s = self.fc2(torch.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class ConvLayer(nn.Module):
    """Optional FIR-blur + stride-2 downsample, EqualConv2d, then the fused
    lrelu with a learned bias (activate and bias), the scaled lrelu
    (activate, no bias) or nothing."""

    def __init__(self, in_ch, out_ch, kernel_size, downsample=False,
                 blur_kernel=(1, 3, 3, 1), bias=True, activate=True):
        super().__init__()
        self.downsample = downsample
        self.use_bias, self.activate = bias, activate
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            self.blur_pad = ((p + 1) // 2, p // 2)
            self.blur_kernel = make_kernel(blur_kernel)
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        self.conv = EqualConv2d(in_ch, out_ch, kernel_size, stride, padding,
                                bias=bias and not activate)
        self.act = FusedLeakyReLU(out_ch) if activate and bias else None

    def forward(self, x):
        if self.downsample:
            x = fir_blur(x, self.blur_kernel, pad=self.blur_pad)
        x = self.conv(x)
        if self.act is not None:
            return self.act(x)
        return fused_leaky_relu(x) if self.activate else x


class ResBlock(nn.Module):
    """conv1 (3x3) -> conv2 (3x3, downsample), plus a 1x1 downsampled skip
    without bias or activation; (out + skip) / sqrt(2)."""

    def __init__(self, in_ch, out_ch, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True,
                               blur_kernel=blur_kernel)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True,
                              blur_kernel=blur_kernel, bias=False, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fills every parameter of `model` from one generator seeded with
    `seed`, on the model's device, module by module in registration order."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(g)
    return model
