"""AlexNet-LPIPS perceptual distance (counterpart of nn/lpips.py), NCHW.

torchvision AlexNet's features, tapped after each of its 5 ReLUs; inputs
shifted and scaled by the LPIPS constants, each tap unit-normalized over
channels, the squared difference weighted per channel by relu(lin_i),
averaged over space and summed over taps. Parameter names are the ones
the weights bridge gives JAX's tree: 'net/conv{i}/...' -> 'net.conv{i}.*',
'lin{i}' -> 'lin{i}'. Seeded weights follow JAX's initializers: the
convs as torch's Conv2d default, lin_i the constant 1 / C_i."""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2dTorch

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)

# (out_ch, kernel, stride, pad, maxpool_after)
ALEX_LAYOUT = (
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)


def unit_normalize(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class AlexNetFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 3
        for i, (ch, k, s, p, _) in enumerate(ALEX_LAYOUT):
            self.add_module(f"conv{i}", Conv2dTorch(in_ch, ch, k, s, p))
            in_ch = ch

    def forward(self, x):
        feats = []
        for i, (_, _, _, _, pool) in enumerate(ALEX_LAYOUT):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if pool:
                x = F.max_pool2d(x, 3, 2)
        return feats


class LPIPS(nn.Module):
    """forward(x, y) -> (B,) distances of NCHW images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, (ch, *_) in enumerate(ALEX_LAYOUT):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.empty(ch)))

    @torch.no_grad()
    def init_params(self, g):
        for i, (ch, *_) in enumerate(ALEX_LAYOUT):
            getattr(self, f"lin{i}").fill_(1.0 / ch)

    def forward(self, x, y):
        shift = torch.tensor(LPIPS_SHIFT, dtype=x.dtype, device=x.device)[:, None, None]
        scale = torch.tensor(LPIPS_SCALE, dtype=x.dtype, device=x.device)[:, None, None]
        fx = self.net((x - shift) / scale)
        fy = self.net((y - shift) / scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (unit_normalize(a) - unit_normalize(b)) ** 2
            w = torch.relu(getattr(self, f"lin{i}")).to(d.dtype)
            total = total + torch.sum(d * w[:, None, None], dim=1).mean(dim=(1, 2))
        return total
