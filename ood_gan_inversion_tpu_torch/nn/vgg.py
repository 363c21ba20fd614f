"""VGG19 feature extractor of the perceptual loss (counterpart of
nn/vgg.py), NCHW. `convN_M` outputs are taken before their ReLU; the net
stops at the deepest requested layer. The convolutions of stage N are
`convN[str(M)]`, the names the weights bridge gives JAX's `convN_M`."""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2dTorch

# (name, out_channels) per conv, "pool" between stages: vgg19, config 'E'
VGG19_LAYOUT = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool", 0),
    ("conv2_1", 128), ("conv2_2", 128), ("pool", 0),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), ("pool", 0),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), ("pool", 0),
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGGFeatureExtractor(nn.Module):
    """forward(x (B, 3, H, W)) -> {name: pre-ReLU feature} for every name in
    layer_name_list. range_norm maps [-1, 1] to [0, 1] first; use_input_norm
    then applies the ImageNet mean and std."""

    def __init__(self, layer_name_list=("conv5_4",), use_input_norm=True,
                 range_norm=False):
        super().__init__()
        self.layer_name_list = tuple(layer_name_list)
        self.use_input_norm, self.range_norm = use_input_norm, range_norm
        wanted = set(self.layer_name_list)
        self.last = max(i for i, (n, _) in enumerate(VGG19_LAYOUT) if n in wanted)
        in_ch = 3
        for name, ch in VGG19_LAYOUT[:self.last + 1]:
            if name == "pool":
                continue
            stage, idx = name[:-2], name[-1]
            if not hasattr(self, stage):
                self.add_module(stage, nn.ModuleDict())
            getattr(self, stage)[idx] = Conv2dTorch(in_ch, ch, 3, 1, 1)
            in_ch = ch

    def forward(self, x):
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
            std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
            x = (x - mean[:, None, None]) / std[:, None, None]
        out = {}
        for name, _ in VGG19_LAYOUT[:self.last + 1]:
            if name == "pool":
                x = F.max_pool2d(x, 2)
                continue
            x = getattr(self, name[:-2])[name[-1]](x)
            if name in self.layer_name_list:
                out[name] = x
            x = torch.relu(x)
        return out
