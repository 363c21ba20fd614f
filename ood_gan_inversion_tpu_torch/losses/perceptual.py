"""VGG19 perceptual + Gram-style loss (counterpart of losses/perceptual.py).
Inputs are NHWC images, like the JAX loss; the VGG runs NCHW."""

import torch
from torch import nn

from ..nn.vgg import VGGFeatureExtractor


def gram_matrix(feat):
    """NCHW feature -> (B, C, C) Gram matrix / (c * h * w), in float32."""
    n, c, h, w = feat.shape
    f = feat.float().reshape(n, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)


class PerceptualLoss(nn.Module):
    """A loss with a frozen net: `vgg` holds the VGG19 weights.
    forward(x, gt) -> (perceptual, style); either is None when its weight
    is 0. `features` and `compare` split it, so that a caller can extract
    the ground truth's features once, without grad."""

    def __init__(self, layer_weights, vgg_type="vgg19", use_input_norm=True,
                 range_norm=False, perceptual_weight=1.0, style_weight=0.0,
                 criterion="l1", dtype="float32"):
        super().__init__()
        if vgg_type != "vgg19":
            raise NotImplementedError("only vgg19 is wired up (the reference default)")
        if dtype != "float32":
            raise NotImplementedError(f"ported VGG dtype: float32; got {dtype}")
        if criterion not in ("l1", "l2", "fro"):
            raise NotImplementedError(criterion)
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight, self.style_weight = perceptual_weight, style_weight
        self.criterion = criterion
        self.vgg = VGGFeatureExtractor(tuple(self.layer_weights), use_input_norm, range_norm)

    def _crit(self, a, b):
        d = a.float() - b.float()
        if self.criterion == "l1":
            return d.abs().mean()
        if self.criterion == "l2":
            return d.square().mean()
        return torch.linalg.vector_norm(d.reshape(-1))

    def features(self, x):
        """{layer: NCHW feature} of the NHWC image batch x."""
        return self.vgg(x.permute(0, 3, 1, 2))

    def compare(self, xf, gf):
        percep = style = None
        if self.perceptual_weight > 0:
            percep = sum(self._crit(xf[k], gf[k]) * w
                         for k, w in self.layer_weights.items()) * self.perceptual_weight
        if self.style_weight and self.style_weight > 0:
            style = sum(self._crit(gram_matrix(xf[k]), gram_matrix(gf[k])) * w
                        for k, w in self.layer_weights.items()) * self.style_weight
        return percep, style

    def forward(self, x, gt):
        with torch.no_grad():
            gf = self.features(gt)
        return self.compare(self.features(x), gf)
