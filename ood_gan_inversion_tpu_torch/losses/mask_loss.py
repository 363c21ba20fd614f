"""Invertibility-mask losses (counterpart of losses/mask_loss.py): a binary
loss mean(min(m, 1 - m)) on the configured sizes and an area hinge
max(0, mean(m) - area) per size, the mask inverted for target 0."""

import torch


class MaskLoss:
    def __init__(self, loss_weight=1.0, loss_func=None, **kwargs):
        loss_func = loss_func or {}
        self.loss_weight = loss_weight
        self.binary = loss_func.get("binary", [64])
        self.area = loss_func.get("area", {"64": 0.35, "128": 0.01, "256": 0.01})
        self.target = loss_func.get("target", 0)
        self.binary_weight = loss_func.get("binary_weight", 0.5)

    def __call__(self, aligns: dict):
        """aligns: {key: (B, h, w, >=3) NHWC}; the mask is channel 2 and an
        entry's size is h (the full-size composite repeats the mask over
        three channels, so its channel 2 is the mask too). Returns (binary,
        area)."""
        total_bin, total_area = 0.0, 0.0
        for align in aligns.values():
            mask = align[..., 2:]
            size = mask.shape[1]
            if size in self.binary:
                total_bin = total_bin + torch.minimum(mask, 1.0 - mask).mean()
            if str(size) in self.area:
                m = 1.0 - mask if self.target == 0 else mask
                total_area = total_area + (m.mean() - self.area[str(size)]).clamp(min=0.0)
        return (total_bin * self.binary_weight * self.loss_weight,
                total_area * self.loss_weight)
