"""Pixel losses (counterpart of losses/basic.py): elementwise on any
layout, optionally weighted, reduced by mean, sum or not at all."""

import torch


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


class L1Loss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight, self.reduction = loss_weight, reduction

    def __call__(self, pred, target, weight=None):
        d = torch.abs(pred - target)
        if weight is not None:
            d = d * weight
        return self.loss_weight * _reduce(d, self.reduction)


class MSELoss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight, self.reduction = loss_weight, reduction

    def __call__(self, pred, target, weight=None):
        d = torch.square(pred - target)
        if weight is not None:
            d = d * weight
        return self.loss_weight * _reduce(d, self.reduction)


class CharbonnierLoss:
    def __init__(self, loss_weight=1.0, reduction="mean", eps=1e-12):
        self.loss_weight, self.reduction, self.eps = loss_weight, reduction, eps

    def __call__(self, pred, target, weight=None):
        d = torch.sqrt(torch.square(pred - target) + self.eps)
        if weight is not None:
            d = d * weight
        return self.loss_weight * _reduce(d, self.reduction)
