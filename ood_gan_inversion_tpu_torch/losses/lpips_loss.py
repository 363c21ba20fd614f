"""LPIPS_Loss (counterpart of losses/lpips_loss.py): the AlexNet-LPIPS
distance of nn/lpips.py as a registered loss. The trainer does not use it.

It keeps the reference's double normalization: pred and target are first
min-max rescaled to [0, 1] by `min_max` ((0, 1) by default leaves [-1, 1]
images as they are), then mapped by 2x - 1 as the lpips package's
normalize=True does, so [-1, 1] images reach the net in [-3, 1]. The
loss values are the reference's."""

from torch import nn

from ..nn.lpips import LPIPS


class LPIPS_Loss(nn.Module):  # noqa: N801 (the registry's name)
    """forward(pred, target) of NHWC images -> (loss, None). `net` holds
    the AlexNet and lin weights (the bridge's "lpips" subtree). Only the
    alex net exists, the reference's default."""

    def __init__(self, loss_weight=1.0, min_max=(0.0, 1.0), net="alex", model_path=None,
                 reduction="mean"):
        super().__init__()
        if net != "alex":
            raise NotImplementedError(
                "LPIPS_Loss: only the alex net is supported (the reference default)")
        self.loss_weight = float(loss_weight)
        self.min_max = (float(min_max[0]), float(min_max[1]))
        self.reduction = reduction
        self.net = LPIPS()

    def forward(self, pred, target, normalize=True):
        if normalize:
            lo, hi = self.min_max
            pred = ((pred - lo) / (hi - lo)) * 2.0 - 1.0
            target = ((target - lo) / (hi - lo)) * 2.0 - 1.0
        d = self.net(pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2))
        if self.reduction == "mean":
            d = d.mean()
        elif self.reduction == "sum":
            d = d.sum()
        return d * self.loss_weight, None
