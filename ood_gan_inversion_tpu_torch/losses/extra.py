"""The remaining losses of the BasicSR loss layer (counterpart of
losses/extra.py), so that every `type:` JAX's registry has builds here:
total variation, the multi-scale GAN loss, discriminator feature matching
and the WGAN-GP gradient penalty. No shipped config uses them and the
trainer wires none of them, as JAX's does not. Images are NHWC, like the
JAX losses."""

import torch

from .basic import CharbonnierLoss, L1Loss, MSELoss
from .gan_loss import GANLoss


class WeightedTVLoss(L1Loss):
    """L1 of the vertical plus the horizontal neighbour differences of
    pred (B, H, W, C), each optionally weighted."""

    def __call__(self, pred, weight=None):
        y_diff = pred[:, :-1, :, :] - pred[:, 1:, :, :]
        x_diff = pred[:, :, :-1, :] - pred[:, :, 1:, :]
        wy = None if weight is None else weight[:, :-1, :, :]
        wx = None if weight is None else weight[:, :, :-1, :]
        return (super().__call__(y_diff, torch.zeros_like(y_diff), weight=wy)
                + super().__call__(x_diff, torch.zeros_like(x_diff), weight=wx))


class MultiScaleGANLoss(GANLoss):
    """GANLoss averaged over a list of predictions, one per scale; an
    element that is itself a list contributes its last entry."""

    def __call__(self, preds, target_is_real, is_disc=False):
        if not isinstance(preds, (list, tuple)):
            return super().__call__(preds, target_is_real, is_disc)
        total = 0.0
        for p in preds:
            if isinstance(p, (list, tuple)):
                p = p[-1]
            total = total + super().__call__(p, target_is_real, is_disc)
        return total / len(preds)


class GANFeatLoss:
    """Feature matching: the criterion between each discriminator's fake
    and real feature maps (all but the last, the score, where there are
    several), averaged over discriminators; the real features carry no
    gradient."""

    def __init__(self, criterion="l1", loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        crits = {"l1": L1Loss, "l2": MSELoss, "mse": MSELoss, "charbonnier": CharbonnierLoss}
        if criterion not in crits:
            raise ValueError(f"unsupported criterion {criterion}")
        self.crit = crits[criterion](1.0, reduction)

    def __call__(self, pred_fake_feats, pred_real_feats):
        """Each a list over discriminators of lists of feature maps, or one
        discriminator's list."""
        if not isinstance(pred_fake_feats[0], (list, tuple)):
            pred_fake_feats, pred_real_feats = [pred_fake_feats], [pred_real_feats]
        num_d = len(pred_fake_feats)
        loss = 0.0
        for fd, rd in zip(pred_fake_feats, pred_real_feats):
            for f, r in zip(fd[:-1] if len(fd) > 1 else fd, rd[:-1] if len(rd) > 1 else rd):
                loss = loss + self.crit(f, r.detach()) / num_d
        return loss * self.loss_weight


def gradient_penalty_loss(disc_fn, real, fake, generator=None, weight=None, alpha=None):
    """WGAN-GP: mean over the batch of (|grad_x D(x)| - 1)^2 at x = alpha
    real + (1 - alpha) fake, alpha ~ U[0, 1) per sample drawn from
    `generator` unless given ((B, 1, ..., 1)); the gradient stays in the
    graph (create_graph), so the penalty differentiates w.r.t. D's
    parameters. disc_fn maps a batch to scores (or a (scores, ...) tuple);
    weight, optional, scales the gradient, and the loss is then divided by
    its mean."""
    if alpha is None:
        alpha = torch.rand((real.shape[0],) + (1,) * (real.ndim - 1), generator=generator,
                           device=real.device)
    interp = alpha * real + (1.0 - alpha) * fake
    if not interp.requires_grad:
        interp.requires_grad_()
    pred = disc_fn(interp)
    pred = pred[0] if isinstance(pred, tuple) else pred
    (grad,) = torch.autograd.grad(pred.sum(), interp, create_graph=True)
    if weight is not None:
        grad = grad * weight
    norms = torch.sqrt(grad.square().reshape(grad.shape[0], -1).sum(dim=1) + 1e-12)
    loss = torch.square(norms - 1.0).mean()
    if weight is not None:
        loss = loss / weight.mean()
    return loss
