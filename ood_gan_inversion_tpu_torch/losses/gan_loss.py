"""GAN losses and the gradient regularizers (counterpart of
losses/gan_loss.py). R1 and the path-length penalty differentiate with
torch.autograd.grad(create_graph=True), so the penalty's own gradient
reaches the parameters."""

import torch
import torch.nn.functional as F


class GANLoss:
    """gan_type in {vanilla, lsgan, wgan, wgan_softplus, hinge}; loss_weight
    scales the generator's loss only."""

    def __init__(self, gan_type="wgan_softplus", real_label_val=1.0,
                 fake_label_val=0.0, loss_weight=1.0):
        if gan_type not in ("vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"):
            raise NotImplementedError(f"gan_type {gan_type}")
        self.gan_type = gan_type
        self.real_label_val, self.fake_label_val = real_label_val, fake_label_val
        self.loss_weight = loss_weight

    def __call__(self, pred, target_is_real: bool, is_disc: bool = False):
        t = self.gan_type
        if t == "hinge":
            if is_disc:
                loss = torch.relu(1.0 + (-pred if target_is_real else pred)).mean()
            else:
                loss = -pred.mean()
        elif t == "wgan":
            loss = -pred.mean() if target_is_real else pred.mean()
        elif t == "wgan_softplus":
            loss = F.softplus(-pred if target_is_real else pred).mean()
        else:
            label = self.real_label_val if target_is_real else self.fake_label_val
            if t == "vanilla":      # BCE with logits
                loss = (torch.clamp(pred, min=0) - pred * label
                        + torch.log1p(torch.exp(-pred.abs()))).mean()
            else:                   # lsgan
                loss = torch.square(pred - label).mean()
        return loss if is_disc else loss * self.loss_weight


def r1_penalty_fn(disc_fn, real):
    """R1 = mean over the batch of sum(grad_x D(x)^2). disc_fn maps an image
    batch to per-sample scores (or a (scores, ...) tuple); the gradient is
    kept in the graph, so the penalty differentiates w.r.t. D's parameters."""
    real = real.detach().requires_grad_()
    pred = disc_fn(real)
    pred = pred[0] if isinstance(pred, tuple) else pred
    (grad,) = torch.autograd.grad(pred.sum(), real, create_graph=True)
    return grad.square().reshape(real.shape[0], -1).sum(dim=1).mean()


def path_regularize_stats(grad_wrt_latents, mean_path_length, decay=0.01):
    """Given d(sum(fake * noise)) / d(latents) (B, n_latent, D): (path
    penalty, mean path length, updated running mean, detached)."""
    path_lengths = torch.sqrt(grad_wrt_latents.square().sum(dim=2).mean(dim=1))
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    penalty = torch.square(path_lengths - path_mean).mean()
    return penalty, path_lengths.mean(), path_mean.detach()
