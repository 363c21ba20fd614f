"""Minibatch statistics of the StyleGAN2 discriminator (counterpart of
ops/stats.py), NCHW."""

import torch


def minibatch_stddev(x: torch.Tensor, stddev_group: int = 4,
                     stddev_feat: int = 1) -> torch.Tensor:
    """Appends the group-stddev feature maps (stddev_feat channels).

    The batch splits group-major, as in the JAX function: sample i is
    grouped with the samples i +- b/group, not with its neighbours. Per
    group, the biased variance over the group axis, sqrt(var + 1e-8),
    averaged over each feature's channels and the spatial axes, is tiled
    back over the group and the image."""
    b, c, h, w = x.shape
    group = min(b, stddev_group)
    y = x.reshape(group, -1, stddev_feat, c // stddev_feat, h, w)
    # the biased variance written out, as jnp.var computes it: torch.var's
    # own derivative formulas lose ~3x more precision at second order (the
    # R1 penalty differentiates through this twice)
    var = torch.square(y - y.mean(dim=0)).mean(dim=0)
    std = torch.sqrt(var + 1e-8).mean(dim=(2, 3, 4))           # (b/group, feat)
    std = std[:, :, None, None].repeat(group, 1, h, w)
    return torch.cat([x, std], dim=1)
