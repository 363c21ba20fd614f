"""Losses of the port (counterpart of losses/): every type JAX's loss
registry has. `build_loss` builds one from a `*_opt` dict by its `type`."""

from .basic import CharbonnierLoss, L1Loss, MSELoss
from .extra import GANFeatLoss, MultiScaleGANLoss, WeightedTVLoss, gradient_penalty_loss
from .gan_loss import GANLoss, path_regularize_stats, r1_penalty_fn
from .id_loss import ArcFaceLoss, IDLoss
from .lpips_loss import LPIPS_Loss
from .mask_loss import MaskLoss
from .perceptual import PerceptualLoss

_LOSSES = {c.__name__: c for c in (L1Loss, MSELoss, CharbonnierLoss, GANLoss,
                                   MaskLoss, PerceptualLoss, IDLoss, ArcFaceLoss,
                                   WeightedTVLoss, MultiScaleGANLoss, GANFeatLoss,
                                   LPIPS_Loss)}


def build_loss(opt: dict):
    """Pops `type` and builds that loss from the remaining keys. A missing
    `type` or an unknown one raises KeyError, as the JAX registry does."""
    opt = dict(opt)
    loss_type = opt.pop("type")
    if loss_type not in _LOSSES:
        raise KeyError(f"no loss type {loss_type!r}")
    return _LOSSES[loss_type](**opt)
