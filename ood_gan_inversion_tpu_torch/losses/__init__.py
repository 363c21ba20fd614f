"""Losses of the port (counterpart of losses/): the ones the shipped E4E
train config uses. `build_loss` builds one from a `*_opt` dict by its
`type`; a type the JAX registry has and the port has not yet raises
NotImplementedError naming it."""

from .basic import CharbonnierLoss, L1Loss, MSELoss
from .gan_loss import GANLoss, path_regularize_stats, r1_penalty_fn
from .id_loss import IDLoss
from .mask_loss import MaskLoss
from .perceptual import PerceptualLoss

_LOSSES = {c.__name__: c for c in (L1Loss, MSELoss, CharbonnierLoss, GANLoss,
                                   MaskLoss, PerceptualLoss, IDLoss)}
# registered in the JAX package, not ported yet (ROADMAP A5)
_NOT_PORTED = ("WeightedTVLoss", "MultiScaleGANLoss", "GANFeatLoss",
               "LPIPS_Loss", "ArcFaceLoss")


def build_loss(opt: dict):
    """Pops `type` and builds that loss from the remaining keys. A missing
    `type` or an unknown one raises KeyError, as the JAX registry does."""
    opt = dict(opt)
    loss_type = opt.pop("type")
    if loss_type in _NOT_PORTED:
        raise NotImplementedError(f"loss type {loss_type!r} is not ported yet "
                                  f"(ported: {sorted(_LOSSES)})")
    if loss_type not in _LOSSES:
        raise KeyError(f"no loss type {loss_type!r}")
    return _LOSSES[loss_type](**opt)
