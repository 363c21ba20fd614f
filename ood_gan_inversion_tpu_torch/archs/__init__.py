"""Network architectures of the port."""

import torch

from .discriminators import LatentDiscriminator, StyleGAN2DiscriminatorMod
from .ood_e4e import OODFaceGANE4E
from .ood_featurestyle import OODFaceGANFeatureStyle
from .ood_restyle import OODFaceGANReStyle

# network_g keys of the curriculum and of checkpoint loading, not the arch's
_NON_ARCH_KEYS = (
    "stage", "progressiveModSize", "progressiveStart", "progressiveStep",
    "progressiveStageSteps", "progressiveModFrozen", "ModDropout_p", "ModSize",
    "eval_path_length", "merge", "aug_alignment", "aug_inputcolor")


def arch_options(network_g: dict) -> dict:
    """network_g without its curriculum and checkpoint keys (`*_pth`,
    `*_pth_key`): the arch's constructor keys and `type`."""
    return {k: v for k, v in network_g.items()
            if not (k.endswith("_pth") or k.endswith("_pth_key") or k in _NON_ARCH_KEYS)}


_ARCHS = {"ood_faceGAN_e4e": OODFaceGANE4E,
          "ood_faceGAN_restyle": OODFaceGANReStyle,
          "ood_faceGAN_FeatureStyle": OODFaceGANFeatureStyle,
          "StyleGAN2Discriminator_mod": StyleGAN2DiscriminatorMod,
          "LatentDiscrinimator": LatentDiscriminator}     # sic, the reference's name


def arch_dtype(opt: dict) -> torch.dtype:
    """The activations' dtype a `network_*` dict asks for: its `dtype`, a
    torch dtype or the name of one (as YAML gives it, e.g. "bfloat16");
    float32 without it."""
    dt = opt.get("dtype", torch.float32)
    if isinstance(dt, str):
        dt = getattr(torch, dt, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {opt['dtype']!r}")
    return dt


def build_network(opt: dict):
    """Pops `type` from a `network_*` dict and builds that arch from
    the remaining keys, `dtype` as arch_dtype reads it."""
    opt = dict(opt)
    net_type = opt.pop("type")
    if "dtype" in opt:
        opt["dtype"] = arch_dtype(opt)
    if net_type not in _ARCHS:
        raise KeyError(f"{net_type!r} not found in the arch registry; known: {sorted(_ARCHS)}")
    return _ARCHS[net_type](**opt)
