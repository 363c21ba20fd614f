"""Network architectures of the port."""

import torch

from .ood_e4e import OODFaceGANE4E

_ARCHS = {"ood_faceGAN_e4e": OODFaceGANE4E}


def build_network(opt: dict):
    """Pops `type` from a `network_g`-style dict and builds that arch from
    the remaining keys. A string `dtype` (as YAML gives it, e.g.
    "bfloat16") becomes the torch dtype of that name."""
    opt = dict(opt)
    net_type = opt.pop("type")
    if isinstance(opt.get("dtype"), str):
        dt = getattr(torch, opt["dtype"], None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {opt['dtype']!r}")
        opt["dtype"] = dt
    if net_type not in _ARCHS:
        raise NotImplementedError(f"arch {net_type!r} is not ported "
                                  f"(ported: {sorted(_ARCHS)})")
    return _ARCHS[net_type](**opt)
