"""Network architectures of the port."""

from .ood_e4e import OODFaceGANE4E

_ARCHS = {"ood_faceGAN_e4e": OODFaceGANE4E}


def build_network(opt: dict):
    """Pops `type` from a `network_g`-style dict and builds that arch from
    the remaining keys."""
    opt = dict(opt)
    net_type = opt.pop("type")
    if net_type not in _ARCHS:
        raise NotImplementedError(f"arch {net_type!r} is not ported "
                                  f"(ported: {sorted(_ARCHS)})")
    return _ARCHS[net_type](**opt)
