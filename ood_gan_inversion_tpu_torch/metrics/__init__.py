"""Metric layer of the port (counterpart of metrics/): `calculate_metric`
dispatches a `val.metrics` entry by its `type`. PSNR, SSIM and LPIPS are
ported; the JAX package's identity, FID and NIQE metrics are not yet
(ROADMAP A8) and raise naming themselves."""

from copy import deepcopy

from ..utils.registry import METRIC_REGISTRY
from .lpips import LPIPSModel, calculate_lpips
from .psnr_ssim import calculate_psnr, calculate_ssim

NOT_PORTED = ("calculate_identity", "calculate_fid", "calculate_niqe")


def calculate_metric(data, opt):
    """The metric `opt["type"]` of data (img, img2, ...) with the rest of
    opt as its arguments."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    opt.pop("better", None)
    if metric_type in NOT_PORTED:
        raise NotImplementedError(f"metric {metric_type} is not ported yet (ROADMAP A8)")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)

