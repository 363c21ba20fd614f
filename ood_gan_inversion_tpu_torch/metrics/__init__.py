"""Metric layer of the port (counterpart of metrics/): `calculate_metric`
dispatches a `val.metrics` entry by its `type`: PSNR, SSIM, LPIPS,
identity, NIQE and FID, as the JAX package registers them."""

from copy import deepcopy

from ..utils.registry import METRIC_REGISTRY
from .fid import calculate_fid, extract_features, feature_stats, frechet_distance
from .identity import IdentityModel, calculate_identity
from .lpips import LPIPSModel, calculate_lpips
from .niqe import calculate_niqe, default_gaussian_window, niqe_score
from .psnr_ssim import calculate_psnr, calculate_ssim


def calculate_metric(data, opt):
    """The metric `opt["type"]` of data (img, img2, ...) with the rest of
    opt as its arguments."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    opt.pop("better", None)
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
