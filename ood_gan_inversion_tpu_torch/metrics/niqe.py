"""NIQE (counterpart of metrics/niqe.py), a no-reference quality score
computed on the host in numpy and scipy, as in the JAX package: MSCN
coefficients at two scales (the second through MATLAB's half-scale
bicubic, `data/transforms.imresize`), 18 AGGD features per 96 x 96 block
and scale, and the Mahalanobis distance of their mean and covariance to
a pristine model (Mittal et al., "Making a 'Completely Blind' Image
Quality Analyzer").

The pristine model is a file the repo does not hold: `pris_params_path`
names an .npz with mu_pris_param, cov_pris_param and optionally
gaussian_window (default: 7 x 7, sigma 7/6); without it the metric
raises.
"""

import math

import numpy as np
from scipy.ndimage import correlate
from scipy.special import gamma as _gamma

from ..data.transforms import imresize
from ..utils.registry import METRIC_REGISTRY
from .psnr_ssim import to_y_channel

# precomputed lookup for the AGGD shape parameter
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(_gamma(2.0 / _GAM)) / (_gamma(1.0 / _GAM) * _gamma(3.0 / _GAM))


def _fit_aggd(x: np.ndarray):
    """Fit an asymmetric generalized Gaussian to the coefficients `x`;
    returns (alpha, beta_left, beta_right)."""
    x = x.ravel()
    neg = x[x < 0]
    pos = x[x > 0]
    std_l = math.sqrt(np.mean(neg ** 2)) if neg.size else 0.0
    std_r = math.sqrt(np.mean(pos ** 2)) if pos.size else 0.0
    gammahat = std_l / std_r if std_r > 0 else np.inf
    mean_abs = np.mean(np.abs(x))
    rhat = mean_abs ** 2 / np.mean(x ** 2) if np.mean(x ** 2) > 0 else 0.0
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / \
        ((gammahat ** 2 + 1) ** 2)
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm) ** 2)]
    conv = math.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    return alpha, std_l * conv, std_r * conv


def _block_features(block: np.ndarray):
    """18 NIQE features of one MSCN block: marginal AGGD + 4 pairwise-product
    AGGDs (horizontal/vertical/two diagonals)."""
    feats = []
    alpha, bl, br = _fit_aggd(block)
    feats += [alpha, (bl + br) / 2.0]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        prod = block * np.roll(block, shift, axis=(0, 1))
        alpha, bl, br = _fit_aggd(prod)
        mean = (br - bl) * (_gamma(2.0 / alpha) / _gamma(1.0 / alpha))
        feats += [alpha, mean, bl, br]
    return feats


def _matlab_resize_half(img: np.ndarray) -> np.ndarray:
    """MATLAB's imresize(img, 0.5, 'bicubic') with antialiasing."""
    return imresize(img, 0.5, antialiasing=True)


def niqe_score(img_y: np.ndarray, mu_pris, cov_pris, gaussian_window,
               block_h=96, block_w=96) -> float:
    """img_y: gray/Y image (h, w), float in [0, 255]."""
    h, w = img_y.shape
    nb_h, nb_w = h // block_h, w // block_w
    img = img_y[:nb_h * block_h, :nb_w * block_w].astype(np.float64)

    per_scale = []
    for scale in (1, 2):
        mu = correlate(img, gaussian_window, mode="nearest")
        sigma = np.sqrt(np.abs(
            correlate(img * img, gaussian_window, mode="nearest") - mu * mu))
        mscn = (img - mu) / (sigma + 1.0)
        feats = []
        for iw in range(nb_w):
            for ih in range(nb_h):
                block = mscn[ih * block_h // scale:(ih + 1) * block_h // scale,
                             iw * block_w // scale:(iw + 1) * block_w // scale]
                feats.append(_block_features(block))
        per_scale.append(np.asarray(feats))
        if scale == 1:
            img = _matlab_resize_half(img / 255.0) * 255.0
    feats = np.concatenate(per_scale, axis=1)

    mu_dist = np.nanmean(feats, axis=0)
    clean = feats[~np.isnan(feats).any(axis=1)]
    cov_dist = np.cov(clean, rowvar=False)
    inv = np.linalg.pinv((cov_pris + cov_dist) / 2.0)
    d = mu_pris - mu_dist
    return float(np.sqrt(d @ inv @ d))


def default_gaussian_window(size=7, sigma=7.0 / 6.0):
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    win = np.outer(g, g)
    return win / win.sum()


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border=0, input_order="HWC", convert_to="y",
                   pris_params_path=None, **kwargs):
    """img: uint8 HWC (BGR) or gray. Requires pris_params_path (see module
    docstring) — raises a clear error otherwise."""
    if pris_params_path is None:
        raise ValueError(
            "calculate_niqe needs pris_params_path (the pristine-model "
            "mu/cov/window .npz, e.g. the reference's niqe_pris_params.npz)")
    p = np.load(pris_params_path)
    # the shipped npz stores mu as (1, 36); the Mahalanobis form wants (36,)
    mu_pris = np.ravel(p["mu_pris_param"])
    cov_pris = p["cov_pris_param"]
    window = p.get("gaussian_window", default_gaussian_window())

    img = np.asarray(img)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
    if img.ndim == 3 and img.shape[2] == 3 and convert_to == "y":
        img = to_y_channel(img)[..., 0]
    elif img.ndim == 3:
        img = img[..., 0]
    return niqe_score(np.round(img.astype(np.float64)), mu_pris, cov_pris,
                      window)
