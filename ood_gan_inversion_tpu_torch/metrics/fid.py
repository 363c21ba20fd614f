"""FID (counterpart of metrics/fid.py): feature statistics, the Frechet
distance and the metric, in numpy and scipy on the host. The features
come from any extractor of (N, D) features from an image batch, e.g.
`nn/inception.py:InceptionV3FID` on the card; with seeded weights (the
repo holds no Inception weights) the distance is only relative.
"""

import numpy as np
from scipy import linalg

from ..utils.registry import METRIC_REGISTRY


def feature_stats(features: np.ndarray):
    """(mu, sigma) of (N, D) activations."""
    features = np.asarray(features, dtype=np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """d^2 = ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)); an eps offset
    on both diagonals where sqrtm of the product is not finite."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    # sqrtm's `disp` flag is gone from newer scipy; without it sqrtm returns
    # the root alone in every version, and the check below is the same
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real

    diff = mu1 - mu2
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def extract_features(data_iter, extractor, batch_postproc=None):
    """(N, D) features of an iterator of image batches: extractor(batch)
    as a host array, optionally post-processed, flattened per sample."""
    feats = []
    for batch in data_iter:
        f = extractor(batch)
        f = np.asarray(f.cpu() if hasattr(f, "cpu") else f)
        if batch_postproc is not None:
            f = batch_postproc(f)
        feats.append(f.reshape(f.shape[0], -1))
    return np.concatenate(feats, axis=0)


@METRIC_REGISTRY.register()
def calculate_fid(feats1=None, feats2=None, stats1=None, stats2=None,
                  **kwargs):
    """FID from raw feature arrays or precomputed (mu, sigma) stats."""
    if stats1 is None:
        stats1 = feature_stats(feats1)
    if stats2 is None:
        stats2 = feature_stats(feats2)
    return frechet_distance(stats1[0], stats1[1], stats2[0], stats2[1])
