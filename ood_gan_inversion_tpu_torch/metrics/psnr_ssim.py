"""PSNR / SSIM (counterpart of metrics/psnr_ssim.py) in numpy: uint8 HWC
(BGR) inputs, crop_border, optional Y channel (ITU-R BT.601, the MATLAB
bgr2ycbcr), SSIM with an 11x11 sigma-1.5 Gaussian window per channel,
with the JAX package's float64 / float32 casts.

SSIM's window is OpenCV's filter2D followed by the [5:-5, 5:-5] crop, as
in the JAX package.
"""

import numpy as np

from ..utils.img_util import opencv
from ..utils.registry import METRIC_REGISTRY


def bgr2ycbcr_y(img01: np.ndarray) -> np.ndarray:
    """BGR float [0, 1] -> Y float32 (MATLAB's convention; the float32 cast
    is the reference's output type)."""
    y = np.dot(img01, [24.966, 128.553, 65.481]) + 16.0
    return (y / 255.0).astype(np.float32)


def to_y_channel(img: np.ndarray) -> np.ndarray:
    img = img.astype(np.float32) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr_y(img)
        img = img[..., None]
    return img * 255.0


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border, input_order="HWC",
                   test_y_channel=False, **kwargs):
    if img.shape != img2.shape:
        raise ValueError(f"image shapes differ: {img.shape} and {img2.shape}")
    img = img.astype(np.float64)
    img2 = img2.astype(np.float64)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def gaussian_kernel(size=11, sigma=1.5):
    """A normalized float64 Gaussian (OpenCV's getGaussianKernel)."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return k / k.sum()


def _filter_valid(img, k):
    """The correlation of HW img with outer(k, k) at every position whose
    window lies inside img, in img's dtype."""
    half = k.size // 2
    return opencv().filter2D(img, -1, np.outer(k, k))[half:-half, half:-half]


def _ssim_one(img, img2):
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    k = gaussian_kernel(11, 1.5)
    mu1 = _filter_valid(img, k)
    mu2 = _filter_valid(img2, k)
    mu1_sq = mu1 ** 2
    mu2_sq = mu2 ** 2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _filter_valid(img ** 2, k) - mu1_sq
    sigma2_sq = _filter_valid(img2 ** 2, k) - mu2_sq
    sigma12 = _filter_valid(img * img2, k) - mu1_mu2
    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) /
                ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    return ssim_map.mean()


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border, input_order="HWC",
                   test_y_channel=False, **kwargs):
    if img.shape != img2.shape:
        raise ValueError(f"image shapes differ: {img.shape} and {img2.shape}")
    img = img.astype(np.float64)
    img2 = img2.astype(np.float64)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    ssims = [_ssim_one(img[..., i], img2[..., i]) for i in range(img.shape[2])]
    return float(np.mean(ssims))
