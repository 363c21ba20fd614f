"""Image <-> array helpers (counterpart of utils/img_util.py) in numpy,
without OpenCV. Arrays are RGB HWC / NHWC float; model inputs are in
[-1, 1]."""

import numpy as np

from ..ops.resize import interp_matrix


def img2input(img, size=None, mean=0.5, std=0.5):
    """HWC [0, 1] RGB -> (1, H, W, C) float32 normalized to [-1, 1]. A
    differently sized image is first resized bilinearly (half-pixel
    centres, as OpenCV's INTER_LINEAR)."""
    img = np.asarray(img, dtype=np.float32)
    if size is not None and img.shape[:2] != (size, size):
        mh = interp_matrix(img.shape[0], size, "bilinear", False)
        mw = interp_matrix(img.shape[1], size, "bilinear", False)
        img = np.einsum("oh,hwc,pw->opc", mh, img, mw).astype(np.float32)
    return ((img - mean) / std)[None].astype(np.float32)


def tensor2img(t, rgb2bgr=True, min_max=(-1, 1)):
    """(H, W, C) or (N, H, W, C) in min_max -> uint8 HWC, BGR by default
    (the order image writers such as OpenCV expect)."""
    a = np.asarray(t, dtype=np.float32)
    if a.ndim == 4:
        a = a[0]
    a = np.clip((a - min_max[0]) / (min_max[1] - min_max[0]), 0, 1)
    a = (a * 255.0).round().astype(np.uint8)
    if rgb2bgr and a.shape[-1] == 3:
        a = a[..., ::-1]
    return a
