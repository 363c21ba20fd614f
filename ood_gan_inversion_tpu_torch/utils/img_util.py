"""Images <-> arrays (counterpart of utils/img_util.py), the one image codec
of the port. Arrays are RGB HWC / NHWC float; model inputs are in
[-1, 1]; `tensor2img` gives uint8 BGR, the order `imwrite` takes.

Files are read and written through OpenCV (the cv2 package), imported at
first use. Resizing needs no OpenCV: `resize_linear` is OpenCV's
INTER_LINEAR on float images (half-pixel centres), `resize_nearest` its
INTER_NEAREST."""

import os

import numpy as np

from ..ops.resize import interp_matrix


def opencv():
    """The cv2 module; ImportError naming the package where it is missing."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading and writing images needs OpenCV "
                          "(the cv2 package), which is not installed") from e
    return cv2


# --- the codec ------------------------------------------------------------------
def _to_rgb_float(bgr, float32):
    img = np.ascontiguousarray(bgr[..., ::-1])
    return img.astype(np.float32) / 255.0 if float32 else img


def imdecode(data: bytes, float32=True):
    """An encoded image's bytes as RGB HWC, float32 in [0, 1] (or uint8)."""
    cv2 = opencv()
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise IOError("failed to decode image bytes")
    return _to_rgb_float(bgr, float32)


def imread(path, float32=True):
    """An image file as RGB HWC, float32 in [0, 1] (or uint8)."""
    cv2 = opencv()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise IOError(f"Failed to read image: {path}")
    return _to_rgb_float(bgr, float32)


def imwrite(img, path, auto_mkdir=True):
    """Writes a uint8 HW (grey) or HWC BGR image; the format follows the
    file's extension."""
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not opencv().imwrite(path, img):
        raise IOError(f"Failed to write image: {path}")


# --- resizing and conversions ------------------------------------------------------
def resize_linear(img, size):
    """HWC float image -> (size, size): bilinear with half-pixel centres
    (OpenCV's INTER_LINEAR), float32."""
    img = np.asarray(img, dtype=np.float32)
    h, w, c = img.shape
    mh = interp_matrix(h, size, "bilinear", False)
    mw = interp_matrix(w, size, "bilinear", False)
    rows = (mh @ img.reshape(h, w * c)).reshape(size, w, c)          # (size, w, c)
    return np.ascontiguousarray((rows.transpose(0, 2, 1) @ mw.T).transpose(0, 2, 1))


def resize_nearest(img, size):
    """HW(C) image -> (size, size): source pixel floor(i * in / out) (OpenCV's
    INTER_NEAREST)."""
    rows = np.arange(size) * img.shape[0] // size
    cols = np.arange(size) * img.shape[1] // size
    return img[rows][:, cols]


def img2input(img, size=None, mean=0.5, std=0.5):
    """HWC [0, 1] RGB -> (1, H, W, C) float32 normalized to [-1, 1]. A
    differently sized image is first resized bilinearly (`resize_linear`)."""
    img = np.asarray(img, dtype=np.float32)
    if size is not None and img.shape[:2] != (size, size):
        img = resize_linear(img, size)
    return ((img - mean) / std)[None].astype(np.float32)


def tensor2img(t, rgb2bgr=True, min_max=(-1, 1)):
    """(H, W, C) or (N, H, W, C) in min_max -> uint8 HWC, BGR by default
    (the order `imwrite` takes)."""
    a = np.asarray(t, dtype=np.float32)
    if a.ndim == 4:
        a = a[0]
    a = np.clip((a - min_max[0]) / (min_max[1] - min_max[0]), 0, 1)
    a = (a * 255.0).round().astype(np.uint8)
    if rgb2bgr and a.shape[-1] == 3:
        a = a[..., ::-1]
    return a

