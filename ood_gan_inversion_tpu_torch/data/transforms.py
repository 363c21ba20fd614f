"""Host-side image transforms (counterpart of data/transforms.py), numpy:
MATLAB's bicubic `imresize` with its antialiasing, `mod_crop`, and the
paired crop and flip / rotate augmentations with an explicit
`numpy.random.Generator`.

`imresize` builds one dense (out, in) matrix per axis with the MATLAB
weights, symmetric edge padding folded in, and applies the two as BLAS
products in float64. Only NIQE uses it (its half-scale step); the face
datasets resize with OpenCV.
"""

import math

import numpy as np

__all__ = ["imresize", "mod_crop", "paired_random_crop", "augment"]


def _cubic(x):
    """Bicubic kernel (a = -0.5), matlab_functions.py:6-13."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) +
            (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2)))


def _resize_matrix(in_length: int, out_length: int, scale: float,
                   antialiasing: bool) -> np.ndarray:
    """Dense (out_length, in_length) resize matrix for one axis.

    Same weight/index algebra as matlab_functions.py:16-83
    `calculate_weights_indices` — including the widened antialias kernel for
    scale<1, per-row weight normalization and the first/last zero-column
    trim — but with the symmetric edge padding folded into the matrix (out-
    of-range taps reflect back into [0, in_length) and their weights
    accumulate), so the caller needs no padded intermediate image.
    """
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = math.ceil(kernel_width) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # trim all-zero first/last columns (matlab_functions.py:70-76)
    zero_cols = np.sum(weights == 0, axis=0)
    lo, hi = 0, p
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        lo, hi = 1, p - 1
    elif not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        lo, hi = 0, p - 2
    indices = indices[:, lo:hi].astype(np.int64) - 1  # to 0-based
    weights = weights[:, lo:hi]

    # symmetric reflection of out-of-range taps: ...2,1,0 | 0..n-1 | n-1,n-2...
    n = in_length
    src = indices.copy()
    neg = src < 0
    src[neg] = -src[neg] - 1
    over = src >= n
    src[over] = 2 * n - 1 - src[over]

    mat = np.zeros((out_length, in_length), dtype=np.float64)
    rows = np.repeat(np.arange(out_length), src.shape[1])
    np.add.at(mat, (rows, src.ravel()), weights.ravel())
    return mat


def imresize(img: np.ndarray, scale: float,
             antialiasing: bool = True) -> np.ndarray:
    """MATLAB-equivalent bicubic resize (matlab_functions.py:86-180).

    Args:
        img: (h, w, c) or (h, w) float array, any range (typically [0, 1]).
        scale: one scale factor for both axes; <1 downsamples.
        antialiasing: widen the kernel when downsampling (MATLAB default).

    Returns:
        (ceil(h*scale), ceil(w*scale)[, c]) float32 array, un-rounded.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    in_h, in_w = img.shape[:2]
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)

    mat_h = _resize_matrix(in_h, out_h, scale, antialiasing)
    mat_w = _resize_matrix(in_w, out_w, scale, antialiasing)
    # Two BLAS matmuls, not a 3-operand einsum (which numpy loops).
    tmp = np.tensordot(mat_h, img.astype(np.float64), axes=(1, 0))  # (H, w, c)
    out = np.tensordot(tmp, mat_w, axes=(1, 1)).transpose(0, 2, 1)  # (H, W, c)
    out = out.astype(np.float32)
    return out[:, :, 0] if squeeze else out


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop so both spatial dims divide `scale` (transforms.py:6-24)."""
    if img.ndim not in (2, 3):
        raise ValueError(f"Wrong img ndim: {img.ndim}.")
    h, w = img.shape[0] - img.shape[0] % scale, img.shape[1] - img.shape[1] % scale
    return img[:h, :w, ...].copy()


def paired_random_crop(img_gts, img_lqs, gt_patch_size: int, scale: int,
                       rng=None, gt_path=None):
    """Crop aligned GT/LQ patches at a shared random location
    (transforms.py:27-95). HWC numpy arrays or lists thereof; `rng` is a
    numpy Generator (fresh default_rng() if omitted).
    """
    rng = rng if rng is not None else np.random.default_rng()
    gts = img_gts if isinstance(img_gts, list) else [img_gts]
    lqs = img_lqs if isinstance(img_lqs, list) else [img_lqs]

    h_lq, w_lq = lqs[0].shape[:2]
    h_gt, w_gt = gts[0].shape[:2]
    lq_patch = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(
            f"Scale mismatches. GT ({h_gt}, {w_gt}) is not {scale}x of "
            f"LQ ({h_lq}, {w_lq}).")
    if h_lq < lq_patch or w_lq < lq_patch:
        raise ValueError(
            f"LQ ({h_lq}, {w_lq}) is smaller than patch size "
            f"({lq_patch}, {lq_patch}). Please remove {gt_path}.")

    top = int(rng.integers(0, h_lq - lq_patch + 1))
    left = int(rng.integers(0, w_lq - lq_patch + 1))
    lqs = [v[top:top + lq_patch, left:left + lq_patch, ...] for v in lqs]
    tg, lg = top * scale, left * scale
    gts = [v[tg:tg + gt_patch_size, lg:lg + gt_patch_size, ...] for v in gts]
    return (gts[0] if len(gts) == 1 else gts,
            lqs[0] if len(lqs) == 1 else lqs)


def augment(imgs, hflip: bool = True, rotation: bool = True, flows=None,
            return_status: bool = False, rng=None):
    """hflip / vflip / 90-degree-rotate augmentation with one shared draw for
    the whole list (transforms.py:98-170; rotation = vflip + transpose, and
    flow maps negate the flipped component). `rng` is a numpy Generator.
    """
    rng = rng if rng is not None else np.random.default_rng()
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5

    def _aug(img):
        if hflip:
            img = img[:, ::-1, ...]
        if vflip:
            img = img[::-1, :, ...]
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    def _aug_flow(flow):
        flow = np.array(flow, copy=True)
        if hflip:
            flow = flow[:, ::-1, :]
            flow[:, :, 0] *= -1
        if vflip:
            flow = flow[::-1, :, :]
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)[:, :, ::-1]
        return np.ascontiguousarray(flow)

    single = not isinstance(imgs, list)
    out = [_aug(v) for v in ([imgs] if single else imgs)]
    out = out[0] if single else out
    if flows is not None:
        fsingle = not isinstance(flows, list)
        fout = [_aug_flow(v) for v in ([flows] if fsingle else flows)]
        fout = fout[0] if fsingle else fout
        return (out, fout) if not return_status else (out, fout,
                                                      (hflip, vflip, rot90))
    if return_status:
        return out, (hflip, vflip, rot90)
    return out
