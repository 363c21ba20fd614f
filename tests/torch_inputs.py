"""Seeded numpy inputs shared by the port's CPU parity tests and its
card-only tests; imports neither JAX nor torch, so the card-only tests run
where JAX is not installed."""

import numpy as np


def warp_inputs(b, size, c, scale, seed=0, at_bound=False):
    """The inputs of tests/test_pallas_warp.py: features, linspace grid plus
    a tanh flow (or a flow pinned at +-scale), uniform alpha."""
    rs = np.random.RandomState(seed)
    x = rs.randn(b, size, size, c).astype(np.float32)
    lin = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    base = np.stack(np.broadcast_arrays(lin[None, :], lin[:, None]), -1)
    if at_bound:
        flow = np.sign(rs.randn(b, size, size, 2)) * scale
    else:
        flow = np.tanh(rs.randn(b, size, size, 2)) * scale
    grid = (base[None] + flow).astype(np.float32)
    alpha = rs.rand(b, size, size, 1).astype(np.float32)
    return x, grid, alpha


def packed_stage_inputs(b, h, w, c1, c4, seed=0):
    """Operands of one packed stage at O(1) activations: x (B, H, W, C1),
    phase-packed noise n1, n2, skip, conv kernels k1, k2 scaled by
    1/sqrt(fan-in), style scales and demodulation near 1, small biases,
    per-sample toRGB kernel k3sr and skip kernel k4. Returns a dict of
    float32 arrays in the argument order of fused_packed_stage."""
    rs = np.random.RandomState(seed)
    a = {
        "x": rs.randn(b, h, w, c1),
        "n1": 0.1 * rs.randn(b, h, w, 4),
        "n2": 0.1 * rs.randn(b, h, w, 4),
        "skip": rs.randn(b, h, w, 3),
        "k1": rs.randn(3, 3, c1, c4) / np.sqrt(9 * c1),
        "s1": rs.uniform(0.5, 1.5, (b, c1)),
        "d1": rs.uniform(0.5, 1.5, (b, c4)),
        "b1": 0.1 * rs.randn(c4),
        "k2": rs.randn(3, 3, c4, c4) / np.sqrt(9 * c4),
        "s2": rs.uniform(0.5, 1.5, (b, c4)),
        "d2": rs.uniform(0.5, 1.5, (b, c4)),
        "b2": 0.1 * rs.randn(c4),
        "k3sr": rs.randn(b, c4, 12) / np.sqrt(c4),
        "b3": 0.1 * rs.randn(12),
        "k4": 0.1 * rs.randn(3, 3, 3, 12),
    }
    return {k: v.astype(np.float32) for k, v in a.items()}


def packed_cancel_inputs(b, h, w, c1, c4, seed=0):
    """packed_stage_inputs where both convs cancel a large common offset, as
    tf32_cancel_inputs does for one: x = 1 + 0.1 * noise with s1 = 1, conv1's
    activation offset by b1 = 4 with s2 = 1, and k1, k2 summing to 0 over the
    input channels for every (tap, output channel). Every product of either
    conv carries the offset, while the sums do not."""
    a = packed_stage_inputs(b, h, w, c1, c4, seed)
    rs = np.random.RandomState(seed + 1)
    a["x"] = 1.0 + 0.1 * rs.randn(b, h, w, c1)
    a["s1"] = np.ones((b, c1))
    a["s2"] = np.ones((b, c4))
    a["b1"] = np.full(c4, 4.0)
    for k in ("k1", "k2"):
        a[k] = a[k] - a[k].mean(axis=2, keepdims=True)
    return {k: v.astype(np.float32) for k, v in a.items()}


PAIR_KEYS = ("x", "n1", "n2", "k1", "s1", "d1", "b1", "k2", "s2", "d2", "b2")


def samm_body0_inputs(b, c, h, w, seed=0):
    """Operands of AlignNet body0 over C-channel features, NCHW and OIHW,
    at O(1) activations: raw features s, t (B, C, H, W), norm1's affine g1,
    b1 (2C,), conv kernels k1, k2 (2C, 2C, 3, 3) scaled by 1/sqrt(fan-in),
    PReLU slopes alpha (2C,), norm2's affine g2, b2 (2C,). float32 arrays."""
    rs = np.random.RandomState(seed)
    c2 = 2 * c
    a = {
        "s": rs.randn(b, c, h, w),
        "t": 2.0 * rs.randn(b, c, h, w) + 0.3,
        "g1": 1.0 + 0.1 * rs.randn(c2),
        "b1": 0.1 * rs.randn(c2),
        "k1": rs.randn(c2, c2, 3, 3) / np.sqrt(9 * c2),
        "alpha": 0.25 + 0.05 * rs.randn(c2),
        "k2": rs.randn(c2, c2, 3, 3) / np.sqrt(9 * c2),
        "g2": 1.0 + 0.1 * rs.randn(c2),
        "b2": 0.1 * rs.randn(c2),
    }
    return {k: v.astype(np.float32) for k, v in a.items()}


def tf32_cancel_inputs(b, ci, co, h, w, seed=0):
    """x = 1 + 0.1 * noise (B, Ci, H, W) and k (Co, Ci, 3, 3) whose sum over
    ci is 0 for every (co, tap), float32 arrays: the common offset 1 cancels
    at every pixel, borders included (padding drops whole taps), so the
    output comes from the small part while every product carries the large
    one. Products of TF32-rounded operands (~2^-11 relative) then err by
    ~4e-3 of max|output|, a 3-term TF32 split by ~1e-6."""
    rs = np.random.RandomState(seed)
    x = 1.0 + 0.1 * rs.randn(b, ci, h, w)
    k = rs.randn(co, ci, 3, 3) / np.sqrt(9 * ci)
    k -= k.mean(axis=1, keepdims=True)
    return x.astype(np.float32), k.astype(np.float32)


def conv_act_inputs(b, ci, co, h, w, seed=0):
    """x (B, Ci, H, W), k (Co, Ci, 3, 3) scaled by 1/sqrt(fan-in) and PReLU
    slopes alpha (Co,), float32 arrays."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, ci, h, w).astype(np.float32),
            (rs.randn(co, ci, 3, 3) / np.sqrt(9 * ci)).astype(np.float32),
            (0.25 + 0.05 * rs.randn(co)).astype(np.float32))
