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
