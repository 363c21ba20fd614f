"""Batch-invariant forms of the ops whose summation order depends on the
batch size: a convolution (cuDNN and oneDNN pick their algorithm and
blocking from the whole shape, N included), a matrix product (cuBLAS picks
its kernel from M) and a reduction (PyTorch splits a sum over more or fewer
blocks as the number of outputs changes). Each runs here one sample at a
time, so sample i of a batch is computed by the same call as a batch of
one and comes out bit for bit the same. The batched per-seed decode
(infer.py) rests on this: a request's reply does not depend on its slot or
on the batch size. Elementwise ops, gathers and the hand-written kernels
are batch-invariant as they stand.
"""

import torch

from . import conv_gradfix


def per_sample(fn, *xs):
    """fn(*xs) one sample at a time: fn is called on the i-th batch row of
    every tensor in xs (each (B, ...)), and the results are concatenated
    along the batch axis."""
    n = xs[0].shape[0]
    if n == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + 1] for x in xs)) for i in range(n)])


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    """F.conv2d, sample by sample (its gradients through conv_gradfix)."""
    return per_sample(lambda v: conv_gradfix.conv2d(v, weight, bias, stride, padding, groups), x)


def mean_hw(x, keepdim=False):
    """x.mean over H, W of NCHW x, sample by sample."""
    return per_sample(lambda v: v.mean(dim=(2, 3), keepdim=keepdim), x)


def sum_hw(x):
    """x.sum over H, W of NCHW x, sample by sample."""
    return per_sample(lambda v: v.sum(dim=(2, 3)), x)


def matmul(x, m):
    """x @ m for x (B, ..., K) and a shared m (K, N), sample by sample."""
    return per_sample(lambda v: v @ m, x)
