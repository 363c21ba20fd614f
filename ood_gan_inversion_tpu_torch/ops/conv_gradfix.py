"""A 2-D convolution whose gradients of every order run the convolution
library's own data- and weight-gradient kernels.

PyTorch's built-in double backward of a convolution computes the
weight-gradient term of a gradient (what R1 needs: d/dW of grad_x D) as a
forward convolution with the batch and channel axes swapped, whose filter
is the whole output map (1024 x 1024 at the first D layer). cuDNN runs
that with a small-tile "indexed" implicit GEMM: on an H100 it took 95% of
a 1024px step 0 (14.4 s of 16.9 s device time, 2402 calls of ~6 ms; PERF.md).
Here a convolution is an autograd Function whose backward is another such
Function: the input gradient a (transposed) convolution, the weight
gradient `aten.convolution_backward` with only its weight output (cuDNN's
wgrad kernels), each differentiable in turn. The values are those of
F.conv2d's gradients; only the kernels that compute them differ. This is
the construction of the conv2d_gradfix op of NVIDIA's StyleGAN2-ADA code.

Without grad mode, or with no operand that requires grad, `conv2d` is
F.conv2d itself.
"""

import functools

import torch
import torch.nn.functional as F


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x, weight, bias=None, stride=1, padding=0, groups=1):
    """F.conv2d(x, weight, bias, stride, padding, 1, groups)."""
    if not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return F.conv2d(x, weight, bias, stride, padding, 1, groups)
    return _ops(False, tuple(weight.shape), _pair(stride), _pair(padding), (0, 0),
                groups)[0].apply(x, weight, bias)


@functools.cache
def _ops(transpose, weight_shape, stride, padding, output_padding, groups):
    """(Conv, GradWeight): the Functions of one convolution configuration
    (transposed or not) and of its weight gradient."""

    def grad_input_op(x_shape, y_shape):
        """The op giving the gradient w.r.t. this op's input: the other
        direction, with the output padding that restores x's size."""
        if transpose:
            pad = (0, 0)
        else:
            pad = tuple(x_shape[i + 2] - (y_shape[i + 2] - 1) * stride[i]
                        - (1 - 2 * padding[i]) - (weight_shape[i + 2] - 1) for i in range(2))
        return _ops(not transpose, weight_shape, stride, padding, pad, groups)[0]

    class Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b):
            ctx.save_for_backward(x, w)
            if transpose:
                return F.conv_transpose2d(x, w, b, stride, padding, output_padding, groups)
            return F.conv2d(x, w, b, stride, padding, 1, groups)

        @staticmethod
        def backward(ctx, gy):
            x, w = ctx.saved_tensors
            gx = gw = gb = None
            if ctx.needs_input_grad[0]:
                gx = grad_input_op(x.shape, gy.shape).apply(gy, w, None)
            if ctx.needs_input_grad[1]:
                gw = GradWeight.apply(gy, x)
            if ctx.needs_input_grad[2]:
                gb = gy.sum(dim=(0, 2, 3))
            return gx, gw, gb

    class GradWeight(torch.autograd.Function):
        @staticmethod
        def forward(ctx, gy, x):
            ctx.save_for_backward(gy, x)
            w = torch.zeros((), dtype=x.dtype, device=x.device).expand(weight_shape)
            return torch.ops.aten.convolution_backward(
                gy, x, w, None, stride, padding, (1, 1), transpose, output_padding, groups,
                [False, True, False])[1]

        @staticmethod
        def backward(ctx, ggw):
            gy, x = ctx.saved_tensors
            g_gy = g_x = None
            if ctx.needs_input_grad[0]:
                g_gy = Conv.apply(x, ggw, None)
            if ctx.needs_input_grad[1]:
                g_x = grad_input_op(x.shape, gy.shape).apply(gy, ggw, None)
            return g_gy, g_x

    return Conv, GradWeight
