"""SAMM warp-blend: `bilinear(target, grid) * alpha + target * (1 - alpha)`.

Counterpart of ops/pallas_warp.py (`_warp_kernel`, its variants v2-v4,
`warp_blend_reference` and the custom_vjp of `mxu_warp_blend`).
`warp_blend` launches the hand-written CUDA kernel `csrc/warp_blend.cu` for
CUDA tensors and runs the plain version `warp_blend_reference` for CPU
tensors; there is no fallback between the two. Its backward (the Function
`WarpBlend`) differentiates the plain version. All tensors are NHWC.

`warp_blend_taps_bf16` is the SAMM option `samm_gather_bf16` (JAX's
OGI_GRIDSAMPLE=gather4bf16): the bilinear sample of the float32 target
cast to bfloat16, in bfloat16 arithmetic (the fractional weights, the
four weights, each product and each partial sum rounded to bfloat16, op by
op, as the JAX package computes it), cast back and blended with the
float32 target in float32. That is its plain version; on the card it
launches the same kernel's third instantiation (float32 in and out),
which does the same roundings in the same order. It counts its launches in
its own `.launches`.
"""

import functools

import torch

from .cuda_call import DTYPES, dispatch, entry, launch, twin_function
from .grid_sample import grid_sample_bilinear


def warp_blend_reference(target: torch.Tensor, grid: torch.Tensor,
                         alpha: torch.Tensor, taps_bf16: bool = False) -> torch.Tensor:
    """The plain PyTorch version: the SAMM warp + blend as the JAX
    `warp_blend_reference` computes it; with taps_bf16, the bilinear
    sample of the target cast to bfloat16 (JAX's gather4bf16 grid sample).
    Output keeps the target's dtype."""
    warped = grid_sample_bilinear(target.to(torch.bfloat16) if taps_bf16 else target, grid)
    return (warped.to(target.dtype) * alpha + target * (1.0 - alpha)).to(target.dtype)


def _check(target, grid, alpha):
    if target.dim() != 4:
        raise ValueError(f"target must be (B, H, W, C), got {tuple(target.shape)}")
    b, h, w, _ = target.shape
    if target.dtype not in DTYPES:
        raise TypeError(f"target dtype {target.dtype} not supported "
                        "(float32 or bfloat16)")
    if tuple(grid.shape) != (b, h, w, 2) or grid.dtype != torch.float32:
        raise ValueError(f"grid must be float32 {(b, h, w, 2)}, got "
                         f"{grid.dtype} {tuple(grid.shape)}")
    if tuple(alpha.shape) != (b, h, w, 1) or alpha.dtype != torch.float32:
        raise ValueError(f"alpha must be float32 {(b, h, w, 1)}, got "
                         f"{alpha.dtype} {tuple(alpha.shape)}")
    devs = {target.device, grid.device, alpha.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if not (target.is_contiguous() and grid.is_contiguous()
            and alpha.is_contiguous()):
        raise ValueError("warp_blend takes contiguous NHWC tensors")


# the C entry's operand code of a float32 target read with bfloat16 taps
_TAPS_BF16 = 2


def _run(target, grid, alpha, taps_bf16=False):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if target.device.type == "cpu":
        return warp_blend_reference(target, grid, alpha, taps_bf16)
    if target.device.type != "cuda":
        raise ValueError(f"warp_blend runs on cuda or cpu, not {target.device}")
    out = torch.empty_like(target)
    launch(warp_blend_taps_bf16 if taps_bf16 else warp_blend, "warp_blend",
           entry("warp_blend", "ogi_warp_blend", 4, 5), target,
           target.data_ptr(), grid.data_ptr(), alpha.data_ptr(), out.data_ptr(),
           *target.shape, _TAPS_BF16 if taps_bf16 else DTYPES[target.dtype])
    return out


WarpBlend = twin_function("WarpBlend", _run, warp_blend_reference)
WarpBlendTapsBf16 = twin_function("WarpBlendTapsBf16", functools.partial(_run, taps_bf16=True),
                                  functools.partial(warp_blend_reference, taps_bf16=True))


def warp_blend(target: torch.Tensor, grid: torch.Tensor,
               alpha: torch.Tensor) -> torch.Tensor:
    """target (B, H, W, C) float32 or bfloat16; grid (B, H, W, 2) float32
    in [-1, 1] (x then y, align_corners=False); alpha (B, H, W, 1) float32.
    Returns (B, H, W, C) in the target's dtype."""
    _check(target, grid, alpha)
    return dispatch(WarpBlend, target, grid, alpha)


def warp_blend_taps_bf16(target: torch.Tensor, grid: torch.Tensor,
                         alpha: torch.Tensor) -> torch.Tensor:
    """warp_blend of a float32 target with its taps read as bfloat16 (see
    the module docstring); arguments as warp_blend's, the target float32.
    Returns (B, H, W, C) float32."""
    _check(target, grid, alpha)
    if target.dtype != torch.float32:
        raise TypeError(f"warp_blend_taps_bf16 takes a float32 target, not {target.dtype}")
    return dispatch(WarpBlendTapsBf16, target, grid, alpha)


warp_blend.launches = 0
warp_blend_taps_bf16.launches = 0
