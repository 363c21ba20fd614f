"""SAMM warp-blend: `bilinear(target, grid) * alpha + target * (1 - alpha)`.

Counterpart of ops/pallas_warp.py (`_warp_kernel`, its variants v2-v4 and
`warp_blend_reference`). `warp_blend` launches the hand-written CUDA kernel
`csrc/warp_blend.cu` for CUDA tensors and runs the plain version
`warp_blend_reference` for CPU tensors; there is no fallback between the
two. All tensors are NHWC.
"""

import torch

from .cuda_call import DTYPES, entry, launch
from .grid_sample import grid_sample_bilinear


def warp_blend_reference(target: torch.Tensor, grid: torch.Tensor,
                         alpha: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the SAMM warp + blend as the JAX
    `warp_blend_reference` computes it. Output keeps the target's dtype."""
    warped = grid_sample_bilinear(target, grid)
    return (warped * alpha + target * (1.0 - alpha)).to(target.dtype)


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


def warp_blend(target: torch.Tensor, grid: torch.Tensor,
               alpha: torch.Tensor) -> torch.Tensor:
    """target (B, H, W, C) float32 or bfloat16; grid (B, H, W, 2) float32
    in [-1, 1] (x then y, align_corners=False); alpha (B, H, W, 1) float32.
    Returns (B, H, W, C) in the target's dtype."""
    _check(target, grid, alpha)
    if target.device.type == "cpu":
        return warp_blend_reference(target, grid, alpha)
    if target.device.type != "cuda":
        raise ValueError(f"warp_blend runs on cuda or cpu, not {target.device}")
    out = torch.empty_like(target)
    launch("warp_blend", entry("warp_blend", "ogi_warp_blend", 4, 5), target,
           target.data_ptr(), grid.data_ptr(), alpha.data_ptr(), out.data_ptr(),
           *target.shape, DTYPES[target.dtype])
    warp_blend.launches += 1
    return out


warp_blend.launches = 0
