"""The halo probe (counterpart of tools/prof/prof_pallas_halo.py): a 3x3 box
sum with a 1-pixel zero halo over a float32 (H, W) array.

The TPU probe is a Pallas kernel written to check `pl.Element` halo
padding. Its index map and its padding both shift the window, so it does
not compute its own oracle; both functions here compute the oracle, the
zero-halo box sum. `box3x3` launches the hand-written CUDA kernel
`csrc/halo_probe.cu` for a CUDA tensor and runs `box3x3_reference` for a
CPU tensor; there is no fallback between the two. `.launches` counts
kernel launches. Its backward (the Function `Box3x3`) differentiates the
plain version.
"""

import torch
import torch.nn.functional as F

from .cuda_call import dispatch, entry, launch, on_card, twin_function


def box3x3_reference(x):
    """The plain version: x (H, W) float32; the 9 shifted windows of the
    zero-padded array added in (dy, dx) order, as the kernel adds them."""
    h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + xp[dy:dy + h, dx:dx + w]
    return out


def _run(x):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not on_card("box3x3", (x,)):
        return box3x3_reference(x)
    out = torch.empty_like(x)
    launch(box3x3, "box3x3", entry("halo_probe", "ogi_box3x3", 2, 2), x,
           x.data_ptr(), out.data_ptr(), *x.shape)
    return out


Box3x3 = twin_function("Box3x3", _run, box3x3_reference)


def box3x3(x):
    """The zero-halo 3x3 box sum of x (H, W) float32, in 8 x 8 tiles on the
    card."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"box3x3 takes a float32 (H, W) array, got {x.dtype} "
                         f"{tuple(x.shape)}")
    return dispatch(Box3x3, x)


box3x3.launches = 0
