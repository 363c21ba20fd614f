"""Polyphase (space-to-depth) packing of the >=512px generator tail
(counterpart of ops/polyphase.py), NHWC tensors and HWIO kernels as in JAX.

A stage's modulated upsample-conv + FIR blur becomes one 3x3 conv at the
coarse (input) resolution from Cin to 4*Cout phase-packed channels, the
same-resolution 3x3 conv a 3x3 coarse conv 4C -> 4C, the 1x1 ToRGB a
block-diagonal 1x1 conv 4C -> 12 and the skip's FIR upsample a 3x3 coarse
conv 3 -> 12. Packed channel order: (py * 2 + px) * C + c.

Work: the packed conv1 does the MACs of the zero-stuffed upsampling conv;
the packed conv2 kernel is dense, but only 9 of its 36 (output phase, tap)
blocks are non-zero (`_SEL3`), so it does 4x the MACs of the unpacked
same-resolution conv.
"""

import numpy as np
import torch

from . import batch_invariant as bi


def pack_space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, 2H, 2W, C) -> (B, H, W, 4C), packed channel = (py*2+px)*C + c."""
    b, h2, w2, c = x.shape
    x = x.reshape(b, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h2 // 2, w2 // 2, 4 * c)


def unpack_depth_to_space(xp: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of pack_space_to_depth; c is the unpacked channel count."""
    b, h, w, c4 = xp.shape
    assert c4 == 4 * c
    x = xp.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


def _upconv_coeffs(blur_kernel) -> np.ndarray:
    """A[my,mx,dy,dx,py,px] = B4[2-2d+p-m] per spatial dim, B4 = 4 * blur."""
    b4 = np.asarray(blur_kernel, dtype=np.float64) * 4.0
    assert b4.shape == (4, 4)
    a = np.zeros((3, 3, 3, 3, 2, 2))
    for my in range(3):
        for mx in range(3):
            for dy in range(-1, 2):
                for dx in range(-1, 2):
                    for py in range(2):
                        for px in range(2):
                            iy = 2 - 2 * dy + py - my
                            ix = 2 - 2 * dx + px - mx
                            if 0 <= iy < 4 and 0 <= ix < 4:
                                a[my, mx, dy + 1, dx + 1, py, px] = b4[iy, ix]
    return a


def upconv_blur_packed_kernel(w1: torch.Tensor, blur_kernel) -> torch.Tensor:
    """Composite kernel of the modulated upsample-conv + FIR blur.

    w1: (3, 3, Cin, Cout) HWIO, he scale applied; blur_kernel: the (4, 4)
    normalized FIR kernel (the up-gain 4 is applied here). Returns the
    (3, 3, Cin, 4*Cout) kernel of a padding-1 coarse conv."""
    kh, kw, cin, cout = w1.shape
    assert kh == 3 and kw == 3, "packed tail expects 3x3 styled convs"
    a = torch.as_tensor(_upconv_coeffs(blur_kernel), dtype=w1.dtype, device=w1.device)
    k = torch.einsum("yxio,yxdepq->deipqo", w1, a)
    return k.reshape(3, 3, cin, 4 * cout)


def _select_coeffs_conv3x3() -> np.ndarray:
    """S[ty,tx,ey,ex,qy,qx,py,px] = 1 when t = 2e + q - p + 1 per dim."""
    s = np.zeros((3, 3, 3, 3, 2, 2, 2, 2))
    for py in range(2):
        for px in range(2):
            for ty in range(3):
                fy = py + ty - 1
                qy, ey = fy % 2, (fy - (fy % 2)) // 2
                for tx in range(3):
                    fx = px + tx - 1
                    qx, ex = fx % 2, (fx - (fx % 2)) // 2
                    s[ty, tx, ey + 1, ex + 1, qy, qx, py, px] = 1.0
    return s


_SEL3 = _select_coeffs_conv3x3()


def conv3x3_packed_kernel(w2: torch.Tensor) -> torch.Tensor:
    """Same-resolution 3x3 conv kernel packed 4C -> 4C'. w2: (3, 3, C, C')
    HWIO, he scale applied. Returns (3, 3, 4C, 4C')."""
    kh, kw, ci, co = w2.shape
    assert kh == 3 and kw == 3
    s = torch.as_tensor(_SEL3, dtype=w2.dtype, device=w2.device)
    k = torch.einsum("yxio,yxefabpq->efabipqo", w2, s)
    return k.reshape(3, 3, 4 * ci, 4 * co)


def conv1x1_packed_kernel(w: torch.Tensor) -> torch.Tensor:
    """1x1 conv (ToRGB) packed block-diagonal. w: (1, 1, C, C') HWIO.
    Returns (1, 1, 4C, 4C')."""
    _, _, ci, co = w.shape
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    k = torch.einsum("io,ab->aibo", w[0, 0], eye)
    return k.reshape(1, 1, 4 * ci, 4 * co)


def skip_up_packed_kernel(blur_kernel, channels: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """The skip's FIR 2x upsample (pads (2, 1)) as a packed 3x3 coarse conv:
    K4[p][d] = B4[p+1-2d] per spatial dim, depthwise structure written out
    densely. Returns (3, 3, C, 4C)."""
    b4 = np.asarray(blur_kernel, dtype=np.float64) * 4.0
    k = np.zeros((3, 3, channels, 4 * channels))
    for py in range(2):
        for px in range(2):
            for dy in range(-1, 2):
                iy = py + 1 - 2 * dy
                if not 0 <= iy < 4:
                    continue
                for dx in range(-1, 2):
                    ix = px + 1 - 2 * dx
                    if not 0 <= ix < 4:
                        continue
                    for c in range(channels):
                        k[dy + 1, dx + 1, c, (py * 2 + px) * channels + c] = b4[iy, ix]
    return torch.as_tensor(k, dtype=dtype, device=device)


def conv_packed(x: torch.Tensor, kernel: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """NHWC coarse conv with an HWIO packed kernel; returns NHWC."""
    y = bi.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
                  padding=padding)
    return y.permute(0, 2, 3, 1)


def tile_phase_major(v: torch.Tensor, reps: int = 4) -> torch.Tensor:
    """Tiles a per-channel vector (..., C) to the packed layout (..., 4C)."""
    return torch.cat([v] * reps, dim=-1)
