"""Bilinear grid sampling, the SAMM warp primitive (counterpart of
ops/grid_sample.py): torch `F.grid_sample` with mode='bilinear',
padding_mode='zeros', align_corners=False, written out as its four taps on
NHWC tensors -- the layout of the warp-blend kernel it is the plain
version of."""

import torch


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample NHWC `x` at normalized locations `grid` (N, Hg, Wg, 2).

    grid[..., 0] is the x (width) coordinate and grid[..., 1] the y
    coordinate, both in [-1, 1] under the align_corners=False mapping
    pix = ((coord + 1) * size - 1) / 2; taps outside the image read 0."""
    n, h, w, c = x.shape
    gh, gw = grid.shape[1], grid.shape[2]
    fx = ((grid[..., 0].float() + 1.0) * w - 1.0) / 2.0
    fy = ((grid[..., 1].float() + 1.0) * h - 1.0) / 2.0
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    wx = (fx - x0f).to(x.dtype)[..., None]
    wy = (fy - y0f).to(x.dtype)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    src = x.reshape(n, h * w, c)
    batch = torch.arange(n, device=x.device)[:, None]

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = src[batch, flat.reshape(n, gh * gw)].reshape(n, gh, gw, c)
        return vals * valid[..., None].to(x.dtype)

    return (tap(y0, x0) * ((1 - wx) * (1 - wy))
            + tap(y0, x0 + 1) * (wx * (1 - wy))
            + tap(y0 + 1, x0) * ((1 - wx) * wy)
            + tap(y0 + 1, x0 + 1) * (wx * wy))
