"""Modulated deformable convolution as gathers + tap-wise channel products
(counterpart of ops/deform_conv.py), NCHW, with torchvision's
`deform_conv2d` arguments: for each of the kh x kw kernel taps, sample the
input bilinearly at (base grid + tap + learned offset), with zeros outside
the image, scale it by the tap's mask, and contract its channels with the
tap's weight slice. Offsets are (dy, dx) pairs, tap-major: channel
2 (ky kw + kx) + {0, 1}. Plain PyTorch, as JAX computes it in XLA (it has
no Pallas kernel)."""

import torch


def _bilinear_sample_abs(x, py, px):
    """x (N, C, H, W) sampled at the absolute pixel positions py, px (N, Ho,
    Wo) -> (N, C, Ho, Wo); zeros outside."""
    n, c, h, w = x.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    y0, x0 = y0.long(), x0.long()
    src = x.reshape(n, c, h * w)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1)
        g = torch.gather(src, 2, flat.expand(n, c, -1)).reshape(n, c, *yi.shape[1:])
        return g * valid[:, None].to(x.dtype)

    return (tap(y0, x0) * ((1 - wy) * (1 - wx))[:, None].to(x.dtype)
            + tap(y0, x0 + 1) * ((1 - wy) * wx)[:, None].to(x.dtype)
            + tap(y0 + 1, x0) * (wy * (1 - wx))[:, None].to(x.dtype)
            + tap(y0 + 1, x0 + 1) * (wy * wx)[:, None].to(x.dtype))


def deform_conv2d(x, offset, weight, mask=None, bias=None, stride=1, padding=1):
    """x (N, Cin, H, W); offset (N, 2 kh kw, Ho, Wo); weight (Cout, Cin, kh,
    kw); mask (N, kh kw, Ho, Wo) or None; bias (Cout,) or None. Returns
    (N, Cout, Ho, Wo)."""
    n, _, h, w = x.shape
    cout, _, kh, kw = weight.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    base_y = (torch.arange(ho, device=x.device) * stride - padding).to(x.dtype)
    base_x = (torch.arange(wo, device=x.device) * stride - padding).to(x.dtype)
    gy, gx = base_y[:, None].expand(ho, wo), base_x[None, :].expand(ho, wo)
    out = torch.zeros((n, cout, ho, wo), dtype=x.dtype, device=x.device)
    for ky in range(kh):
        for kx in range(kw):
            t = ky * kw + kx
            sampled = _bilinear_sample_abs(x, gy[None] + ky + offset[:, 2 * t],
                                           gx[None] + kx + offset[:, 2 * t + 1])
            if mask is not None:
                sampled = sampled * mask[:, t:t + 1].to(x.dtype)
            out = out + torch.einsum("nchw,oc->nohw", sampled, weight[:, :, ky, kx].to(x.dtype))
    if bias is not None:
        out = out + bias.to(x.dtype)[:, None, None]
    return out
