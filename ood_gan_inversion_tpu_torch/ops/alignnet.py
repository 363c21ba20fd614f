"""AlignNet body0 by moments folding (counterpart of the XLA functions in
ops/pallas_kernels.py: `_alignnet_coeffs`, `alignnet_body0_reference`,
`alignnet_t_context`, `algebraic_alignnet_body0`), NCHW, OIHW weights.

body0 is AlignNet's entry InstanceNorm + concat + the first bottleneck:

    h = [IN(s) - IN(t), IN(t)]
    out = IN_affine2(conv2(prelu(conv1(IN_affine1(h))))) + h

Every step before conv1 is a per-(batch, channel) affine map of (s, t) once
the joint moments are known, so norm1(h) = [as*s + at*t + b1, ct*t + b2]
and conv1 splits into a conv of the s-dependent half plus a conv of the
t-only half. Within one SAMM block the encoder feature t does not change
across align cycles, so `alignnet_t_context` computes the t-only half once.
`algebraic_alignnet_body0` is plain PyTorch, the JAX package's default path.

`fused_alignnet_body0` computes the same body0 with two hand-written CUDA
kernels (csrc/alignnet_conv1.cu, csrc/alignnet_conv2.cu, both the
tensor-core conv of csrc/samm_conv.cuh) between plain PyTorch passes: the
coefficients, then `alignnet_conv1` (x1 built on chip, conv1, PReLU), then
`alignnet_conv2` (conv2 and norm2's moments), then the norm2 affine and the
shortcut. Each wrapper launches its kernel for CUDA tensors and runs its
plain version (`alignnet_conv1_reference`, `alignnet_conv2_reference`) for
CPU tensors, and counts its launches in `.launches`. Their backwards (the
Functions `AlignNetConv1`, `AlignNetConv2`) differentiate the plain
versions, so `fused_alignnet_body0`, which composes them, differentiates
as JAX's custom_vjp does: through the reference.
"""

import torch

from . import batch_invariant as bi
from .cuda_call import activation, dispatch, entry, expect, launch, on_card, twin_function

# the channel floor of the fused path (C, as in JAX); tests lower it to run
# narrow widths through the kernels
FUSED_MIN_CHANNELS = 64


def _mean_hw(x):
    return bi.mean_hw(x)


def _cv(v):
    """(B, C) -> (B, C, 1, 1)."""
    return v[:, :, None, None]


def _conv(v, k):
    return bi.conv2d(v, k.to(v.dtype), padding=1)


def _alignnet_coeffs(s32, t32, g1, b1, diff_f_and_g: bool, eps: float):
    """The five per-(b, c) coefficients (B, 5, C) [as, at, b1h, ct, b2h] and
    the shortcut halves (IN(s) - IN(t) or IN(s), IN(t))."""
    c = s32.shape[1]
    es, et = _mean_hw(s32), _mean_hw(t32)
    ess, ett, est = _mean_hw(s32 * s32), _mean_hw(t32 * t32), _mean_hw(s32 * t32)
    vs = torch.clamp(ess - es * es, min=0.0)
    vt = torch.clamp(ett - et * et, min=0.0)
    inv_s, inv_t = torch.rsqrt(vs + eps), torch.rsqrt(vt + eps)
    ga, gb = g1[:c].float(), g1[c:].float()
    ba, bb = b1[:c].float(), b1[c:].float()
    if diff_f_and_g:
        cov = est - es * et
        vd = torch.clamp(vs * inv_s * inv_s + vt * inv_t * inv_t
                         - 2.0 * cov * inv_s * inv_t, min=0.0)
        rd = torch.rsqrt(vd + eps)
        as_ = inv_s * rd * ga
        at_ = -inv_t * rd * ga
        b1h = (et * inv_t - es * inv_s) * rd * ga + ba
    else:
        r1 = torch.rsqrt(vs * inv_s * inv_s + eps)
        as_ = inv_s * r1 * ga
        at_ = torch.zeros_like(as_)
        b1h = -es * inv_s * r1 * ga + ba
    r2 = torch.rsqrt(vt * inv_t * inv_t + eps)
    ct_ = inv_t * r2 * gb
    b2h = -et * inv_t * r2 * gb + bb
    coeffs = torch.stack([as_, at_, b1h, ct_, b2h], dim=1)
    sn = (s32 - _cv(es)) * _cv(inv_s)
    tn = (t32 - _cv(et)) * _cv(inv_t)
    return coeffs, (sn - tn if diff_f_and_g else sn), tn


def alignnet_body0_reference(s, t, g1, b1, k1, alpha, k2, g2, b2,
                             diff_f_and_g: bool = True, eps: float = 1e-5):
    """The literal module dataflow (entry IN, concat, bottleneck)."""

    def inorm(x, gamma=None, beta=None):
        mean = bi.mean_hw(x, keepdim=True)
        mean2 = bi.mean_hw(x * x, keepdim=True)
        y = (x - mean) * torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + eps)
        if gamma is not None:
            y = y * _cv(gamma[None].to(y.dtype)) + _cv(beta[None].to(y.dtype))
        return y

    s32, t32 = s.float(), t.float()
    sn, tn = inorm(s32), inorm(t32)
    h = torch.cat([sn - tn, tn] if diff_f_and_g else [sn, tn], dim=1)
    z = _conv(inorm(h, g1, b1), k1)
    z = torch.where(z >= 0, z, _cv(alpha[None].to(z.dtype)) * z)
    return (inorm(_conv(z, k2), g2, b2) + h).to(s.dtype)


def alignnet_t_context(t, g1, b1, k1, eps: float = 1e-5):
    """The cycle-invariant, t-only terms of algebraic_alignnet_body0: the
    t-moments, IN(t), and the t-half of conv1."""
    c = t.shape[1]
    t32 = t.float()
    et = _mean_hw(t32)
    vt = torch.clamp(_mean_hw(t32 * t32) - et * et, min=0.0)
    inv_t = torch.rsqrt(vt + eps)
    gb, bb = g1[c:].float(), b1[c:].float()
    r2 = torch.rsqrt(vt * inv_t * inv_t + eps)
    x1b = (_cv(inv_t * r2 * gb) * t32 + _cv(-et * inv_t * r2 * gb + bb)).to(t.dtype)
    zb = _conv(x1b, k1[:, c:])
    tn = ((t32 - _cv(et)) * _cv(inv_t)).to(t.dtype)
    return {"et": et, "vt": vt, "inv_t": inv_t, "tn": tn, "zb": zb}


def algebraic_alignnet_body0(s, t, g1, b1, k1, alpha, k2, g2, b2,
                             diff_f_and_g: bool = True, eps: float = 1e-5,
                             t_ctx=None):
    """body0 from (s, t) by the folded coefficients. s: generator feature,
    t: encoder feature, both (B, C, H, W) before the entry IN; g1/b1 (2C,)
    norm1 affine, k1 (2C, 2C, 3, 3), alpha (2C,) PReLU slopes, k2
    (2C, 2C, 3, 3), g2/b2 (2C,) norm2 affine. t_ctx: alignnet_t_context(t)
    for a t reused across calls."""
    c = s.shape[1]
    s32, t32 = s.float(), t.float()
    if t_ctx is not None:
        et, vt, inv_t = t_ctx["et"], t_ctx["vt"], t_ctx["inv_t"]
        es = _mean_hw(s32)
        vs = torch.clamp(_mean_hw(s32 * s32) - es * es, min=0.0)
        inv_s = torch.rsqrt(vs + eps)
        ga, ba = g1[:c].float(), b1[:c].float()
        if diff_f_and_g:
            cov = _mean_hw(s32 * t32) - es * et
            vd = torch.clamp(vs * inv_s * inv_s + vt * inv_t * inv_t
                             - 2.0 * cov * inv_s * inv_t, min=0.0)
            rd = torch.rsqrt(vd + eps)
            as_, at_ = inv_s * rd * ga, -inv_t * rd * ga
            b1h = (et * inv_t - es * inv_s) * rd * ga + ba
        else:
            r1 = torch.rsqrt(vs * inv_s * inv_s + eps)
            as_, at_ = inv_s * r1 * ga, torch.zeros_like(inv_s)
            b1h = -es * inv_s * r1 * ga + ba
        x1a = (_cv(as_) * s32 + _cv(at_) * t32 + _cv(b1h)).to(s.dtype)
        z = _conv(x1a, k1[:, :c]) + t_ctx["zb"]
        sn = ((s32 - _cv(es)) * _cv(inv_s)).to(s.dtype)
        h1 = sn - t_ctx["tn"] if diff_f_and_g else sn
        h2 = t_ctx["tn"]
    else:
        coeffs, h1, h2 = _alignnet_coeffs(s32, t32, g1, b1, diff_f_and_g, eps)
        h1, h2 = h1.to(s.dtype), h2.to(s.dtype)
        as_, at_, b1h, ct_, b2h = (_cv(coeffs[:, i]) for i in range(5))
        x1a = (as_ * s32 + at_ * t32 + b1h).to(s.dtype)
        x1b = (ct_ * t32 + b2h).to(s.dtype)
        z = _conv(x1a, k1[:, :c]) + _conv(x1b, k1[:, c:])
    z = torch.where(z >= 0, z, _cv(alpha[None].to(z.dtype)) * z)
    y2f = _conv(z, k2).float()
    mu2 = bi.mean_hw(y2f, keepdim=True)
    v2 = torch.clamp(bi.mean_hw(y2f * y2f, keepdim=True) - mu2 * mu2, min=0.0)
    kk = torch.rsqrt(v2 + eps) * _cv(g2[None].float())
    bb = _cv(b2[None].float()) - mu2 * kk
    h = torch.cat([h1, h2], dim=1)
    return ((y2f * kk + bb).to(s.dtype) + h).to(s.dtype)


# ------------------------------------------------------- fused body0 (B2)

def alignnet_body0_supported(c: int) -> bool:
    """Whether body0 over C-channel features takes the fused path. JAX also
    requires 2C <= 512, because its TPU kernels block the whole 3x3 weights
    into VMEM; the CUDA kernels stream the weights through shared memory in
    chunks, so the port keeps only the channel floor and runs every SAMM
    scale of the 1024px model (2C up to 1024) fused."""
    return c >= FUSED_MIN_CHANNELS


def alignnet_conv1_reference(s, t, coeffs, k1, alpha):
    """The plain version of the first fused kernel: x1 = [as*s + at*t + b1,
    ct*t + b2] (coeffs (B, 5, C) float32), in s.dtype, zero outside the
    image; z = prelu(conv3x3(x1, k1)). s, t (B, C, H, W); k1 (2C, 2C, 3, 3);
    alpha (2C,). Returns z (B, 2C, H, W) in s.dtype."""
    s32, t32 = s.float(), t.float()
    as_, at_, b1h, ct_, b2h = (_cv(coeffs[:, i]) for i in range(5))
    x1 = torch.cat([as_ * s32 + at_ * t32 + b1h, ct_ * t32 + b2h], dim=1).to(s.dtype)
    z = _conv(x1, k1)
    return torch.where(z >= 0, z, _cv(alpha[None].to(z.dtype)) * z)


def alignnet_conv2_reference(z, k2):
    """The plain version of the second fused kernel: y2 = conv3x3(z, k2) in
    float32 and part (B, 2, 2C) = [sum y2, sum y2^2] over H, W."""
    y2 = _conv(z, k2).float()
    return y2, torch.stack([bi.sum_hw(y2), bi.sum_hw(y2 * y2)], dim=1)


def _conv1_run(s, t, coeffs, k1, alpha):
    """B2a's kernel for CUDA tensors, its plain version for CPU tensors."""
    if not on_card("alignnet_conv1", (s, t, coeffs, k1, alpha)):
        return alignnet_conv1_reference(s, t, coeffs, k1, alpha)
    b, c, h, w = s.shape
    z = s.new_empty((b, 2 * c, h, w))
    launch(alignnet_conv1, "alignnet_conv1",
           entry("alignnet_conv1", "ogi_alignnet_conv1", 6, 5), s,
           *(v.data_ptr() for v in (s, t, coeffs, k1, alpha, z)), b, h, w, c,
           activation(s, "alignnet_conv1"))
    return z


AlignNetConv1 = twin_function("AlignNetConv1", _conv1_run, alignnet_conv1_reference)


def alignnet_conv1(s, t, coeffs, k1, alpha):
    """B2a: arguments and result as alignnet_conv1_reference; s, t and k1
    float32 or bfloat16 (the same), coeffs and alpha float32."""
    activation(s, "alignnet_conv1")
    b, c, h, w = s.shape
    expect("t", t, s.shape, s.dtype)
    expect("coeffs", coeffs, (b, 5, c), torch.float32)
    expect("k1", k1, (2 * c, 2 * c, 3, 3), s.dtype)
    expect("alpha", alpha, (2 * c,), torch.float32)
    return dispatch(AlignNetConv1, s, t, coeffs, k1, alpha)


alignnet_conv1.launches = 0


def _conv2_run(z, k2):
    """B2b's kernel for CUDA tensors, its plain version for CPU tensors."""
    if not on_card("alignnet_conv2", (z, k2)):
        return alignnet_conv2_reference(z, k2)
    b, c2, h, w = z.shape
    n_tiles = entry("alignnet_conv2", "ogi_samm_conv_tiles", 0, 3, stream=False)(h, w, c2)
    y2 = z.new_empty((b, c2, h, w), dtype=torch.float32)
    tile_part = z.new_empty((b, n_tiles, 2, c2), dtype=torch.float32)
    part = z.new_empty((b, 2, c2), dtype=torch.float32)
    launch(alignnet_conv2, "alignnet_conv2",
           entry("alignnet_conv2", "ogi_alignnet_conv2", 5, 5), z,
           *(v.data_ptr() for v in (z, k2, y2, tile_part, part)), b, h, w, c2,
           activation(z, "alignnet_conv2"))
    return y2, part


AlignNetConv2 = twin_function("AlignNetConv2", _conv2_run, alignnet_conv2_reference)


def alignnet_conv2(z, k2):
    """B2b: y2 (B, 2C, H, W) float32 and part (B, 2, 2C) float32 as
    alignnet_conv2_reference; z and k2 float32 or bfloat16 (the same). The
    kernel runs on the tensor cores as conv3x3_act does. Each
    block of the kernel writes the moments of its pixel tile into a scratch,
    which a fixed-order pass then sums: no atomics, so the moments are
    bit-identical from call to call and in every batch slot."""
    activation(z, "alignnet_conv2")
    expect("k2", k2, (z.shape[1], z.shape[1], 3, 3), z.dtype)
    return dispatch(AlignNetConv2, z, k2)


alignnet_conv2.launches = 0


def fused_alignnet_body0(s, t, g1, b1, k1, alpha, k2, g2, b2,
                         diff_f_and_g: bool = True, eps: float = 1e-5):
    """body0 through the two fused kernels; arguments and result as
    algebraic_alignnet_body0 (without t_ctx). The coefficients and the
    shortcut halves come from the joint moments of (s, t); after the
    kernels, norm2's affine comes from their moments: mu = sum y / n,
    v = max(sum y^2 / n - mu^2, 0). Unlike JAX's kernels, these take
    2C = 1024 (alignnet_body0_supported keeps only JAX's channel floor).
    s and t may be strided views (SPMWarp's aligned feature is the NHWC
    warp output permuted to NCHW); the kernels read them as contiguous NCHW
    copies."""
    n = s.shape[2] * s.shape[3]
    s, t = s.contiguous(), t.contiguous()
    coeffs, h1, h2 = _alignnet_coeffs(s.float(), t.float(), g1, b1, diff_f_and_g, eps)
    z = alignnet_conv1(s, t, coeffs, k1.to(s.dtype), alpha.float())
    y2, part = alignnet_conv2(z, k2.to(s.dtype))
    mu2 = part[:, 0] / n
    v2 = torch.clamp(part[:, 1] / n - mu2 * mu2, min=0.0)
    kk = _cv(torch.rsqrt(v2 + eps) * g2.float())
    bb = _cv(b2.float()[None] - mu2 * torch.rsqrt(v2 + eps) * g2.float())
    h = torch.cat([h1, h2], dim=1)
    return (y2 * kk + bb + h).to(s.dtype)
