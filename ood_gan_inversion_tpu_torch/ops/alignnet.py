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
kernels between plain PyTorch passes: the coefficients, then
`alignnet_conv1` (B2a: x1 built from (s, t) and the coefficients, conv1,
PReLU), then `alignnet_conv2` (B2b: conv2 and norm2's moments), then the
norm2 affine and the shortcut. csrc/alignnet_conv1.cu runs both dtypes on
the TMA kernel of csrc/tma_conv.cuh, after a repack pass into NHWC input and
tap-major weights that builds x1 (`tma_x1_operands` is its plain version;
float32 as 3xTF32, x1 and k1 split into hi and lo words in that pass);
csrc/alignnet_conv2.cu runs both dtypes on the same TMA kernel after the
plain repack pass (`samm_conv.tma_operands`), with the moments epilogue.
Each wrapper launches its kernel for CUDA tensors and counts its calls in
`.launches`.

Two plain versions of each kernel: `alignnet_conv1_kernel_reference` and
`alignnet_conv2_kernel_reference` are the kernels' functions (the convs of
the operands widened to float32, PReLU in float32, z rounded once to the
operand dtype, y2 and its moments in float32), which the wrappers run for
CPU tensors, as JAX's Pallas kernels compute them; `alignnet_conv1_reference`
and `alignnet_conv2_reference` compute in the operand dtype, as JAX's XLA
oracle does, and are what the backwards (the Functions `AlignNetConv1`,
`AlignNetConv2`) differentiate, so `fused_alignnet_body0`, which composes
them, differentiates as JAX's custom_vjp does: through the reference. On
float32 operands the two are the same ops, bit for bit. B2a's PReLU slopes
are rounded to the operand dtype in the wrapper, as JAX's kernel reads
them, so the kernel and both plain versions read the same values.
"""

import torch

from . import batch_invariant as bi
from .cuda_call import (DTYPES, activation, dispatch, entry, expect, launch, on_card,
                        twin_function, widen)
from .samm_conv import conv3x3_act_kernel_reference, tma_operands, tma_scratch

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


def alignnet_t_context(t, g1, b1, k1, eps: float = 1e-5, conv_bf16: bool = False):
    """The cycle-invariant, t-only terms of algebraic_alignnet_body0: the
    t-moments, IN(t), and the t-half of conv1 (on bfloat16 operands with
    conv_bf16, as there)."""
    c = t.shape[1]
    k1 = k1.to(torch.bfloat16 if conv_bf16 else t.dtype)
    t32 = t.float()
    et = _mean_hw(t32)
    vt = torch.clamp(_mean_hw(t32 * t32) - et * et, min=0.0)
    inv_t = torch.rsqrt(vt + eps)
    gb, bb = g1[c:].float(), b1[c:].float()
    r2 = torch.rsqrt(vt * inv_t * inv_t + eps)
    x1b = (_cv(inv_t * r2 * gb) * t32 + _cv(-et * inv_t * r2 * gb + bb)).to(k1.dtype)
    zb = _conv(x1b, k1[:, c:])
    tn = ((t32 - _cv(et)) * _cv(inv_t)).to(t.dtype)
    return {"et": et, "vt": vt, "inv_t": inv_t, "tn": tn, "zb": zb}


def algebraic_alignnet_body0(s, t, g1, b1, k1, alpha, k2, g2, b2,
                             diff_f_and_g: bool = True, eps: float = 1e-5,
                             t_ctx=None, conv_bf16: bool = False):
    """body0 from (s, t) by the folded coefficients. s: generator feature,
    t: encoder feature, both (B, C, H, W) before the entry IN; g1/b1 (2C,)
    norm1 affine, k1 (2C, 2C, 3, 3), alpha (2C,) PReLU slopes, k2
    (2C, 2C, 3, 3), g2/b2 (2C,) norm2 affine. t_ctx: alignnet_t_context(t)
    for a t reused across calls (made with the same conv_bf16). conv_bf16
    (JAX's OGI_SAMM_CONV_BF16): the convs' operands x1a, x1b, z and the
    kernels in bfloat16 (the kernels cast before they are sliced), each
    conv summed in float32 and rounded to bfloat16; moments, coefficients
    and the shortcut as without it."""
    c = s.shape[1]
    cdt = torch.bfloat16 if conv_bf16 else s.dtype
    k1, k2 = k1.to(cdt), k2.to(cdt)
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
        x1a = (_cv(as_) * s32 + _cv(at_) * t32 + _cv(b1h)).to(cdt)
        z = _conv(x1a, k1[:, :c]) + t_ctx["zb"]
        sn = ((s32 - _cv(es)) * _cv(inv_s)).to(s.dtype)
        h1 = sn - t_ctx["tn"] if diff_f_and_g else sn
        h2 = t_ctx["tn"]
    else:
        coeffs, h1, h2 = _alignnet_coeffs(s32, t32, g1, b1, diff_f_and_g, eps)
        h1, h2 = h1.to(s.dtype), h2.to(s.dtype)
        as_, at_, b1h, ct_, b2h = (_cv(coeffs[:, i]) for i in range(5))
        x1a = (as_ * s32 + at_ * t32 + b1h).to(cdt)
        x1b = (ct_ * t32 + b2h).to(cdt)
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


def alignnet_x1(s, t, coeffs):
    """conv1's input x1 = [as*s + at*t + b1, ct*t + b2] from s, t (B, C, H,
    W) and coeffs (B, 5, C) float32: computed in float32 in this order,
    rounded once to s.dtype. (B, 2C, H, W)."""
    s32, t32 = s.float(), t.float()
    as_, at_, b1h, ct_, b2h = (_cv(coeffs[:, i]) for i in range(5))
    return torch.cat([as_ * s32 + at_ * t32 + b1h, ct_ * t32 + b2h], dim=1).to(s.dtype)


def alignnet_conv1_reference(s, t, coeffs, k1, alpha):
    """The plain version of the first fused kernel that its backward
    differentiates: x1 = alignnet_x1(s, t, coeffs), zero outside the image;
    z = prelu(conv3x3(x1, k1)) in s.dtype. s, t (B, C, H, W); k1 (2C, 2C,
    3, 3); alpha (2C,). Returns z (B, 2C, H, W) in s.dtype."""
    z = _conv(alignnet_x1(s, t, coeffs), k1)
    return torch.where(z >= 0, z, _cv(alpha[None].to(z.dtype)) * z)


def alignnet_conv1_kernel_reference(s, t, coeffs, k1, alpha):
    """The first fused kernel's function, arguments as
    alignnet_conv1_reference: x1 as there, then conv1 and PReLU as B5's
    kernel computes them (samm_conv.conv3x3_act_kernel_reference): the conv
    in float32, PReLU with the float32 slopes as given, one rounding."""
    return conv3x3_act_kernel_reference(alignnet_x1(s, t, coeffs), k1, alpha, "prelu")


def alignnet_conv2_reference(z, k2):
    """The plain version of the second fused kernel that its backward
    differentiates: y2 = conv3x3(z, k2) in z.dtype, then as float32, and
    part (B, 2, 2C) = [sum y2, sum y2^2] over H, W in float32."""
    y2 = _conv(z, k2).float()
    return y2, torch.stack([bi.sum_hw(y2), bi.sum_hw(y2 * y2)], dim=1)


def alignnet_conv2_kernel_reference(z, k2):
    """The second fused kernel's function: as alignnet_conv2_reference on z
    and k2 widened to float32, so that y2 and its moments are never rounded
    to bfloat16."""
    return alignnet_conv2_reference(widen(z), widen(k2))


def tma_x1_operands(s, t, coeffs, k1):
    """The operands of the B2a kernel (csrc/tma_conv.cuh) from s, t (B, C,
    H, W), coeffs (B, 5, C) and k1 (2C, 2C, 3, 3): x1 = alignnet_x1(s, t,
    coeffs) and k1 laid out by samm_conv.tma_operands (bfloat16: the values,
    2C channels padded to Cp = tma_channels(2C); float32: their hi and lo
    words). The plain version of the repack pass's x1 mode: x1's
    arithmetic, then the layout."""
    return tma_operands(alignnet_x1(s, t, coeffs), k1)


def _conv1_run(s, t, coeffs, k1, alpha):
    """B2a's kernel for CUDA tensors, its plain version for CPU tensors:
    the TMA kernel's repack pass, which builds x1, into scratch
    (samm_conv.tma_scratch), then the conv."""
    if not on_card("alignnet_conv1", (s, t, coeffs, k1, alpha)):
        return alignnet_conv1_kernel_reference(s, t, coeffs, k1, alpha)
    b, c, h, w = s.shape
    z = s.new_empty((b, 2 * c, h, w))
    xr, wr = tma_scratch(s, k1)
    name = "ogi_alignnet_conv1_tma" if s.dtype == torch.bfloat16 else "ogi_alignnet_conv1"
    launch(alignnet_conv1, "alignnet_conv1", entry("alignnet_conv1", name, 8, 4), s,
           *(v.data_ptr() for v in (s, t, coeffs, k1, xr, wr, alpha, z)), b, h, w, c)
    return z


AlignNetConv1 = twin_function("AlignNetConv1", _conv1_run, alignnet_conv1_reference)


def alignnet_conv1(s, t, coeffs, k1, alpha):
    """B2a: arguments and result as alignnet_conv1_reference; s, t and k1
    float32 or bfloat16 (the same), coeffs and alpha float32. The slopes
    are rounded to s.dtype first, as JAX's kernel reads them. The kernel
    runs on the tensor cores as conv3x3_act does, after the repack pass's
    x1 mode."""
    activation(s, "alignnet_conv1")
    b, c, h, w = s.shape
    expect("t", t, s.shape, s.dtype)
    expect("coeffs", coeffs, (b, 5, c), torch.float32)
    expect("k1", k1, (2 * c, 2 * c, 3, 3), s.dtype)
    expect("alpha", alpha, (2 * c,), torch.float32)
    return dispatch(AlignNetConv1, s, t, coeffs, k1, alpha.to(s.dtype).float())


alignnet_conv1.launches = 0


def _conv2_run(z, k2):
    """B2b's kernel for CUDA tensors, its plain version for CPU tensors:
    the TMA kernel's repack pass into scratch (samm_conv.tma_scratch), then
    the conv and the tile sums."""
    if not on_card("alignnet_conv2", (z, k2)):
        return alignnet_conv2_kernel_reference(z, k2)
    b, c2, h, w = z.shape
    n_tiles = entry("alignnet_conv2", "ogi_samm_conv_tiles", 0, 3, stream=False)(h, w, c2)
    y2 = z.new_empty((b, c2, h, w), dtype=torch.float32)
    tile_part = z.new_empty((b, n_tiles, 2, c2), dtype=torch.float32)
    part = z.new_empty((b, 2, c2), dtype=torch.float32)
    zr, wr = tma_scratch(z, k2)
    launch(alignnet_conv2, "alignnet_conv2", entry("alignnet_conv2", "ogi_alignnet_conv2", 7, 5),
           z, *(v.data_ptr() for v in (z, k2, zr, wr, y2, tile_part, part)), b, h, w, c2,
           DTYPES[z.dtype])
    return y2, part


AlignNetConv2 = twin_function("AlignNetConv2", _conv2_run, alignnet_conv2_reference)


def alignnet_conv2(z, k2):
    """B2b: y2 (B, 2C, H, W) float32 and part (B, 2, 2C) float32 as
    alignnet_conv2_reference; z and k2 float32 or bfloat16 (the same). The
    kernel runs on conv3x3_act's TMA kernel (float32 as 3xTF32), with the
    moments epilogue. Each
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
