"""The phase-packed generator stage's fused convolutions (counterpart of
ops/pallas_kernels.py: `fused_conv3x3_act`, `fused_packed_pair`,
`fused_packed_stage` and their plain versions), NHWC tensors and HWIO
kernels as in JAX.

Two hand-written CUDA kernels:
  * `fused_conv3x3_act` (csrc/packed_pair.cu) computes
    lrelu(conv3x3(x * s_in) * d_out + phase_bcast(noise4) + bias) * sqrt(2);
    `fused_packed_pair` launches it twice, once per conv of the pair.
  * `fused_packed_stage` (csrc/packed_stage.cu) computes a whole packed
    stage: the pair with conv1's activation kept on chip, then toRGB and the
    packed skip upsample.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback between the two. `.launches`
on `fused_conv3x3_act` and `fused_packed_stage` counts kernel launches.

Operands: x and the conv kernels (and skip, k3sr, k4) in float32 or
bfloat16; noise, style scales, demodulation and biases in float32. The
kernels sum in float32 and write their outputs in x's dtype.
"""

import math

import torch

from .cuda_call import DTYPES, entry, expect, launch, on_card
from .polyphase import conv_packed

SQRT2 = math.sqrt(2.0)


def _per_sample(v: torch.Tensor, b: int) -> torch.Tensor:
    """(C,) or (B, C) -> (B, 1, 1, C), broadcastable over NHWC."""
    return v.expand(b, -1)[:, None, None, :]


def packed_conv3x3_act_reference(x, noise4, k, s_in, d_out, bias):
    """The plain version of one fused conv: x (B, H, W, Ci); noise4
    (B, H, W, 4) phase-packed, pre-scaled; k (3, 3, Ci, Co); s_in (B, Ci);
    d_out (B, Co); bias (Co,) or (B, Co). Returns (B, H, W, Co) in x.dtype."""
    b, h, w, _ = x.shape
    co = k.shape[-1]
    z = conv_packed(x * _per_sample(s_in.to(x.dtype), b), k)
    z = z * _per_sample(d_out.to(z.dtype), b)
    z = (z.reshape(b, h, w, 4, co // 4) + noise4[..., None]).reshape(b, h, w, co)
    z = z + _per_sample(bias, b)
    return (SQRT2 * torch.where(z >= 0, z, 0.2 * z)).to(x.dtype)


def packed_pair_reference(x, n1, n2, k1, s1, d1, b1, k2, s2, d2, b2):
    """The plain version of the packed layer pair (the JAX
    `packed_pair_reference`): two fused convs, conv2 reading conv1's
    activation scaled by s2."""
    z = packed_conv3x3_act_reference(x, n1, k1, s1, d1, b1)
    return packed_conv3x3_act_reference(z, n2, k2, s2, d2, b2)


def packed_stage_reference(x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                           k3sr, b3, k4):
    """The plain version of the whole packed stage: the pair, then toRGB
    with the per-sample (B, C4, 12) kernel k3sr (style scale folded in),
    bias b3 ((12,) or (B, 12)) and the packed skip upsample k4 (3, 3, 3, 12).
    Returns (rgb (B, H, W, 12), z2 (B, H, W, C4))."""
    z2 = packed_pair_reference(x, n1, n2, k1, s1, d1, b1, k2, s2, d2, b2)
    rgb = torch.einsum("bhwc,bco->bhwo", z2, k3sr.to(z2.dtype))
    rgb = rgb + _per_sample(b3.to(rgb.dtype), x.shape[0])
    rgb = rgb + conv_packed(skip, k4)
    return rgb, z2


# ------------------------------------------------------------- CUDA kernels

def _vec(v, b, c):
    """A per-channel float32 operand as a contiguous (B, C) tensor."""
    if v.dtype != torch.float32 or v.shape[-1] != c:
        raise ValueError(f"expected float32 (..., {c}), got {v.dtype} {tuple(v.shape)}")
    return v.expand(b, c).contiguous()


def fused_conv3x3_act(x, noise4, k, s_in, d_out, bias):
    """One fused packed conv (B3): arguments as packed_conv3x3_act_reference;
    x and k float32 or bfloat16 (the same), the rest float32."""
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 (B, H, W, Ci), got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, h, w, ci = x.shape
    co = k.shape[-1]
    if co % 4:
        raise ValueError(f"output channels {co} are not 4 phases")
    expect("noise4", noise4, (b, h, w, 4), torch.float32)
    expect("k", k, (3, 3, ci, co), x.dtype)
    if not on_card("fused_conv3x3_act", (x, noise4, k, s_in, d_out, bias)):
        return packed_conv3x3_act_reference(x, noise4, k, s_in, d_out, bias)
    s_in, d_out, bias = _vec(s_in, b, ci), _vec(d_out, b, co), _vec(bias, b, co)
    out = x.new_empty((b, h, w, co))
    launch("packed conv3x3", entry("packed_pair", "ogi_packed_conv3x3_act", 7, 6), x,
           *(t.data_ptr() for t in (x, noise4, k, s_in, d_out, bias, out)),
           b, h, w, ci, co, DTYPES[x.dtype])
    fused_conv3x3_act.launches += 1
    return out


fused_conv3x3_act.launches = 0


def fused_packed_pair(x, n1, n2, k1, s1, d1, b1, k2, s2, d2, b2):
    """The fused packed layer pair (the JAX `fused_packed_pair`).

    x (B, H, W, C1) coarse input; n1, n2 (B, H, W, 4) phase-packed noise,
    pre-scaled by the NoiseInjection weights; k1 (3, 3, C1, C4) packed
    upconv+blur kernel; s1 (B, C1); d1, s2, d2 (B, C4); b1, b2 (C4,) or
    (B, C4); k2 (3, 3, C4, C4). Returns (B, H, W, C4) in x.dtype. On the card
    it is two launches of the B3 kernel, the first writing z to device
    memory in x.dtype."""
    if x.device.type == "cpu":
        on_card("fused_packed_pair", (x, n1, n2, k1, s1, d1, b1, k2, s2, d2, b2))
        return packed_pair_reference(x, n1, n2, k1, s1, d1, b1, k2, s2, d2, b2)
    z = fused_conv3x3_act(x, n1, k1, s1, d1, b1)
    return fused_conv3x3_act(z, n2, k2, s2, d2, b2)


def fused_packed_stage(x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                       k3sr, b3, k4):
    """A whole packed stage in one launch of the B4 kernel (the JAX
    `fused_packed_stage`). Arguments as fused_packed_pair, plus skip
    (B, H, W, 3) coarse RGB, k3sr (B, C4, 12) toRGB kernel with the style
    scale folded in, b3 (12,) or (B, 12) float32, k4 (3, 3, 3, 12); skip,
    k3sr and k4 in x.dtype. Returns (rgb (B, H, W, 12), z2 (B, H, W, C4)),
    both in x.dtype; z2 is written even where the caller drops it.

    The JAX package runs its stage kernel only where both channel counts
    are multiples of 128 (a lowering limit of the TPU compiler) and falls
    back to the pair kernel elsewhere; this kernel takes any channel count
    whose conv1 activation tile fits in shared memory, so the port runs it
    at both packed stages."""
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 (B, H, W, C1), got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, h, w, c1 = x.shape
    c4 = k1.shape[-1]
    if c4 % 4:
        raise ValueError(f"packed channels {c4} are not 4 phases")
    for name, t, shape in (("n1", n1, (b, h, w, 4)), ("n2", n2, (b, h, w, 4))):
        expect(name, t, shape, torch.float32)
    for name, t, shape in (("skip", skip, (b, h, w, 3)), ("k1", k1, (3, 3, c1, c4)),
                           ("k2", k2, (3, 3, c4, c4)), ("k3sr", k3sr, (b, c4, 12)),
                           ("k4", k4, (3, 3, 3, 12))):
        expect(name, t, shape, x.dtype)
    args = (x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2, k3sr, b3, k4)
    if not on_card("fused_packed_stage", args):
        return packed_stage_reference(*args)
    s1, b3 = _vec(s1, b, c1), _vec(b3, b, 12)
    d1, b1, s2, d2, b2 = (_vec(v, b, c4) for v in (d1, b1, s2, d2, b2))
    fn = entry("packed_stage", "ogi_packed_stage", 17, 6)
    rgb, z2 = x.new_empty((b, h, w, 12)), x.new_empty((b, h, w, c4))
    ptrs = (x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2, k3sr, b3, k4, rgb, z2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in ptrs), b, h, w, c1, c4,
                 DTYPES[x.dtype], stream)
    if err == 1001:
        raise ValueError(f"packed stage kernel: the conv1 activation tile of "
                         f"C4={c4} {x.dtype} does not fit in shared memory")
    if err != 0:
        raise RuntimeError(f"packed stage kernel launch failed: error {err}")
    fused_packed_stage.launches += 1
    return rgb, z2


fused_packed_stage.launches = 0
