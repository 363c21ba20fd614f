"""The phase-packed generator stage's fused convolutions (counterpart of
ops/pallas_kernels.py: `fused_conv3x3_act`, `fused_packed_pair`,
`fused_packed_stage` and their plain versions), NHWC tensors and HWIO
kernels as in JAX.

Two hand-written CUDA kernels, both in csrc/packed_stage.cu on the
tensor cores:
  * `fused_conv3x3_act` (B3) computes
    lrelu(conv3x3(x * s_in) * d_out + phase_bcast(noise4) + bias) * sqrt(2),
    the whole stage's conv1 without its s2 factor; `fused_packed_pair`
    calls it twice, once per conv of the pair. Both dtypes run the TMA core
    of csrc/tma_conv.cuh: a repack launch writes x * s_in and k as the
    core's operands (float32: 3xTF32 words split once; bfloat16: the
    values, channels padded to a multiple of 8), then the conv writes its
    output in x's dtype; `conv_scratch` allocates the operands.
  * `fused_packed_stage` (B4) computes a whole packed stage: the pair, then
    toRGB and the packed skip upsample. Both dtypes run its two convs on
    the TMA core: a repack launch writes x * s1 and both kernels as the
    core's operands (float32: 3xTF32 words; bfloat16: the values, channels
    padded to a multiple of 8), conv1 writes z as conv2's operand;
    `stage_input_words`, `stage_weight_words` and `stage_z_words` are their
    plain versions in both dtypes, `stage_scratch` allocates them.

Each wrapper launches its kernel for CUDA tensors and runs the kernel's
plain version for CPU tensors; there is no fallback between the two.
`.launches` on `fused_conv3x3_act` and `fused_packed_stage` counts kernel
launches.

Two plain versions of each kernel: `packed_conv3x3_act_kernel_reference`
and `packed_stage_kernel_reference` are the kernels' functions, which the
wrappers run for CPU tensors: the convs of the operands widened to float32,
the epilogues in float32, each output rounded once to x's dtype (B4's conv1
activation after its s2 factor), as JAX's Pallas kernels compute them.
`packed_conv3x3_act_reference`, `packed_pair_reference` and
`packed_stage_reference` compute in x's dtype, as JAX's XLA oracles do, and
are what the backwards (the Functions `PackedConv3x3Act`, `PackedStage`)
differentiate, as JAX's custom_vjp rules do. On float32 operands the two
are the same ops, bit for bit.

Operands: x and the conv kernels (and skip, k3sr, k4) in float32 or
bfloat16; noise, style scales, demodulation and biases in float32. The
kernels sum in float32 and write their outputs in x's dtype.
"""

import math

import torch

from . import batch_invariant as bi
from .cuda_call import DTYPES, dispatch, entry, expect, launch, on_card, twin_function, widen
from .polyphase import conv_packed
from .samm_conv import tma_row_len, tma_rows

SQRT2 = math.sqrt(2.0)


def _per_sample(v: torch.Tensor, b: int) -> torch.Tensor:
    """(C,) or (B, C) -> (B, 1, 1, C), broadcastable over NHWC."""
    return v.expand(b, -1)[:, None, None, :]


def _scaled(x, s_in):
    """x * s_in in x.dtype, s_in rounded to it first, as JAX's kernels read
    their input."""
    return x * _per_sample(s_in.to(x.dtype), x.shape[0])


def _epilogue(z, noise4, d_out, bias):
    """lrelu(z * d_out + noise4[phase] + bias) * sqrt(2), in z's dtype (or
    float32 where an operand promotes it)."""
    b, h, w, co = z.shape
    z = z * _per_sample(d_out.to(z.dtype), b)
    z = (z.reshape(b, h, w, 4, co // 4) + noise4[..., None]).reshape(b, h, w, co)
    z = z + _per_sample(bias, b)
    return SQRT2 * torch.where(z >= 0, z, 0.2 * z)


def _rgb(z2, k3sr, b3, skip, k4):
    """toRGB of z2 with the per-sample k3sr, + b3, + the packed skip
    upsample, in z2's dtype."""
    rgb = bi.per_sample(lambda z, k: torch.einsum("bhwc,bco->bhwo", z, k),
                        z2, k3sr.to(z2.dtype))
    rgb = rgb + _per_sample(b3.to(rgb.dtype), z2.shape[0])
    return rgb + conv_packed(skip, k4)


def packed_conv3x3_act_reference(x, noise4, k, s_in, d_out, bias):
    """The plain version of one fused conv that its backward
    differentiates: x (B, H, W, Ci); noise4 (B, H, W, 4) phase-packed,
    pre-scaled; k (3, 3, Ci, Co); s_in (B, Ci); d_out (B, Co); bias (Co,)
    or (B, Co). Returns (B, H, W, Co) in x.dtype."""
    return _epilogue(conv_packed(_scaled(x, s_in), k), noise4, d_out, bias).to(x.dtype)


def _kernel_conv_act(xs, noise4, k, d_out, bias):
    """B3's and B4's conv and epilogue on the scaled input xs: the conv of
    xs and k widened to float32, the epilogue in float32; not rounded."""
    return _epilogue(conv_packed(widen(xs), widen(k)), noise4, d_out, bias)


def packed_conv3x3_act_kernel_reference(x, noise4, k, s_in, d_out, bias):
    """B3's kernel's function, arguments as packed_conv3x3_act_reference:
    x * s_in rounded to x.dtype (s_in first), then the conv and epilogue in
    float32, one rounding to x.dtype."""
    return _kernel_conv_act(_scaled(x, s_in), noise4, k, d_out, bias).to(x.dtype)


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
    return _rgb(z2, k3sr, b3, skip, k4), z2


def _kernel_stage_z(x, n1, k1, s1, d1, b1, s2):
    """B4's conv1 as its kernel computes it: B3's conv and epilogue, times
    s2 in float32, rounded once to x.dtype."""
    return (_kernel_conv_act(_scaled(x, s1), n1, k1, d1, b1)
            * _per_sample(s2, x.shape[0])).to(x.dtype)


def packed_stage_kernel_reference(x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                                  k3sr, b3, k4):
    """B4's kernels' function, arguments and results as
    packed_stage_reference: conv1 as B3's kernel computes it, its activation
    times s2 in float32 rounded once to x.dtype (z); conv2 on z, rounded
    once (z2); toRGB of z2 as stored, b3 and the skip upsample summed in
    float32, rounded once (rgb)."""
    z = _kernel_stage_z(x, n1, k1, s1, d1, b1, s2)
    z2 = _kernel_conv_act(z, n2, k2, d2, b2).to(x.dtype)
    return _rgb(widen(z2), widen(k3sr), b3, widen(skip), widen(k4)).to(x.dtype), z2


# ------------------------------------- the operands of the packed TMA convs

def stage_input_words(x, s1):
    """conv1's input as the TMA convs of B4 (and B3, s1 = s_in) read
    it: x * s1 as _scaled rounds it (float32: one product; bfloat16: s1
    rounded to bfloat16 first, then the product), x (B, H, W, C1), s1 (C1,)
    or (B, C1), as tma_rows rows: (B, H, W, 2 Cp1) words or (B, H, W, Cp1)
    bfloat16. The plain version of the repack launch's input part
    (csrc/packed_stage.cu:stage_repack_kernel)."""
    return tma_rows(_scaled(x, s1))


def stage_weight_words(k):
    """An HWIO kernel k (3 [dy], 3 [dx], Ci, Co) as the TMA core's weights:
    (3 [dx], 3 [dy], Co, .), [dx, dy, co] the tma_rows row of k[dy, dx, :,
    co] (float32 words, or bfloat16 padded to a multiple of 8). The plain
    version of the repack launch's weight part."""
    return tma_rows(k.permute(1, 0, 3, 2))


def stage_z_words(x, n1, k1, s1, d1, b1, s2):
    """What B4's conv1 writes for conv2: its activation z (as
    packed_stage_kernel_reference computes it, in x.dtype) as tma_rows rows,
    (B, H, W, 2 Cp4) words or (B, H, W, Cp4) bfloat16 with the channels
    past C4 zero; conv2 reads it as its input."""
    return tma_rows(_kernel_stage_z(x, n1, k1, s1, d1, b1, s2))


def conv_scratch(x, co):
    """Uninitialised (xr, wr) for one TMA conv of x (B, H, W, Ci) to co
    channels, which the repack launch fills: stage_input_words' and
    stage_weight_words' shapes."""
    b, h, w, ci = x.shape
    n = tma_row_len(ci, x.dtype)
    return x.new_empty((b, h, w, n)), x.new_empty((3, 3, co, n))


def stage_scratch(x, c4):
    """The scratch of one B4 call on x (B, H, W, C1) with C4 packed
    channels, which its launches fill: {"xr": stage_input_words' shape,
    "w1r", "w2r": stage_weight_words' of k1 and k2, "z": stage_z_words'}."""
    b, h, w, _ = x.shape
    xr, w1r = conv_scratch(x, c4)
    n4 = tma_row_len(c4, x.dtype)
    return {"xr": xr, "w1r": w1r, "w2r": x.new_empty((3, 3, c4, n4)),
            "z": x.new_empty((b, h, w, n4))}


# ------------------------------------------------------------- CUDA kernels

def _vec(v, b, c):
    """A per-channel float32 operand as a contiguous (B, C) tensor."""
    if v.dtype != torch.float32 or v.shape[-1] != c:
        raise ValueError(f"expected float32 (..., {c}), got {v.dtype} {tuple(v.shape)}")
    return v.expand(b, c).contiguous()


def _conv3x3_act_run(x, noise4, k, s_in, d_out, bias):
    """B3's kernel for CUDA tensors, its plain version for CPU tensors."""
    if not on_card("fused_conv3x3_act", (x, noise4, k, s_in, d_out, bias)):
        return packed_conv3x3_act_kernel_reference(x, noise4, k, s_in, d_out, bias)
    b, h, w, ci = x.shape
    co = k.shape[-1]
    s_in, d_out, bias = _vec(s_in, b, ci), _vec(d_out, b, co), _vec(bias, b, co)
    out = x.new_empty((b, h, w, co))
    xr, wr = conv_scratch(x, co)
    launch(fused_conv3x3_act, "packed conv3x3",
           entry("packed_stage", "ogi_packed_conv3x3_act", 9, 6), x,
           *(t.data_ptr() for t in (x, noise4, k, s_in, d_out, bias, out, xr, wr)),
           b, h, w, ci, co, DTYPES[x.dtype])
    return out


PackedConv3x3Act = twin_function("PackedConv3x3Act", _conv3x3_act_run,
                                 packed_conv3x3_act_reference)


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
    return dispatch(PackedConv3x3Act, x, noise4, k, s_in, d_out, bias)


fused_conv3x3_act.launches = 0


def fused_packed_pair(x, n1, n2, k1, s1, d1, b1, k2, s2, d2, b2):
    """The fused packed layer pair (the JAX `fused_packed_pair`).

    x (B, H, W, C1) coarse input; n1, n2 (B, H, W, 4) phase-packed noise,
    pre-scaled by the NoiseInjection weights; k1 (3, 3, C1, C4) packed
    upconv+blur kernel; s1 (B, C1); d1, s2, d2 (B, C4); b1, b2 (C4,) or
    (B, C4); k2 (3, 3, C4, C4). Returns (B, H, W, C4) in x.dtype. Two calls
    of B3, the first writing z to device memory in x.dtype, which the
    second's repack launch scales by s2 (s2 rounded to x.dtype first, as
    JAX's `_scaled`); on the CPU packed_pair_reference, conv by conv."""
    z = fused_conv3x3_act(x, n1, k1, s1, d1, b1)
    return fused_conv3x3_act(z, n2, k2, s2, d2, b2)


def stage_pointers(*args):
    """(the 22 pointers of csrc/packed_stage.cu:ogi_packed_stage, rgb, z2,
    scratch) for a B4 call on CUDA tensors args (fused_packed_stage's): the
    per-sample operands made contiguous (B, C), the outputs and the scratch
    (stage_scratch, and the toRGB partials "part") allocated. scratch
    also holds the contiguous operands ("operands"), so that they live until
    the launches are queued."""
    x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2, k3sr, b3, k4 = args
    b, h, w, c1 = x.shape
    c4 = k1.shape[-1]
    s1, b3 = _vec(s1, b, c1), _vec(b3, b, 12)
    d1, b1, s2, d2, b2 = (_vec(v, b, c4) for v in (d1, b1, s2, d2, b2))
    n_cblocks = entry("packed_stage", "ogi_packed_stage_cblocks", 0, 1, stream=False)(c4)
    rgb, z2 = x.new_empty((b, h, w, 12)), x.new_empty((b, h, w, c4))
    scratch = stage_scratch(x, c4)
    scratch["part"] = x.new_empty((b, n_cblocks, h, w, 12), dtype=torch.float32)
    scratch["operands"] = (s1, d1, b1, s2, d2, b2, b3)
    ptrs = (x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2, k3sr, b3, k4, rgb, z2,
            scratch["z"], scratch["part"], scratch["xr"], scratch["w1r"], scratch["w2r"])
    return [None if t is None else t.data_ptr() for t in ptrs], rgb, z2, scratch


def _stage_run(*args):
    """B4's kernels for CUDA tensors, its plain version for CPU tensors."""
    if not on_card("fused_packed_stage", args):
        return packed_stage_kernel_reference(*args)
    x, k1 = args[0], args[4]
    b, h, w, c1 = x.shape
    ptrs, rgb, z2, scratch = stage_pointers(*args)
    launch(fused_packed_stage, "packed stage", entry("packed_stage", "ogi_packed_stage", 22, 6), x,
           *ptrs, b, h, w, c1, k1.shape[-1], DTYPES[x.dtype])
    return rgb, z2


PackedStage = twin_function("PackedStage", _stage_run, packed_stage_reference)


def fused_packed_stage(x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                       k3sr, b3, k4):
    """A whole packed stage through the B4 kernels (the JAX
    `fused_packed_stage`): one call of csrc/packed_stage.cu, which launches
    a repack, conv1 and conv2 on the TMA core and a pass that finishes rgb.
    Arguments as fused_packed_pair, plus
    skip (B, H, W, 3) coarse RGB, k3sr (B, C4, 12) toRGB kernel with the
    style scale folded in, b3 (12,) or (B, 12) float32, k4 (3, 3, 3, 12);
    skip, k3sr and k4 in x.dtype. Returns (rgb (B, H, W, 12), z2 (B, H, W,
    C4)), both in x.dtype; z2 is written even where the caller drops it.
    conv1's activation goes through a scratch as conv2's operand
    (stage_z_words), the toRGB partials of each 128-channel block through a
    float32 one.

    The JAX package runs its stage kernel only where both channel counts
    are multiples of 128 (a lowering limit of the TPU compiler) and falls
    back to the pair kernel elsewhere; these kernels take any C4 that is a
    multiple of 4, so the port runs them at both packed stages."""
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
    return dispatch(PackedStage, x, n1, n2, skip, k1, s1, d1, b1, k2, s2, d2, b2,
                    k3sr, b3, k4)


fused_packed_stage.launches = 0
