"""SAMM, the Spatial Alignment and Masking Module (counterpart of
nn/samm.py), NCHW.

Given the encoder feature `source` and the generator's conv output `target`
at one resolution, AlignNet predicts (dx, dy, alpha); the flow warps the
generator feature and alpha blends the warped feature with the original,
iterated `cycle_align` times with the flow accumulated (clipped to
+-scale) and alpha composed through new_prm; on the last cycle the coarser
scale's alignment is merged in. Every warp-blend goes through
`ops.warp_blend`: the CUDA kernel for CUDA tensors, its plain version on
the CPU.

AlignNet's body0 (entry InstanceNorm, concat, first bottleneck) has three
equivalent formulations, chosen by `samm_body0` (the JAX flags in
brackets):
  * "algebraic" (the default; OGI_SAMM_ALGEBRAIC=1): plain PyTorch by the
    folded coefficients, with the encoder-side terms computed once per
    block (`ops.alignnet.algebraic_alignnet_body0`, `alignnet_t_context`);
  * "fused" (OGI_SAMM_FUSED=1): the two fused CUDA kernels
    (`ops.alignnet.fused_alignnet_body0`) where `alignnet_body0_supported`
    holds, the algebraic form elsewhere;
  * "literal" (OGI_SAMM_ALGEBRAIC=0): the module dataflow. With
    `samm_conv_kernel` (OGI_PALLAS_SAMM=1) its two convs run through the
    conv3x3 + activation kernel (`ops.samm_conv.conv3x3_act`) where
    `conv3x3_act_supported` holds.
The options add no parameter.

Three opt-in bfloat16-operand options of a float32 arch, JAX's flags in
brackets; each leaves a bfloat16 arch as it is, as JAX's do:
  * `samm_conv_bf16` (OGI_SAMM_CONV_BF16=1): the algebraic body0's and the
    t-context's convs take bfloat16 operands (x1a, x1b, z and the kernels,
    cast before they are sliced), accumulate in float32 and round each
    result to bfloat16; moments, coefficients and the shortcut stay as
    they are. JAX ignores its flag for the fused and literal body0; the
    port refuses the option with them (`check_samm_options`, called by the
    arch and by SPMWarp, the block that takes every option);
  * `samm_warp_bf16` "off" | "fit" | "all" (OGI_MXU_WARP_BF16 "0" | "1" |
    "all", with OGI_MXU_WARP=1): at a scale `warp_bf16_cast` selects, the
    feature is cast to bfloat16 for the warp-blend (B1's bfloat16 route,
    float32 grid and alpha) and its output cast back. "fit" casts where
    JAX's TPU warp kernel's float32 row window would not fit and its
    bfloat16 one does (at 1024px: the 128px scale, C 256), "all" at every
    scale from WARP_BF16_MIN whose bfloat16 window fits. JAX also gates on
    the batch (OGI_MXU_WARP_BATCH) and on a TPU backend; the port drops
    the batch gate, so that a reply from a batched forward stays the lone
    request's bit for bit (infer.py);
  * `samm_gather_bf16` (OGI_GRIDSAMPLE=gather4bf16): the warp samples the
    feature cast to bfloat16 in bfloat16 arithmetic and blends with the
    float32 feature (`ops.warp_blend.warp_blend_taps_bf16`, B1's float32
    instantiation that computes the sample as JAX's gather4bf16 does),
    wherever samm_warp_bf16 does not cast: JAX's warp branch comes before
    its grid-sample branch.

bfloat16. The blocks follow their inputs' dtype (JAX's inference default,
`OGI_SAMM_FP32_INFER=0`), with two float32 islands:
  * the sampling grid, `linspace` + flow, as JAX's `gdt` guard keeps it:
    in bfloat16, positions near |x| ~ 1 would round to half a pixel at
    256px;
  * the alpha blend. alpha is the accumulated align's third channel, a
    bfloat16 value as in JAX, handed to the warp-blend in float32 (exact);
    the blend `warped * alpha + target * (1 - alpha)` is then computed in
    float32 and rounded to bfloat16 once. That is the rounding of JAX's TPU
    route, whose Pallas kernels upcast the bfloat16 alpha and blend in
    float32 (ops/pallas_warp.py, `_warp_kernel` and v2-v4). JAX's CPU route
    blends in bfloat16, op by op (each product and sum rounded); the two
    differ by a few bfloat16 steps of the feature, which
    tests/test_torch_bf16.py bounds.
"""

import math

import torch
from torch import nn

from .irse import BottleneckIR
from .layers import FusedLeakyReLU, InstanceNorm2d, XavierConv
from .stylegan2 import ModulatedConv2d

from ..ops.alignnet import (algebraic_alignnet_body0, alignnet_body0_supported,
                            alignnet_t_context, fused_alignnet_body0)
from ..ops.samm_conv import conv3x3_act, conv3x3_act_supported
from ..ops.resize import resize_bicubic_ac
from ..ops.upfirdn2d import blur as fir_blur, make_kernel
from ..ops.warp_blend import warp_blend, warp_blend_taps_bf16

SAMM_BODY0 = ("algebraic", "fused", "literal")
SAMM_WARP_BF16 = ("off", "fit", "all")
# samm_warp_bf16 casts from this size up (JAX's OGI_MXU_WARP_MIN); JAX's
# TPU warp kernel blocks BAND output rows, with a +-p row window of
# WINDOW_BYTES per row at most
WARP_BF16_MIN, BAND, WINDOW_BYTES = 128, 8, 16384


def check_samm_options(samm_body0, samm_conv_kernel, samm_conv_bf16=False,
                       samm_warp_bf16="off"):
    """Raises on a body0 mode or a warp cast mode that does not exist, on
    samm_conv_kernel without the literal mode (the only one whose convs it
    serves) and on samm_conv_bf16 without the algebraic one (the only one
    whose convs it casts)."""
    if samm_body0 not in SAMM_BODY0:
        raise ValueError(f"samm_body0 {samm_body0!r} not in {SAMM_BODY0}")
    if samm_conv_kernel and samm_body0 != "literal":
        raise ValueError("samm_conv_kernel=True needs samm_body0='literal'")
    if samm_conv_bf16 and samm_body0 != "algebraic":
        raise ValueError("samm_conv_bf16=True needs samm_body0='algebraic'")
    if samm_warp_bf16 not in SAMM_WARP_BF16:
        raise ValueError(f"samm_warp_bf16 {samm_warp_bf16!r} not in {SAMM_WARP_BF16}")


def max_disp_px(scale: float, size: int) -> int:
    """The largest |sample - output| pixel offset of a warp whose flow is
    at most `scale` (JAX's ops/pallas_warp.py:max_disp_px): the linspace
    against pixel drift gives +-0.5, the flow scale * size / 2."""
    return math.ceil(scale * size / 2.0 + 0.5) + 1


def _warp_window_fits(h, w, c, p, itemsize):
    """JAX's mxu_warp_supported: the shapes its TPU warp kernel takes, and
    whether its row window of BAND + 2p rows fits at `itemsize`."""
    return (h == w and h % BAND == 0 and c % 128 == 0 and h + 2 * p <= 4096
            and (BAND + 2 * p) * c * itemsize <= WINDOW_BYTES)


def warp_bf16_cast(mode, h, w, c, scale) -> bool:
    """Whether samm_warp_bf16 `mode` casts a float32 (h, w, c) feature
    warped with flows up to `scale` (JAX's SPMWarp branches with
    OGI_MXU_WARP=1, its batch gate aside)."""
    if mode == "off" or h < WARP_BF16_MIN:
        return False
    p = max_disp_px(scale, w)
    return _warp_window_fits(h, w, c, p, 2) and (
        mode == "all" or not _warp_window_fits(h, w, c, p, 4))


def new_prm(x, y):
    """Soft mask update y*x + x*(1-x), x first resized (bicubic,
    align_corners=True) to y's size when they differ."""
    if x.shape[-2:] != y.shape[-2:]:
        x = resize_bicubic_ac(x, tuple(y.shape[-2:]))
    return (y * x) + (x * (1.0 - x))


class _XavierBottleneckIR(nn.Module):
    """bottleneck_IR with InstanceNorm norms and xavier conv weights, the
    AlignNet body unit. conv_kernel: conv1 + PReLU and conv2 run through
    the conv3x3 + activation kernel where conv3x3_act_supported holds."""

    def __init__(self, in_ch, depth, conv_kernel=False):
        super().__init__()
        self.in_ch, self.depth, self.conv_kernel = in_ch, depth, conv_kernel
        if in_ch != depth:
            self.shortcut_conv = XavierConv(in_ch, depth, 1, 1, 0, bias=False)
            self.shortcut_norm = InstanceNorm2d(depth, affine=True)
        else:
            self.shortcut_conv = None
        self.norm1 = InstanceNorm2d(in_ch, affine=True)
        self.conv1 = XavierConv(in_ch, depth, 3, 1, 1, bias=False)
        self.prelu = nn.Parameter(torch.empty(depth))
        self.conv2 = XavierConv(depth, depth, 3, 1, 1, bias=False)
        self.norm2 = InstanceNorm2d(depth, affine=True)

    @torch.no_grad()
    def init_params(self, g):
        self.prelu.fill_(0.25)

    def forward(self, x):
        if self.shortcut_conv is None:
            shortcut = x
        else:
            shortcut = self.shortcut_norm(self.shortcut_conv(x))
        res = self.norm1(x)
        if self.conv_kernel and conv3x3_act_supported(self.in_ch, self.depth):
            res = conv3x3_act(res, self.conv1.weight.to(res.dtype), self.prelu, "prelu")
            res = conv3x3_act(res, self.conv2.weight.to(res.dtype), None, "none")
        else:
            res = self.conv1(res)
            res = torch.where(res >= 0, res, self.prelu.to(res.dtype)[:, None, None] * res)
            res = self.conv2(res)
        return self.norm2(res) + shortcut

    def fused_entry(self, source, target, diff_f_and_g, fused=False, t_ctx=None,
                    conv_bf16=False):
        """AlignNet's entry IN + concat + this bottleneck (identity shortcut,
        in_ch == depth == 2C) from the raw C-channel features: through the
        fused kernels, or by the algebraic formulation (its convs on
        bfloat16 operands with conv_bf16)."""
        if fused:
            return fused_alignnet_body0(
                source, target, self.norm1.weight, self.norm1.bias,
                self.conv1.weight, self.prelu, self.conv2.weight,
                self.norm2.weight, self.norm2.bias, diff_f_and_g)
        return algebraic_alignnet_body0(
            source, target, self.norm1.weight, self.norm1.bias,
            self.conv1.weight, self.prelu, self.conv2.weight,
            self.norm2.weight, self.norm2.bias, diff_f_and_g, t_ctx=t_ctx,
            conv_bf16=conv_bf16)

    def t_context(self, target, conv_bf16=False):
        return alignnet_t_context(target, self.norm1.weight, self.norm1.bias,
                                  self.conv1.weight, conv_bf16=conv_bf16)


class AlignNet(nn.Module):
    """(dx, dy, alpha) predictor: body0 -> body1 -> heads. samm_body0,
    samm_conv_kernel, samm_conv_bf16: see the module docstring."""

    def __init__(self, in_ch, scale=1.0, diff_f_and_g=True,
                 samm_body0="algebraic", samm_conv_kernel=False, samm_conv_bf16=False):
        super().__init__()
        self.in_ch, self.scale, self.diff_f_and_g = in_ch, scale, diff_f_and_g
        self.samm_body0, self.samm_conv_bf16 = samm_body0, samm_conv_bf16
        self.body0 = _XavierBottleneckIR(in_ch * 2, in_ch * 2, samm_conv_kernel)
        self.body1 = _XavierBottleneckIR(in_ch * 2, 3, samm_conv_kernel)
        self.norm = InstanceNorm2d(in_ch, affine=False)

    def fused_selected(self):
        return self.samm_body0 == "fused" and alignnet_body0_supported(self.in_ch)

    def algebraic_selected(self):
        """Whether forward computes body0 by the algebraic formulation, the
        one that t_context serves."""
        return self.samm_body0 != "literal" and not self.fused_selected()

    def t_context(self, target):
        return self.body0.t_context(target, self.samm_conv_bf16)

    def forward(self, source, target, t_ctx=None):
        if self.samm_body0 == "literal":
            # one batch-stacked IN over [source, target]: per-sample moments
            b = source.shape[0]
            st = self.norm(torch.cat([source, target], dim=0))
            s, t = st[:b], st[b:]
            h = self.body0(torch.cat([s - t, t] if self.diff_f_and_g else [s, t], dim=1))
        else:
            h = self.body0.fused_entry(source, target, self.diff_f_and_g,
                                       fused=self.fused_selected(), t_ctx=t_ctx,
                                       conv_bf16=self.samm_conv_bf16)
        h = self.body1(h)
        return torch.cat([torch.tanh(h[:, 0:1]) * self.scale,
                          torch.tanh(h[:, 1:2]) * self.scale,
                          torch.sigmoid(h[:, 2:3])], dim=1)


class SPMWarp(nn.Module):
    """Iterative warp/mask estimator. The SAMM options: see the module
    docstring."""

    def __init__(self, in_ch, scale=0.1, cycle_align=1,
                 blur_kernel=(1, 3, 3, 1), diff_f_and_g=True,
                 samm_body0="algebraic", samm_conv_kernel=False, samm_conv_bf16=False,
                 samm_warp_bf16="off", samm_gather_bf16=False):
        super().__init__()
        check_samm_options(samm_body0, samm_conv_kernel, samm_conv_bf16, samm_warp_bf16)
        self.scale, self.cycle_align = scale, cycle_align
        self.warp_bf16, self.gather_bf16 = samm_warp_bf16, samm_gather_bf16
        self.body = AlignNet(in_ch, scale=scale, diff_f_and_g=diff_f_and_g,
                             samm_body0=samm_body0,
                             samm_conv_kernel=samm_conv_kernel,
                             samm_conv_bf16=samm_conv_bf16)
        self.blur_kernel = make_kernel(blur_kernel)

    def warp(self, target, grid, alpha):
        """The warp-blend of the NHWC feature, through the route the SAMM
        options pick for it."""
        if target.dtype == torch.float32:
            if warp_bf16_cast(self.warp_bf16, *target.shape[1:], self.scale):
                return warp_blend(target.to(torch.bfloat16), grid, alpha).float()
            if self.gather_bf16:
                return warp_blend_taps_bf16(target, grid, alpha)
        return warp_blend(target, grid, alpha)

    def _add(self, aligned, align):
        dx = torch.clamp(aligned[:, 0:1] + align[:, 0:1], -self.scale, self.scale)
        dy = torch.clamp(aligned[:, 1:2] + align[:, 1:2], -self.scale, self.scale)
        alpha = torch.clamp(new_prm(aligned[:, 2:3], align[:, 2:3]), 0.0, 1.0)
        return torch.cat([dx, dy, alpha], dim=1)

    def _upsample_add(self, coarse, align):
        """Cross-scale merge: the fine flow is kept, alpha composed through
        new_prm with the coarser scale's."""
        alpha = torch.clamp(new_prm(coarse[:, 2:3], align[:, 2:3]), 0.0, 1.0)
        return torch.cat([align[:, 0:1], align[:, 1:2], alpha], dim=1)

    def forward(self, source, target, aligned_coarse=None):
        """source: encoder feature, target: generator feature, both
        (B, C, H, W). Returns (aligned target (B, C, H, W), align
        (B, 3, H, W) = [dx, dy, alpha])."""
        h, w = source.shape[-2:]
        lin_y = torch.linspace(-1.0, 1.0, h, dtype=torch.float32, device=source.device)
        lin_x = torch.linspace(-1.0, 1.0, w, dtype=torch.float32, device=source.device)
        t_ctx = (self.body.t_context(source)
                 if self.cycle_align > 1 and self.body.algebraic_selected() else None)
        target_nhwc = target.permute(0, 2, 3, 1).contiguous()

        aligned_target, accum = target, None
        for k in range(self.cycle_align):
            align = self.body(aligned_target, source, t_ctx=t_ctx)
            align = fir_blur(align, self.blur_kernel, pad=(2, 1))
            accum = align if accum is None else self._add(accum, align)
            if k == self.cycle_align - 1 and aligned_coarse is not None:
                accum = self._upsample_add(aligned_coarse, accum)
            # float32 grid and alpha whatever accum's dtype (module docstring)
            grid = torch.stack([lin_x[None, None, :] + accum[:, 0].float(),
                                lin_y[None, :, None] + accum[:, 1].float()],
                               dim=-1)
            alpha = accum[:, 2:3].permute(0, 2, 3, 1).float().contiguous()
            out = self.warp(target_nhwc, grid, alpha)
            aligned_target = out.permute(0, 3, 1, 2)
        return aligned_target, accum


class StyleBottleneckIR(nn.Module):
    """The optional SAMM feature bottleneck (`mod_btn:
    style_bottleneck_IR`): two BottleneckIR units without norms, a
    modulated 3x3 conv on the layer's style, then the fused lrelu."""

    def __init__(self, in_ch, depth, style_dim=512):
        super().__init__()
        self.btn0 = BottleneckIR(in_ch, in_ch, 1, se=False, bn=False)
        self.btn1 = BottleneckIR(in_ch, depth, 1, se=False, bn=False)
        self.final_conv = ModulatedConv2d(depth, depth, 3, style_dim)
        self.act = FusedLeakyReLU(depth)

    def forward(self, x, style):
        return self.act(self.final_conv(self.btn1(self.btn0(x)), style))


# the only `mod_btn` value that builds the bottleneck; any other leaves the
# feature path the identity, as in JAX
STYLE_BOTTLENECK_IR = "style_bottleneck_IR"


class StyledScaleNShiftBlock(nn.Module):
    """One SAMM block: the encoder feature through the optional bottleneck
    (`btn` == STYLE_BOTTLENECK_IR, in_ch -> out_ch channels), then SPMWarp
    on that many channels. Without the bottleneck (the shipped configs) the
    block is SPMWarp alone on in_ch channels, and out_ch is not read."""

    def __init__(self, in_ch, out_ch=None, warp_scale=0.02, cycle_align=1, btn=None,
                 diff_f_and_g=True, style_dim=512, samm_body0="algebraic",
                 samm_conv_kernel=False, samm_conv_bf16=False, samm_warp_bf16="off",
                 samm_gather_bf16=False):
        super().__init__()
        out_ch = in_ch if out_ch is None else out_ch
        if btn == STYLE_BOTTLENECK_IR:
            self.btn1 = StyleBottleneckIR(in_ch, out_ch, style_dim)
            ch = out_ch
        else:
            self.btn1, ch = None, in_ch
        self.alignment = SPMWarp(ch, scale=warp_scale,
                                 cycle_align=cycle_align,
                                 diff_f_and_g=diff_f_and_g,
                                 samm_body0=samm_body0,
                                 samm_conv_kernel=samm_conv_kernel,
                                 samm_conv_bf16=samm_conv_bf16,
                                 samm_warp_bf16=samm_warp_bf16,
                                 samm_gather_bf16=samm_gather_bf16)

    def forward(self, feat, gen_feat, aligned_coarse=None, style=None):
        """feat: the adapted encoder feature; gen_feat: the generator's conv
        output; style: the layer's W (B, style_dim), which the bottleneck
        needs and nothing else reads. Returns SPMWarp's (aligned gen_feat,
        align)."""
        if self.btn1 is not None:
            if style is None:
                raise ValueError("the SAMM bottleneck needs the layer's style")
            feat = self.btn1(feat, style)
        return self.alignment(feat, gen_feat, aligned_coarse)
