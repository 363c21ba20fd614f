"""The plain reference of the E4E and ReStyle configurations (`"reference":
"model"`): the OOD face-GAN inverter with the E4E or the ReStyle encoder
(IR-SE-50 trunk, StyleGAN2 generator, the SAMM blocks and the
out-of-domain blend), in float32 and plain PyTorch. The module keeps the
contract of `portbench/reference/__init__.py`; a reference of another
encoder family may import its generator and SAMM.

It is written from the published description and the StyleGAN2 reference
code (rosinality's stylegan2-pytorch: per-sample modulated weights, one
grouped convolution per layer, the upsampling conv as a stride-2
transposed convolution followed by the FIR blur), and imports nothing of
the program under test. Its parameter names are the program's state-dict
keys, so that one set of seeded tensors loads into both. Every op runs on
the whole batch (no per-sample split), so it also differs from the
program in summation order wherever cuDNN picks its algorithm by shape.

`init_specs` says how each parameter is drawn; `portbench/weights.py`
draws them. Images are NHWC at the interface, NCHW inside.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SQRT2 = math.sqrt(2.0)


def generator_channels(channel_multiplier=2, narrow=1.0):
    return {4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
            32: int(512 * narrow), 64: int(256 * channel_multiplier * narrow),
            128: int(128 * channel_multiplier * narrow),
            256: int(64 * channel_multiplier * narrow),
            512: int(32 * channel_multiplier * narrow),
            1024: int(16 * channel_multiplier * narrow)}


# ------------------------------------------------------------------ helpers

def blur_kernel(k=(1, 3, 3, 1)):
    k = np.asarray(k, np.float32)
    k = np.outer(k, k)
    return k / k.sum()


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """rosinality's upfirdn2d_native on NCHW: zero-insertion upsample, pad
    (negative crops), true convolution with the 2-D kernel, subsample."""
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1)).reshape(n, c, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, (max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)))
    x = x[:, :, max(-p0, 0):x.shape[2] - max(-p1, 0), max(-p0, 0):x.shape[3] - max(-p1, 0)]
    k = torch.as_tensor(np.ascontiguousarray(np.asarray(kernel)[::-1, ::-1]),
                        dtype=x.dtype, device=x.device)
    x = F.conv2d(x, k[None, None].expand(c, 1, *k.shape), groups=c)
    return x[:, :, ::down, ::down]


def fused_lrelu(x, bias=None):
    if bias is not None:
        x = x + bias.reshape(1, -1, *([1] * (x.dim() - 2)))
    return F.leaky_relu(x, 0.2) * SQRT2


def instance_norm(x, weight=None, bias=None, eps=1e-5):
    return F.instance_norm(x, weight=weight, bias=bias, eps=eps)


def resize_bilinear(x, size):
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def resize_bicubic_ac(x, size):
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bicubic", align_corners=True)


def grid_warp_blend(target, grid, alpha):
    """grid_sample(target, grid) * alpha + target * (1 - alpha), NCHW."""
    warped = F.grid_sample(target, grid, mode="bilinear", padding_mode="zeros",
                           align_corners=False)
    return warped * alpha + target * (1.0 - alpha)


# --------------------------------------------------------------- init specs
# ("normal", std[, mean]) or ("uniform", half_width[, centre]) for each
# parameter and buffer, by the module that owns it. Weights follow the
# initialisers of the original modules (equalized-lr weights N(0, 1),
# torch's default conv init, xavier for the SAMM convs). Every other leaf is
# drawn per channel or per layer around the value a trained checkpoint's
# would scatter about, so that a program that drops a bias, reads another
# channel's or layer's, or swaps a norm's weight and bias gives another
# answer: biases N(0, 0.1), norm weights 1 + N(0, 0.1), BatchNorm running
# means N(0, 0.1) and variances U(0.75, 1.25), PReLU slopes U(0.15, 0.35),
# noise strengths U(0.05, 0.2) per layer, the latent offsets N(0, 0.1).
BIAS = ("normal", 0.1)
NORM_WEIGHT = ("normal", 0.1, 1.0)
PRELU_SLOPE = ("uniform", 0.1, 0.25)

def _torch_default(shape):
    return ("uniform", 1.0 / math.sqrt(math.prod(shape[1:])))


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, bias_init=0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.bias_init = bias_init

    def init_specs(self):
        return {"weight": ("normal", 1.0), "bias": ("normal", 0.1, self.bias_init)}

    def forward(self, x):
        return F.linear(x, self.weight / math.sqrt(self.weight.shape[1]), self.bias)


class Conv(nn.Module):
    """nn.Conv2d with torch's default init (its parameters as the program
    names them)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, xavier=False):
        super().__init__()
        self.stride, self.padding, self.xavier = stride, padding, xavier
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def init_specs(self):
        if self.xavier:
            o, i, kh, kw = self.weight.shape
            specs = {"weight": ("normal", math.sqrt(2.0 / (kh * kw * (i + o))))}
            bias = BIAS
        else:
            specs = {"weight": _torch_default(self.weight.shape)}
            bias = _torch_default(self.weight.shape)
        if self.bias is not None:
            specs["bias"] = bias
        return specs

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))

    def init_specs(self):
        return {"weight": NORM_WEIGHT, "bias": BIAS,
                "running_mean": ("normal", 0.1), "running_var": ("uniform", 0.25, 1.0)}

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-5)


class PReLU(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))

    def init_specs(self):
        return {"weight": PRELU_SLOPE}

    def forward(self, x):
        return F.prelu(x, self.weight)


class InstanceNormAffine(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def init_specs(self):
        return {"weight": NORM_WEIGHT, "bias": BIAS}

    def forward(self, x):
        return instance_norm(x, self.weight, self.bias)


# ------------------------------------------------------------ IR-SE encoders

def ir_blocks(num_layers):
    """(in, depth, stride) of each unit of IR-SE-50 (or the 4-unit test
    trunk)."""
    units = {50: (3, 4, 14, 3), 4: (1, 1, 1, 1)}[num_layers]
    spec, ch_in = [], 64
    for depth, n in zip((64, 128, 256, 512), units):
        spec += [(ch_in, depth, 2)] + [(depth, depth, 1)] * (n - 1)
        ch_in = depth
    return spec


class SEModule(nn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        self.fc1 = Conv(c, c // reduction, 1, bias=False)
        self.fc2 = Conv(c // reduction, c, 1, bias=False)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    def __init__(self, cin, depth, stride):
        super().__init__()
        self.stride = stride
        if cin != depth:
            self.shortcut_conv = Conv(cin, depth, 1, stride, bias=False)
            self.shortcut_norm = BatchNorm(depth)
        else:
            self.shortcut_conv = None
        self.norm1 = BatchNorm(cin)
        self.conv1 = Conv(cin, depth, 3, 1, 1, bias=False)
        self.prelu = PReLU(depth)
        self.conv2 = Conv(depth, depth, 3, stride, 1, bias=False)
        self.norm2 = BatchNorm(depth)
        self.se = SEModule(depth)

    def forward(self, x):
        if self.shortcut_conv is None:
            shortcut = F.max_pool2d(x, 1, self.stride)
        else:
            shortcut = self.shortcut_norm(self.shortcut_conv(x))
        res = self.norm2(self.conv2(self.prelu(self.conv1(self.norm1(x)))))
        return self.se(res) + shortcut


class IRSETrunk(nn.Module):
    def __init__(self, num_layers, input_ch=3):
        super().__init__()
        self.input_conv = Conv(input_ch, 64, 3, 1, 1, bias=False)
        self.input_norm = BatchNorm(64)
        self.input_prelu = PReLU(64)
        spec = ir_blocks(num_layers)
        self.body = nn.ModuleList(BottleneckIRSE(*u) for u in spec)
        # the last unit of each of the four stages
        ends = np.cumsum([sum(1 for u in spec if u[1] == d) for d in (64, 128, 256, 512)]) - 1
        self.taps = tuple(int(e) for e in ends)

    def forward(self, x):
        y = self.input_prelu(self.input_norm(self.input_conv(x)))
        feats = [y]
        for i, unit in enumerate(self.body):
            y = unit(y)
            if i in self.taps:
                feats.append(y)
        return y, feats


class GradualStyleBlock(nn.Module):
    def __init__(self, spatial):
        super().__init__()
        self.conv = nn.ModuleList(Conv(512, 512, 3, 2, 1) for _ in range(int(math.log2(spatial))))
        self.linear = EqualLinear(512, 512)

    def forward(self, x):
        for conv in self.conv:
            x = F.leaky_relu(conv(x), 0.01)
        return self.linear(x.flatten(1))


class Encoder4Editing(nn.Module):
    """IR-SE trunk, FPN, W0 plus a delta for every other layer."""

    def __init__(self, num_layers, n_styles):
        super().__init__()
        self.trunk = IRSETrunk(num_layers)
        self.style = nn.ModuleList(GradualStyleBlock(16 if i < 3 else 32 if i < 7 else 64)
                                   for i in range(n_styles))
        self.latlayer1 = Conv(256, 512, 1)
        self.latlayer2 = Conv(128, 512, 1)

    def forward(self, x):
        _, feats = self.trunk(x)
        c1, c2, c3 = feats[2], feats[3], feats[4]
        w0 = self.style[0](c3)
        p2 = resize_bicubic_ac(c3, c2.shape[-2:]) + self.latlayer1(c2)
        p1 = resize_bicubic_ac(p2, c1.shape[-2:]) + self.latlayer2(c1)
        maps = [c3] * 3 + [p2] * 4 + [p1] * (len(self.style) - 7)
        deltas = [torch.zeros_like(w0)] + [head(m) for head, m in zip(self.style[1:], maps[1:])]
        return w0[:, None] + torch.stack(deltas, dim=1), feats


class ProgressiveBackboneEncoder(nn.Module):
    """ReStyle's encoder: 6-channel IR-SE trunk, every head on the 16px map."""

    def __init__(self, num_layers, n_styles):
        super().__init__()
        self.trunk = IRSETrunk(num_layers, input_ch=6)
        self.style = nn.ModuleList(GradualStyleBlock(16) for _ in range(n_styles))

    def forward(self, x):
        final, feats = self.trunk(x)
        w0 = self.style[0](final)
        deltas = [torch.zeros_like(w0)] + [head(final) for head in self.style[1:]]
        return w0[:, None] + torch.stack(deltas, dim=1), feats


# ----------------------------------------------------------------- StyleGAN2

class ModulatedConv2d(nn.Module):
    """rosinality's ModulatedConv2d: the weight modulated and demodulated
    per sample, one grouped convolution (a stride-2 transposed one and the
    FIR blur when upsampling)."""

    def __init__(self, cin, cout, k, style_dim, demodulate=True, upsample=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.modulation = EqualLinear(style_dim, cin, bias_init=1.0)
        self.demodulate, self.upsample = demodulate, upsample
        self.blur = blur_kernel()

    def init_specs(self):
        return {"weight": ("normal", 1.0)}

    def forward(self, x, style):
        b, cin, h, w = x.shape
        cout, _, k, _ = self.weight.shape
        s = self.modulation(style)
        wt = self.weight[None] / math.sqrt(cin * k * k) * s[:, None, :, None, None]
        if self.demodulate:
            wt = wt * torch.rsqrt(wt.pow(2).sum(dim=(2, 3, 4)) + 1e-8)[:, :, None, None, None]
        xg = x.reshape(1, b * cin, h, w)
        if self.upsample:
            wt = wt.transpose(1, 2).reshape(b * cin, cout, k, k)
            y = F.conv_transpose2d(xg, wt, stride=2, groups=b)
            y = y.reshape(b, cout, *y.shape[-2:])
            p = (self.blur.shape[0] - 2) - (k - 1)
            return upfirdn2d(y, self.blur * 4, pad=((p + 1) // 2 + 1, p // 2 + 1))
        y = F.conv2d(xg, wt.reshape(b * cout, cin, k, k), padding=k // 2, groups=b)
        return y.reshape(b, cout, h, w)


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def init_specs(self):
        return {"weight": ("uniform", 0.075, 0.125)}

    def forward(self, x, noise):
        return x + self.weight * noise


class Bias(nn.Module):
    """FusedLeakyReLU: a learned bias, then lrelu(0.2) * sqrt(2)."""

    def __init__(self, c):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(c))

    def init_specs(self):
        return {"bias": BIAS}

    def forward(self, x):
        return fused_lrelu(x, self.bias)


class StyledConv(nn.Module):
    def __init__(self, cin, cout, style_dim, upsample=False):
        super().__init__()
        self.conv = ModulatedConv2d(cin, cout, 3, style_dim, upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = Bias(cout)

    def forward(self, x, style, noise):
        return self.activate(self.noise(self.conv(x, style), noise))


class ToRGB(nn.Module):
    def __init__(self, cin, style_dim):
        super().__init__()
        self.conv = ModulatedConv2d(cin, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(3))
        self.blur = blur_kernel()

    def init_specs(self):
        return {"bias": BIAS}

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias[None, :, None, None]
        if skip is not None:
            out = out + upfirdn2d(skip, self.blur * 4, up=2, pad=(2, 1))
        return out


class Generator(nn.Module):
    def __init__(self, size, style_dim, channel_multiplier, narrow, n_mlp):
        super().__init__()
        ch = generator_channels(channel_multiplier, narrow)
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.input = nn.Parameter(torch.empty(1, ch[4], 4, 4))
        self.conv1 = StyledConv(ch[4], ch[4], style_dim)
        self.to_rgb1 = ToRGB(ch[4], style_dim)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        cin = ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            self.convs.append(StyledConv(cin, cout, style_dim, upsample=True))
            self.convs.append(StyledConv(cout, cout, style_dim))
            self.to_rgbs.append(ToRGB(cout, style_dim))
            cin = cout
        # the style MLP (z -> W): part of the checkpoint, not of inversion
        self.style = nn.ModuleList(EqualLinear(style_dim, style_dim) for _ in range(n_mlp))

    def init_specs(self):
        return {"input": ("normal", 1.0)}

    def noise_shapes(self):
        """One image's (1, 1, s, s) noise shape of each layer, in order."""
        sizes = [4] + [2 ** (3 + j // 2) for j in range(self.num_layers - 1)]
        return [(1, 1, s, s) for s in sizes]

    def make_noise(self, generator, device):
        """One image's per-layer noise, drawn in layer order."""
        return [torch.randn(s, generator=generator, device=device) for s in self.noise_shapes()]

    def forward(self, lats, noise, samm=None):
        """Decodes W+ lats (B, n, style_dim). samm(layer, conv_output) ->
        the aligned feature, for the conditioned layers (None: a plain
        decode)."""
        out = self.conv1(self.input.expand(lats.shape[0], -1, -1, -1), lats[:, 0], noise[0])
        skip = self.to_rgb1(out, lats[:, 1])
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            conv_a, conv_b = self.convs[2 * idx], self.convs[2 * idx + 1]
            if samm is not None and samm.conditions(i):
                aligned = samm(i, conv_a.conv(out, lats[:, i]), lats[:, i])
                out = conv_a.activate(conv_a.noise(aligned, noise[1 + 2 * idx]))
            else:
                out = conv_a(out, lats[:, i], noise[1 + 2 * idx])
            out = conv_b(out, lats[:, i + 1], noise[2 + 2 * idx])
            skip = to_rgb(out, lats[:, i + 2], skip)
            i += 2
        return skip


# ----------------------------------------------------------------------- SAMM

class XavierBottleneck(nn.Module):
    """AlignNet's unit: instance norms, xavier convs, a PReLU."""

    def __init__(self, cin, depth):
        super().__init__()
        if cin != depth:
            self.shortcut_conv = Conv(cin, depth, 1, bias=False, xavier=True)
            self.shortcut_norm = InstanceNormAffine(depth)
        else:
            self.shortcut_conv = None
        self.norm1 = InstanceNormAffine(cin)
        self.conv1 = Conv(cin, depth, 3, 1, 1, bias=False, xavier=True)
        self.prelu = nn.Parameter(torch.empty(depth))
        self.conv2 = Conv(depth, depth, 3, 1, 1, bias=False, xavier=True)
        self.norm2 = InstanceNormAffine(depth)

    def init_specs(self):
        return {"prelu": PRELU_SLOPE}

    def forward(self, x):
        shortcut = x if self.shortcut_conv is None else self.shortcut_norm(self.shortcut_conv(x))
        res = self.conv2(F.prelu(self.conv1(self.norm1(x)), self.prelu))
        return self.norm2(res) + shortcut


class AlignNet(nn.Module):
    """(dx, dy, alpha) from the instance-normed [source - target, target]."""

    def __init__(self, c, scale):
        super().__init__()
        self.scale = scale
        self.body0 = XavierBottleneck(2 * c, 2 * c)
        self.body1 = XavierBottleneck(2 * c, 3)

    def forward(self, source, target):
        s, t = instance_norm(source), instance_norm(target)
        h = self.body1(self.body0(torch.cat([s - t, t], dim=1)))
        return torch.cat([torch.tanh(h[:, 0:1]) * self.scale, torch.tanh(h[:, 1:2]) * self.scale,
                          torch.sigmoid(h[:, 2:3])], dim=1)


def new_prm(x, y):
    x = resize_bicubic_ac(x, y.shape[-2:])
    return y * x + x * (1.0 - x)


class SPMWarp(nn.Module):
    """cycle_align rounds of: predict an align from the aligned feature and
    the encoder's, blur it, accumulate it (flow clipped to +-scale, alpha
    composed), merge the coarser scale's alpha on the last round, and
    warp-blend the generator feature with it."""

    def __init__(self, c, scale, cycle_align):
        super().__init__()
        self.scale, self.cycle_align = scale, cycle_align
        self.body = AlignNet(c, scale)
        self.blur = blur_kernel()

    def forward(self, source, target, coarse=None):
        h, w = source.shape[-2:]
        lin_y = torch.linspace(-1.0, 1.0, h, device=source.device)
        lin_x = torch.linspace(-1.0, 1.0, w, device=source.device)
        aligned, accum = target, None
        for k in range(self.cycle_align):
            align = upfirdn2d(self.body(aligned, source), self.blur, pad=(2, 1))
            if accum is None:
                accum = align
            else:
                accum = torch.cat([
                    torch.clamp(accum[:, 0:1] + align[:, 0:1], -self.scale, self.scale),
                    torch.clamp(accum[:, 1:2] + align[:, 1:2], -self.scale, self.scale),
                    torch.clamp(new_prm(accum[:, 2:3], align[:, 2:3]), 0.0, 1.0)], dim=1)
            if k == self.cycle_align - 1 and coarse is not None:
                accum = torch.cat([accum[:, :2], torch.clamp(
                    new_prm(coarse[:, 2:3], accum[:, 2:3]), 0.0, 1.0)], dim=1)
            grid = torch.stack([lin_x[None, None, :] + accum[:, 0],
                                lin_y[None, :, None] + accum[:, 1]], dim=-1)
            aligned = grid_warp_blend(target, grid, accum[:, 2:3])
        return aligned, accum


class SAMMBlock(nn.Module):
    def __init__(self, c, scale, cycle_align):
        super().__init__()
        self.alignment = SPMWarp(c, scale, cycle_align)


class SAMM:
    """The conditioned layers of one decode: layer 5 (32px), 7, 9, 11
    (256px), as many as ModSize reaches; keeps each scale's align."""

    def __init__(self, arch, feats_c, mod_size):
        n = min(max(int(math.floor(math.log2(mod_size))) - 4, 0), 4) if mod_size > 0 else 0
        self.layers = [2 * (k + 2) + 1 for k in range(n)]
        self.arch, self.feats_c, self.aligns, self.prev = arch, feats_c, {}, None

    def conditions(self, layer):
        return layer in self.layers

    def __call__(self, layer, conv_out, style):
        ind = self.layers.index(layer) + 1
        block = self.arch.modulation[str(4 - ind)].alignment
        aligned, align = block(self.feats_c[4 - ind], conv_out, self.prev)
        self.aligns[ind] = self.prev = align
        return aligned


# ---------------------------------------------------------------- the arches

class OODInverter(nn.Module):
    """The E4E-family inverter (`encoder` "E4E") or the ReStyle one
    ("ReStyle", `enc_cycle` passes). forward(x NHWC in [-1, 1], noise) ->
    dict(image, mask, gen_image NHWC, lats)."""

    def __init__(self, out_size=1024, style_dim=512, n_mlp=8, channel_multiplier=2,
                 narrow=1.0, encoder="E4E", encoder_num_layers=50, enc_cycle=1,
                 warp_scale=0.02, cycle_align=1, ModSize=256, **_):
        super().__init__()
        self.kind, self.enc_cycle, self.mod_size = encoder, enc_cycle, ModSize
        self.out_size = out_size
        n_styles = int(math.log2(out_size)) * 2 - 2
        ch = generator_channels(channel_multiplier, narrow)
        if encoder == "E4E":
            self.encoder = Encoder4Editing(encoder_num_layers, n_styles)
            avg_shape = (1, style_dim)
        elif encoder == "ReStyle":
            self.encoder = ProgressiveBackboneEncoder(encoder_num_layers, n_styles)
            avg_shape = (n_styles, style_dim)
        else:
            raise ValueError(f"encoder {encoder!r}: E4E or ReStyle")
        sizes, enc_ch = (256, 128, 64, 32), (64, 64, 128, 256)
        self.feats_conv = nn.ModuleList(Conv(enc_ch[i], ch[sizes[i]], 1) for i in range(4))
        self.modulation = nn.ModuleDict({str(i): SAMMBlock(ch[s], warp_scale, cycle_align)
                                         for i, s in enumerate(sizes) if s <= out_size})
        self.generator = Generator(out_size, style_dim, channel_multiplier, narrow, n_mlp)
        self.avg_latent = nn.Parameter(torch.empty(*avg_shape))
        self.delta_latent = nn.Parameter(torch.empty(1, n_styles, style_dim))

    def init_specs(self):
        return {"avg_latent": ("normal", 0.1), "delta_latent": ("normal", 0.1)}

    def make_noise(self, seed, device):
        """One image's noise from its seed: a list per decode, in decode
        order (ReStyle: the average image, the refinements, the final
        conditioned decode)."""
        g = torch.Generator(device=device).manual_seed(int(seed))
        return [self.generator.make_noise(g, device) for _ in range(self.n_decodes())]

    def n_decodes(self):
        return self.enc_cycle + 1 if self.kind == "ReStyle" else 1

    def encode(self, x, noises):
        if self.kind == "E4E":
            lats, feats = self.encoder(resize_bilinear(x, (256, 256)))
            lats = lats + self.avg_latent[None]
        else:
            x256 = F.adaptive_avg_pool2d(x, (256, 256))
            lats = self.avg_latent[None].expand(x.shape[0], -1, -1)
            for k in range(self.enc_cycle):
                prev = F.adaptive_avg_pool2d(self.generator(lats, noises[k]), (256, 256))
                delta, feats = self.encoder(torch.cat([x256, prev], dim=1))
                lats = lats + delta
        lats = lats + self.delta_latent
        return lats, [conv(f) for conv, f in zip(self.feats_conv, feats)]

    def forward(self, x, noises):
        """x (B, S, S, 3); noises: each sample's make_noise, per decode the
        layers concatenated over the batch."""
        x = x.permute(0, 3, 1, 2)
        lats, feats_c = self.encode(x, noises)
        samm = SAMM(self, feats_c, self.mod_size)
        gen = self.generator(lats, noises[-1], samm)
        alpha = None
        for k in sorted(samm.aligns):
            a = resize_bilinear(samm.aligns[k][:, 2:3], (self.out_size, self.out_size))
            alpha = a if alpha is None else a * alpha + alpha * (1.0 - alpha)
        mask = torch.clamp(alpha, 0.0, 1.0)
        image = mask * x + gen * (1.0 - mask)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return {"image": nhwc(image), "mask": nhwc(mask), "gen_image": nhwc(gen), "lats": lats}


def build(network_g):
    """The inverter of a configuration's `network_g`."""
    return OODInverter(**{k: v for k, v in network_g.items() if k not in ("type", "dtype")})


def batch_noise(model, seeds, device):
    """Each seed's noise at batch 1, concatenated over the batch, per
    decode and layer."""
    draws = [model.make_noise(s, device) for s in seeds]
    return [[torch.cat([d[k][j] for d in draws]) for j in range(len(draws[0][k]))]
            for k in range(len(draws[0]))]
