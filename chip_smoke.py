#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

1. Builds every hand-written kernel of the port from `csrc/` with nvcc, one
   process per source, all at once.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (plus border-pinned flows, ragged tiles
   and bfloat16), and times the kernel, the plain version and the closest
   PyTorch library call with CUDA events.
3. Drives the main path -- E4E inversion at 1024px with the IR-SE-50
   encoder, cycle_align 2, warp_scale 0.08, ModSize 256, float32, seeded
   random weights -- through `InversionEngine.invert` and
   `invert_batch_perkey`, checks the outputs, the kernel launch counts and
   per-seed determinism across batch slots, and times it. Then drives the
   same engine with the phase-packed >=512px tail, plain and through each
   packed kernel ("pair": B3, "stage": B4), each path with the launch
   counts set to 0 just before it and read just after, and checks it
   against the unpacked engine. Then drives the engine with AlignNet's
   body0 through the fused kernels ("fused": B2a, B2b) and through the
   conv3x3 + activation kernel ("literal" + samm_conv_kernel: B5), checks
   each against the default engine, and times all three. Then holds the
   slice on the card against the same slice on the CPU at a small width,
   unpacked, with the whole-stage kernel, and in both body0 modes. Then
   runs the halo probe, the box-sum kernel's own path, against its oracle.
4. Prints the card's name and power limit, one JSON line describing the
   kernels, and as the last line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no last
line. It needs CUDA and refuses to run on the CPU.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32
# (non-tensor-core) and bf16 tensor-core rates. A card run below its 700 W
# limit is slower.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
SEED = 0
WARP_SHAPES = [(256, 128), (128, 256), (64, 512), (32, 512)]   # (H = W, C)
WARP_SCALE = 0.08
# the packed stages of the 1024px generator at channel_multiplier 2: coarse
# side H = W, input channels C1, unpacked output channels Cmid (C4 = 4 Cmid)
PACKED_STAGES = [(256, 128, 64), (512, 64, 32)]
# packed kernels against their plain versions: float32 within 1e-4 of
# max|ref| (sums over up to K = 9 * 256 terms in another order than cuDNN);
# bfloat16 operands within 2^-7 of max|ref| of the plain version on the same
# rounded operands in float32 (output rounding 2^-9, plus conv1's activation
# rounded to bfloat16 before conv2 reads it)
PACKED_TOL, PACKED_TOL_BF16 = 1e-4, 2.0 ** -7
# the packed-tail engines against the unpacked one on the same image, seed
# and noise: float32, the tail's sums in another order
TAIL_RTOL = 1e-4
# AlignNet body0 at the four SAMM scales of the 1024px model: (H = W, C);
# conv1 and conv2 are 2C -> 2C
SAMM_SCALES = [(32, 512), (64, 512), (128, 256), (256, 128)]
# body0 kernels against their plain versions: float32 within 1e-4 of
# max|ref| (sums over up to K = 9 * 1024 terms in another order than
# cuDNN); bfloat16 operands within 2^-7 of max|ref| of the plain version on
# the same rounded operands in float32 (the kernels round x1 and their
# output to bfloat16)
SAMM_TOL, SAMM_TOL_BF16 = 1e-4, 2.0 ** -7
# the body0-mode engines against the default engine: SAMM moves the flows,
# so a float32 difference in body0 moves sample positions
BODY0_RTOL = 1e-3


def log(msg):
    print(msg, flush=True)


def warp_inputs(b, size, c, scale, seed, at_bound=False):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, size, size, c).astype(np.float32)
    lin = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    base = np.stack(np.broadcast_arrays(lin[None, :], lin[:, None]), -1)
    if at_bound:
        flow = np.sign(rs.randn(b, size, size, 2)) * scale
    else:
        flow = np.tanh(rs.randn(b, size, size, 2)) * scale
    grid = (base[None] + flow).astype(np.float32)
    alpha = rs.rand(b, size, size, 1).astype(np.float32)
    dev = torch.device("cuda")
    return (torch.from_numpy(x).to(dev), torch.from_numpy(grid).to(dev),
            torch.from_numpy(alpha).to(dev))


def time_ms(fn, iters=30, warmup=3):
    """Median device time of fn() in ms, each call timed alone with CUDA
    events after a write of 128 MB that evicts the 50 MB L2, so every call
    starts cold as it does in the pipeline after the convolutions. A
    device-side sleep ahead of the first event keeps the card busy while
    the host enqueues, so host launch overhead stays out of the reading."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.fill_(1.0)
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def warp_bound_ms(b, size, c, itemsize):
    px = b * size * size
    nbytes = 2 * px * c * itemsize + 12 * px      # target in, out, grid + alpha
    flops = 11 * px * c                           # 4 taps x 2 + blend 3
    return bound_ms(flops, nbytes, FP32_FLOPS)


def bound_ms(flops, nbytes, peak):
    """(least ms, what bounds it): bytes over the HBM rate or flops over
    `peak`, whichever takes longer."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_build():
    from ood_gan_inversion_tpu_torch import build
    t0 = time.time()
    logs = build.build_all(["warp_blend", "packed_pair", "packed_stage", "samm_conv",
                            "halo_probe"])
    log(f"[build] nvcc sm_90a: {sorted(logs)} in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels():
    """warp_blend against warp_blend_reference at the main-path shapes."""
    from ood_gan_inversion_tpu_torch.ops.warp_blend import (
        warp_blend, warp_blend_reference)
    per_image = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    max_err, bound_by = 0.0, "bytes"
    for size, c in WARP_SHAPES:
        for b, at_bound in ((1, False), (2, False), (2, True)):
            x, grid, alpha = warp_inputs(b, size, c, WARP_SCALE,
                                         seed=size + c + b, at_bound=at_bound)
            out = warp_blend(x, grid, alpha)
            ref = warp_blend_reference(x, grid, alpha)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-5 * float(x.abs().max())
            if not err <= tol:
                raise AssertionError(f"warp_blend {b}x{size}x{size}x{c} "
                                     f"bound={at_bound}: err {err} > {tol}")
            max_err = max(max_err, err)
            if at_bound:
                log(f"[kernel] warp_blend b={b} {size}px C={c} flow at +-bound: "
                    f"max|err| {err:.3e} <= {tol:.3e}")
                continue
            # bfloat16 target, float32 math: within one bf16 step at max|x|
            xb = x.to(torch.bfloat16)
            outb = warp_blend(xb, grid, alpha).float()
            refb = warp_blend_reference(xb.float(), grid, alpha)
            errb = float((outb - refb).abs().max())
            tolb = 2.0 ** -8 * float(x.abs().max())
            if not errb <= tolb:
                raise AssertionError(f"warp_blend bf16 {b}x{size}x{c}: "
                                     f"err {errb} > {tolb}")
            xn = x.permute(0, 3, 1, 2).contiguous()
            an = alpha.permute(0, 3, 1, 2).contiguous()

            def library():
                w = F.grid_sample(xn, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=False)
                return w * an + xn * (1.0 - an)

            lib_err = float((library().permute(0, 2, 3, 1) - ref).abs().max())
            ms = time_ms(lambda: warp_blend(x, grid, alpha))
            plain = time_ms(lambda: warp_blend_reference(x, grid, alpha))
            lib = time_ms(library)
            bound, bound_by = warp_bound_ms(b, size, c, 4)
            log(f"[kernel] warp_blend b={b} {size}px C={c} fp32: max|err| "
                f"{err:.3e} <= {tol:.3e}; bf16 max|err| {errb:.3e} <= "
                f"{tolb:.3e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"grid_sample+blend {lib:.4f} ms (|diff| {lib_err:.1e}), "
                f"bound {bound:.4f} ms ({bound_by})")
            if b == 1:      # the main path: 2 align cycles per scale per image
                for k, v in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bound), ("library_ms", lib)):
                    per_image[k] += 2 * v
    log(f"[kernel] warp_blend per image (8 launches, b=1): "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_image.items()))
    return {"name": "warp_blend", "route": "cuda",
            "source": "ood_gan_inversion_tpu_torch/csrc/warp_blend.cu",
            "replaces": "ood_gan_inversion_tpu/ops/pallas_warp.py:64",
            "max_abs_err": max_err, "bound_by": bound_by, **per_image}


def packed_operands(b, h, c1, cmid, seed):
    """One packed stage's float32 operands on the card at O(1) activations,
    with K1, K2, the toRGB and the skip kernels built from random he-scaled
    weights by the port's polyphase functions, so each has its structural
    zeros as on the main path."""
    from ood_gan_inversion_tpu_torch.ops import polyphase as pp
    from ood_gan_inversion_tpu_torch.ops.upfirdn2d import make_kernel
    g = torch.Generator(device="cuda").manual_seed(seed)
    c4 = 4 * cmid

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def near1(*shape):
        return torch.rand(shape, generator=g, device="cuda") + 0.5

    blur = make_kernel((1, 3, 3, 1))
    k3 = pp.conv1x1_packed_kernel(rn(1, 1, cmid, 3, scale=cmid ** -0.5))[0, 0]
    return {
        "x": rn(b, h, h, c1), "n1": rn(b, h, h, 4, scale=0.1),
        "n2": rn(b, h, h, 4, scale=0.1), "skip": rn(b, h, h, 3),
        "k1": pp.upconv_blur_packed_kernel(rn(3, 3, c1, cmid, scale=(9 * c1) ** -0.5), blur),
        "s1": near1(b, c1), "d1": near1(b, c4), "b1": rn(c4, scale=0.1),
        "k2": pp.conv3x3_packed_kernel(rn(3, 3, cmid, cmid, scale=(9 * cmid) ** -0.5)),
        "s2": near1(b, c4), "d2": near1(b, c4), "b2": rn(c4, scale=0.1),
        "k3sr": pp.tile_phase_major(near1(b, cmid))[:, :, None] * k3[None],
        "b3": rn(12, scale=0.1), "k4": pp.skip_up_packed_kernel(blur, 3, device="cuda"),
    }


def conv_flops(b, h, k):
    """(dense, useful) flops of a pad-1 conv with the HWIO kernel k at
    (b, h, h): every (tap, ci, co) entry, and the non-zero ones only."""
    px = b * h * h
    return 2 * px * k[..., 0, 0].numel() * k.shape[2] * k.shape[3], 2 * px * int((k != 0).sum())


def bound_parts(flops, nbytes, peak):
    """Both sides of a bound, as text: flops over `peak`, bytes over HBM."""
    return (f"ops {1e3 * flops / peak:.4f} ms, bytes "
            f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms")


def library_conv_act(xn, n4n, wk, s, d, bias, cmid):
    """The yardstick of one packed conv: cuDNN F.conv2d of the packed kernel
    on channels_last views, then the epilogue as torch ops (NCHW shapes)."""
    y = F.conv2d(xn * s[:, :, None, None], wk, padding=1)
    y = y * d[:, :, None, None] + n4n.repeat_interleave(cmid, 1) + bias[None, :, None, None]
    return F.leaky_relu(y, 0.2) * math.sqrt(2.0)


def check_close(what, got, ref, tol):
    err = float((got.float() - ref).abs().max())
    lim = tol * float(ref.abs().max())
    if not err <= lim:
        raise AssertionError(f"{what}: max|err| {err} > {lim}")
    return err, lim


def phase_packed_kernels():
    """B3 (fused_conv3x3_act) and B4 (fused_packed_stage) against their
    plain versions at the launch shapes of the two packed stages of the
    1024px generator, b = 1 and 2, float32 and bfloat16 operands; times
    and bounds. Per image = b = 1, B3 4 launches, B4 2."""
    from ood_gan_inversion_tpu_torch.ops.packed_conv import (
        fused_conv3x3_act, fused_packed_stage, packed_conv3x3_act_reference,
        packed_stage_reference)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    per_image = {"B3": dict.fromkeys(keys, 0.0), "B4": dict.fromkeys(keys, 0.0)}
    max_err = {"B3": 0.0, "B4": 0.0}
    bound_by = {"B3": {}, "B4": {}}        # per image: bound ms by what bounds it
    gflop = {"B3": [0.0, 0.0], "B4": [0.0, 0.0]}          # dense, useful per image
    conv_names = ("x", "n1", "k1", "s1", "d1", "b1")
    for h, c1, cmid in PACKED_STAGES:
        c4, stage = 4 * cmid, f"{2 * h}px stage"
        for b in (1, 2):
            a = packed_operands(b, h, c1, cmid, seed=h + b)
            # ---- B3: conv1 on x, conv2 on conv1's output (plain version)
            z = packed_conv3x3_act_reference(*(a[k] for k in conv_names))
            convs = (("conv1", (a["x"], a["n1"], a["k1"], a["s1"], a["d1"], a["b1"])),
                     ("conv2", (z, a["n2"], a["k2"], a["s2"], a["d2"], a["b2"])))
            for name, args in convs:
                x, n4, k, s, d, bias = args
                ci, co = k.shape[2], k.shape[3]
                err, lim = check_close(f"B3 {stage} {name} b={b}",
                                       fused_conv3x3_act(*args),
                                       packed_conv3x3_act_reference(*args), PACKED_TOL)
                xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
                argsb = (xb, n4, kb, s, d, bias)
                errb, limb = check_close(
                    f"B3 {stage} {name} b={b} bf16", fused_conv3x3_act(*argsb),
                    packed_conv3x3_act_reference(xb.float(), n4, kb.float(), s, d, bias),
                    PACKED_TOL_BF16)
                xn, n4n = x.permute(0, 3, 1, 2), n4.permute(0, 3, 1, 2)
                wk = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                lib = lambda: library_conv_act(xn, n4n, wk, s, d, bias, co // 4)
                lib_diff = float((lib().permute(0, 2, 3, 1)
                                  - packed_conv3x3_act_reference(*args)).abs().max())
                t = {"ms": time_ms(lambda: fused_conv3x3_act(*args), iters=10),
                     "plain_ms": time_ms(lambda: packed_conv3x3_act_reference(*args), iters=10),
                     "library_ms": time_ms(lib, iters=10)}
                msb = time_ms(lambda: fused_conv3x3_act(*argsb), iters=10)
                dense, useful = conv_flops(b, h, k)
                epi = 5 * b * h * h * co
                nbytes = lambda isz: ((b * h * h * (ci + co) + 9 * ci * co) * isz
                                      + b * h * h * 16 + 4 * b * (ci + 2 * co))
                t["bound_ms"], by = bound_ms(useful + epi, nbytes(4), FP32_FLOPS)
                dense_ms, _ = bound_ms(dense + epi, nbytes(4), FP32_FLOPS)
                bf16_ms, bf16_by = bound_ms(useful + epi, nbytes(2), BF16_FLOPS)
                log(f"[kernel] B3 {stage} {name} b={b} ({h}x{h}, {ci}->{co}): fp32 "
                    f"max|err| {err:.3e} <= {lim:.3e}, bf16 {errb:.3e} <= {limb:.3e}; "
                    f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                    f"cudnn+epilogue {t['library_ms']:.4f} ms (|diff| {lib_diff:.1e}); "
                    f"bound {t['bound_ms']:.4f} ms ({by}: "
                    f"{bound_parts(useful + epi, nbytes(4), FP32_FLOPS)}; "
                    f"{useful / 1e9:.2f} useful GFLOP), dense {dense_ms:.4f} ms "
                    f"({dense / 1e9:.2f} GFLOP); "
                    f"bf16 kernel {msb:.4f} ms, bound {bf16_ms:.4f} ms ({bf16_by})")
                max_err["B3"] = max(max_err["B3"], err)
                if b == 1:
                    bound_by["B3"][by] = bound_by["B3"].get(by, 0.0) + t["bound_ms"]
                    for key in keys:
                        per_image["B3"][key] += t[key]
                    gflop["B3"][0] += dense / 1e9
                    gflop["B3"][1] += useful / 1e9
            # ---- B4: the whole stage
            args = tuple(a.values())
            rgb, z2 = fused_packed_stage(*args)
            rgb_ref, z2_ref = packed_stage_reference(*args)
            err = max(check_close(f"B4 {stage} b={b} z2", z2, z2_ref, PACKED_TOL)[0],
                      check_close(f"B4 {stage} b={b} rgb", rgb, rgb_ref, PACKED_TOL)[0])
            bf = {k: (v.to(torch.bfloat16) if k in ("x", "skip", "k1", "k2", "k3sr", "k4")
                      else v) for k, v in a.items()}
            argsb = tuple(bf.values())
            rgbb, z2b = fused_packed_stage(*argsb)
            rgbb_ref, z2b_ref = packed_stage_reference(*(v.float() for v in argsb))
            errb = max(check_close(f"B4 {stage} b={b} bf16 z2", z2b, z2b_ref, PACKED_TOL_BF16)[0],
                       check_close(f"B4 {stage} b={b} bf16 rgb", rgbb, rgbb_ref,
                                   PACKED_TOL_BF16)[0])
            wk1, wk2, wk4 = (a[k].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                             for k in ("k1", "k2", "k4"))
            xn, skn = a["x"].permute(0, 3, 1, 2), a["skip"].permute(0, 3, 1, 2)
            n1n, n2n = a["n1"].permute(0, 3, 1, 2), a["n2"].permute(0, 3, 1, 2)

            def lib():
                zz = library_conv_act(xn, n1n, wk1, a["s1"], a["d1"], a["b1"], cmid)
                zz2 = library_conv_act(zz, n2n, wk2, a["s2"], a["d2"], a["b2"], cmid)
                return (torch.einsum("bchw,bco->bohw", zz2, a["k3sr"])
                        + a["b3"][None, :, None, None] + F.conv2d(skn, wk4, padding=1))

            lib_diff = float((lib().permute(0, 2, 3, 1) - rgb_ref).abs().max())
            t = {"ms": time_ms(lambda: fused_packed_stage(*args), iters=10),
                 "plain_ms": time_ms(lambda: packed_stage_reference(*args), iters=10),
                 "library_ms": time_ms(lib, iters=10)}
            msb = time_ms(lambda: fused_packed_stage(*argsb), iters=10)
            d1, u1 = conv_flops(b, h, a["k1"])
            d2, u2 = conv_flops(b, h, a["k2"])
            px = b * h * h
            d3, u3 = 2 * px * c4 * 12, 2 * h * h * int((a["k3sr"] != 0).sum())
            d4, u4 = conv_flops(b, h, a["k4"])
            epi = 5 * 2 * px * c4 + 2 * px * 12
            dense, useful = d1 + d2 + d3 + d4 + epi, u1 + u2 + u3 + u4 + epi
            nbytes = lambda isz: ((px * (c1 + c4 + 12 + 3) + 9 * c4 * (c1 + c4)
                                   + b * c4 * 12 + 9 * 36) * isz
                                  + 2 * px * 16 + 4 * b * (c1 + 5 * c4 + 12))
            t["bound_ms"], by = bound_ms(useful, nbytes(4), FP32_FLOPS)
            dense_ms, _ = bound_ms(dense, nbytes(4), FP32_FLOPS)
            bf16_ms, bf16_by = bound_ms(useful, nbytes(2), BF16_FLOPS)
            log(f"[kernel] B4 {stage} b={b} ({h}x{h}, {c1}->{c4}->{c4}, rgb 12): fp32 "
                f"max|err| {err:.3e} <= {PACKED_TOL:.0e} of max|ref|, bf16 "
                f"{errb:.3e}; kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                f"cudnn chain {t['library_ms']:.4f} ms (|diff| {lib_diff:.1e}); "
                f"bound {t['bound_ms']:.4f} ms ({by}: "
                f"{bound_parts(useful, nbytes(4), FP32_FLOPS)}; {useful / 1e9:.2f} useful GFLOP), "
                f"dense {dense_ms:.4f} ms ({dense / 1e9:.2f} GFLOP); bf16 kernel "
                f"{msb:.4f} ms, bound {bf16_ms:.4f} ms ({bf16_by})")
            max_err["B4"] = max(max_err["B4"], err)
            if b == 1:
                bound_by["B4"][by] = bound_by["B4"].get(by, 0.0) + t["bound_ms"]
                for key in keys:
                    per_image["B4"][key] += t[key]
                gflop["B4"][0] += dense / 1e9
                gflop["B4"][1] += useful / 1e9
    entries = []
    for kid, name, src, line in (
            ("B3", "fused_conv3x3_act", "packed_pair.cu", 158),
            ("B4", "fused_packed_stage", "packed_stage.cu", 275)):
        log(f"[kernel] {kid} {name} per image (b=1): "
            + ", ".join(f"{k} {v:.4f}" for k, v in per_image[kid].items())
            + f"; {gflop[kid][0]:.2f} dense, {gflop[kid][1]:.2f} useful GFLOP")
        entries.append({"name": name, "route": "cuda",
                        "source": f"ood_gan_inversion_tpu_torch/csrc/{src}",
                        "replaces": f"ood_gan_inversion_tpu/ops/pallas_kernels.py:{line}",
                        "max_abs_err": max_err[kid],
                        "bound_by": max(bound_by[kid], key=bound_by[kid].get),
                        **per_image[kid]})
    return entries


def samm_operands(b, h, c, seed):
    """AlignNet body0's operands on the card at O(1) activations: raw
    features s, t (B, C, H, H), norm1/norm2 affines, kernels k1, k2
    (2C, 2C, 3, 3) scaled by 1/sqrt(fan-in), PReLU slopes; the coefficients
    of (s, t), and x1, the concat that the literal path convolves."""
    from ood_gan_inversion_tpu_torch.ops.alignnet import _alignnet_coeffs
    g = torch.Generator(device="cuda").manual_seed(seed)
    c2 = 2 * c

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=g, device="cuda") * scale + shift

    a = {"s": rn(b, c, h, h), "t": rn(b, c, h, h, scale=2.0, shift=0.3),
         "g1": rn(c2, scale=0.1, shift=1.0), "b1": rn(c2, scale=0.1),
         "k1": rn(c2, c2, 3, 3, scale=(9 * c2) ** -0.5), "alpha": rn(c2, scale=0.05, shift=0.25),
         "k2": rn(c2, c2, 3, 3, scale=(9 * c2) ** -0.5),
         "g2": rn(c2, scale=0.1, shift=1.0), "b2": rn(c2, scale=0.1)}
    a["coeffs"] = _alignnet_coeffs(a["s"], a["t"], a["g1"], a["b1"], True, 1e-5)[0]
    a["x1"] = body0_x1(a)
    return a


def body0_x1(a):
    """norm1(concat) from (s, t) and the coefficients: conv1's input."""
    cf = [a["coeffs"][:, i, :, None, None] for i in range(5)]
    return torch.cat([cf[0] * a["s"] + cf[1] * a["t"] + cf[2], cf[3] * a["t"] + cf[4]], 1)


def first(out):
    """The main output of a kernel or its plain version: y2 of B2b's
    (y2, moments), the tensor itself otherwise."""
    return out[0] if isinstance(out, tuple) else out


def conv_moments(z, k):
    """The yardstick of B2b: cuDNN conv, then the moment sums."""
    y = F.conv2d(z, k, padding=1)
    return y, torch.stack([y.sum((2, 3)), (y * y).sum((2, 3))], 1)


def phase_samm_kernels():
    """B2a (alignnet_conv1), B2b (alignnet_conv2) and B5 (conv3x3_act)
    against their plain versions at AlignNet body0's launch shapes at the
    four SAMM scales of the 1024px model (b = 1, and b = 2 at 64px),
    float32 and bfloat16 operands; times and bounds; and the whole body0
    fused against the port's algebraic body0. Per image = b = 1, 2 align
    cycles per scale: B2a 8 launches, B2b 8, B5 16 (conv1 + PReLU and
    conv2 in each cycle)."""
    from ood_gan_inversion_tpu_torch.ops import alignnet as an
    from ood_gan_inversion_tpu_torch.ops.samm_conv import conv3x3_act, conv3x3_act_reference
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    ids = ("B2a", "B2b", "B5")
    per_image = {k: dict.fromkeys(keys, 0.0) for k in ids}
    max_err = dict.fromkeys(ids, 0.0)
    bound_by = {k: {} for k in ids}
    body0 = {"fused": 0.0, "algebraic": 0.0}
    bf16 = lambda v: v.to(torch.bfloat16)
    for h, c in SAMM_SCALES:
        for b in ((1, 2) if h == 64 else (1,)):
            a = samm_operands(b, h, c, seed=h + c + b)
            c2, px = 2 * c, b * h * h
            conv_flops = 2 * 9 * px * c2 * c2
            conv1 = (a["s"], a["t"], a["coeffs"], a["k1"], a["alpha"])
            z = an.alignnet_conv1_reference(*conv1)
            s_b, t_b, k1_b, k2_b, z_b = map(bf16, (a["s"], a["t"], a["k1"], a["k2"], z))
            runs = {
                # id: (kernel, plain, library, bf16 kernel, bf16 plain on the
                # same rounded operands, flops, bytes at an itemsize)
                "B2a": (lambda: an.alignnet_conv1(*conv1),
                        lambda: an.alignnet_conv1_reference(*conv1),
                        lambda: F.prelu(F.conv2d(body0_x1(a), a["k1"], padding=1), a["alpha"]),
                        lambda: an.alignnet_conv1(s_b, t_b, a["coeffs"], k1_b, a["alpha"]),
                        lambda: an.alignnet_conv1_reference(s_b.float(), t_b.float(), a["coeffs"],
                                                            k1_b.float(), a["alpha"]),
                        conv_flops + 6 * px * c2,
                        lambda isz: (2 * px * c + 9 * c2 * c2 + px * c2) * isz
                        + 4 * (5 * b * c + c2)),
                "B2b": (lambda: an.alignnet_conv2(z, a["k2"]),
                        lambda: an.alignnet_conv2_reference(z, a["k2"]),
                        lambda: conv_moments(z, a["k2"]),
                        lambda: an.alignnet_conv2(z_b, k2_b),
                        lambda: an.alignnet_conv2_reference(z_b.float(), k2_b.float()),
                        conv_flops + 3 * px * c2,
                        lambda isz: (px * c2 + 9 * c2 * c2) * isz + 4 * (px * c2 + 2 * b * c2)),
                "B5 conv1": (lambda: conv3x3_act(a["x1"], a["k1"], a["alpha"], "prelu"),
                             lambda: conv3x3_act_reference(a["x1"], a["k1"], a["alpha"], "prelu"),
                             lambda: F.prelu(F.conv2d(a["x1"], a["k1"], padding=1), a["alpha"]),
                             lambda: conv3x3_act(bf16(a["x1"]), k1_b, a["alpha"], "prelu"),
                             lambda: conv3x3_act_reference(bf16(a["x1"]).float(), k1_b.float(),
                                                           a["alpha"], "prelu"),
                             conv_flops + 2 * px * c2,
                             lambda isz: (2 * px * c2 + 9 * c2 * c2) * isz + 4 * c2),
                "B5 conv2": (lambda: conv3x3_act(z, a["k2"], None, "none"),
                             lambda: conv3x3_act_reference(z, a["k2"], None, "none"),
                             lambda: F.conv2d(z, a["k2"], padding=1),
                             lambda: conv3x3_act(z_b, k2_b, None, "none"),
                             lambda: conv3x3_act_reference(z_b.float(), k2_b.float(), None, "none"),
                             conv_flops,
                             lambda isz: (2 * px * c2 + 9 * c2 * c2) * isz),
            }
            for name, (kern, plain, lib, kern_b, plain_b, flops, nbytes) in runs.items():
                what = f"{name} {h}px b={b} ({c2}->{c2})"
                got, ref = kern(), plain()
                err = check_close(what, first(got), first(ref), SAMM_TOL)[0]
                # B2b's moments, each row against its own max|ref|
                moments = [check_close(f"{what} moments {m}", got[1][:, m], ref[1][:, m],
                                       SAMM_TOL) for m in range(2) if name == "B2b"]
                moment_text = "".join(f", sum y{'^2' if m else ''} rel err {e / l * SAMM_TOL:.2e}"
                                      for m, (e, l) in enumerate(moments))
                # B2b's bfloat16 run reads the same operands as its plain version
                errb, limb = check_close(f"{what} bf16", first(kern_b()), first(plain_b()),
                                         SAMM_TOL if name == "B2b" else SAMM_TOL_BF16)
                lib_diff = float((first(lib()) - first(ref)).abs().max())
                t = {"ms": time_ms(kern, iters=10), "plain_ms": time_ms(plain, iters=10),
                     "library_ms": time_ms(lib, iters=10)}
                msb = time_ms(kern_b, iters=10)
                t["bound_ms"], by = bound_ms(flops, nbytes(4), FP32_FLOPS)
                bf16_ms, bf16_by = bound_ms(flops, nbytes(2), BF16_FLOPS)
                log(f"[kernel] {what}: fp32 max|err| {err:.3e} (<= {SAMM_TOL:.0e} of max|ref|)"
                    f"{moment_text}, "
                    f"bf16 {errb:.3e} <= {limb:.3e}; kernel {t['ms']:.4f} ms "
                    f"({flops / t['ms'] / 1e9:.1f} TFLOP/s), plain {t['plain_ms']:.4f} ms, "
                    f"cudnn+epilogue {t['library_ms']:.4f} ms (|diff| {lib_diff:.1e}); bound "
                    f"{t['bound_ms']:.4f} ms ({by}: {bound_parts(flops, nbytes(4), FP32_FLOPS)}; "
                    f"{flops / 1e9:.2f} GFLOP); bf16 kernel {msb:.4f} ms, bound {bf16_ms:.4f} ms "
                    f"({bf16_by})")
                kid = name.split()[0]
                max_err[kid] = max(max_err[kid], err)
                if b == 1:      # the main path: 2 align cycles per scale per image
                    bound_by[kid][by] = bound_by[kid].get(by, 0.0) + 2 * t["bound_ms"]
                    for key in keys:
                        per_image[kid][key] += 2 * t[key]
            args = [a[k] for k in ("s", "t", "g1", "b1", "k1", "alpha", "k2", "g2", "b2")]
            fused = an.fused_alignnet_body0(*args, True)
            alg = an.algebraic_alignnet_body0(*args, True)
            err, lim = check_close(f"body0 {h}px b={b} fused vs algebraic", fused, alg, SAMM_TOL)
            tf = time_ms(lambda: an.fused_alignnet_body0(*args, True), iters=10)
            ta = time_ms(lambda: an.algebraic_alignnet_body0(*args, True), iters=10)
            log(f"[kernel] body0 {h}px b={b} C={c}: fused {tf:.4f} ms, algebraic {ta:.4f} ms "
                f"(no t-context), max|diff| {err:.3e} <= {lim:.3e}")
            if b == 1:
                body0["fused"] += 2 * tf
                body0["algebraic"] += 2 * ta
    log(f"[kernel] body0 per image (8 calls, b=1): fused {body0['fused']:.4f} ms, "
        f"algebraic {body0['algebraic']:.4f} ms")
    entries = []
    for kid, name, line in (("B2a", "alignnet_conv1", 982), ("B2b", "alignnet_conv2", 1005),
                            ("B5", "conv3x3_act", 517)):
        log(f"[kernel] {kid} {name} per image (b=1): "
            + ", ".join(f"{k} {v:.4f}" for k, v in per_image[kid].items()))
        entries.append({"name": name, "route": "cuda",
                        "source": "ood_gan_inversion_tpu_torch/csrc/samm_conv.cu",
                        "replaces": f"ood_gan_inversion_tpu/ops/pallas_kernels.py:{line}",
                        "max_abs_err": max_err[kid],
                        "bound_by": max(bound_by[kid], key=bound_by[kid].get),
                        **per_image[kid]})
    return entries


def phase_probe():
    """The halo probe's own path: the box sum of the probe's input, a
    (32, 32) float32 array from numpy seed 0, through box3x3 with the counts
    set to 0 just before and read just after; held against its plain version
    and against the oracle (a convolution with a ones kernel); timed."""
    from ood_gan_inversion_tpu_torch.ops.halo_probe import box3x3, box3x3_reference
    x = torch.from_numpy(np.random.RandomState(0).randn(32, 32).astype(np.float32)).cuda()
    reset_counts()
    out = box3x3(x)
    torch.cuda.synchronize()
    launches = read_counts()["box3x3"]
    if launches != 1:
        raise AssertionError(f"probe: {launches} box3x3 launches, expected 1")
    ref = box3x3_reference(x)
    oracle = lambda: F.conv2d(x[None, None], torch.ones(1, 1, 3, 3, device="cuda"),
                              padding=1)[0, 0]
    if not torch.equal(out, ref):
        raise AssertionError("probe: box3x3 differs from its plain version")
    err = float((out - oracle()).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"probe: box3x3 vs the oracle max|err| {err} > 1e-5")
    t = {"ms": time_ms(lambda: box3x3(x)), "plain_ms": time_ms(lambda: box3x3_reference(x)),
         "library_ms": time_ms(oracle)}
    t["bound_ms"], by = bound_ms(8 * x.numel(), 2 * 4 * x.numel(), FP32_FLOPS)
    log(f"[probe] box3x3 (32, 32): equal to its plain version, max|err| vs the oracle "
        f"{err:.3e} <= 1e-5; kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"conv2d {t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms ({by}); launches "
        f"{launches}")
    return {"name": "box3x3", "route": "cuda",
            "source": "ood_gan_inversion_tpu_torch/csrc/halo_probe.cu",
            "replaces": "tools/prof/prof_pallas_halo.py:23", "launches": launches,
            "max_abs_err": float((out - ref).abs().max()), "bound_by": by, **t}


def e4e_opt(**overrides):
    """options/test/E4E_Face_test.yml `network_g`, as a dict."""
    g = {"type": "ood_faceGAN_e4e", "out_size": 1024, "style_dim": 512,
         "encoder": "E4E", "enable_modulation": True,
         "modulation_type": "NOISE", "warp_scale": 0.08, "cycle_align": 2,
         "blend_with_gen": True, "ModSize": 256, "stage": "Inference"}
    g.update(overrides)
    return {"network_g": g}


def noisy(engine):
    """Seeded weights leave the noise strengths at their init, 0; set them
    to 0.1 so that a reply really depends on its seed."""
    from ood_gan_inversion_tpu_torch.nn.stylegan2 import NoiseInjection
    for m in engine.net.modules():
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.1)
    return engine


KERNEL_COUNTERS = ("warp_blend", "fused_conv3x3_act", "fused_packed_stage",
                   "alignnet_conv1", "alignnet_conv2", "conv3x3_act", "box3x3")


def counters():
    from ood_gan_inversion_tpu_torch.ops.alignnet import alignnet_conv1, alignnet_conv2
    from ood_gan_inversion_tpu_torch.ops.halo_probe import box3x3
    from ood_gan_inversion_tpu_torch.ops.packed_conv import (
        fused_conv3x3_act, fused_packed_stage)
    from ood_gan_inversion_tpu_torch.ops.samm_conv import conv3x3_act
    from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend
    return dict(zip(KERNEL_COUNTERS, (warp_blend, fused_conv3x3_act, fused_packed_stage,
                                      alignnet_conv1, alignnet_conv2, conv3x3_act, box3x3)))


def expected_counts(**launches):
    """Every kernel's count: 0 except the ones given."""
    return {**dict.fromkeys(KERNEL_COUNTERS, 0), **launches}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def drive(engine, imgs):
    """The main path's four requests: one `invert` and a batch of three
    whose slot 2 repeats it. Counts set to 0 just before, read just after.
    Returns (alone, batch, launches, ms of invert, ms/img of the batch)."""
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    alone = engine.invert(imgs[0], seed=7)
    ev[1].record()
    batch = engine.invert_batch_perkey([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    ev[2].record()
    torch.cuda.synchronize()
    return (alone, batch, read_counts(), ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / 3)


def check_replies(what, alone, batch):
    for name, out, n in (("invert", alone, 1), ("invert_batch_perkey", batch, 3)):
        if tuple(out["image"].shape) != (n, 1024, 1024, 3):
            raise AssertionError(f"{what} {name} image shape {tuple(out['image'].shape)}")
        if tuple(out["mask"].shape) != (n, 1024, 1024, 1):
            raise AssertionError(f"{what} {name} mask shape {tuple(out['mask'].shape)}")
        for k in ("image", "gen_image", "mask", "lats"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"{what} {name} {k} has non-finite values")
        m = out["mask"]
        if not (float(m.min()) >= 0.0 and float(m.max()) <= 1.0):
            raise AssertionError(f"{what} {name} mask outside [0, 1]")
        for k, s in ((1, 32), (2, 64), (3, 128), (4, 256)):
            if tuple(out["aligns"][k].shape) != (n, s, s, 3):
                raise AssertionError(f"{what} {name} align {k} shape")
    if not torch.equal(alone["image"][0], batch["image"][2]):
        raise AssertionError(f"{what}: seed 7 gave a different image in batch slot 2")
    if torch.equal(batch["image"][0], batch["image"][1]):
        raise AssertionError(f"{what}: different seeds and images gave one image")


def phase_main_path():
    """The default engine (unpacked tail). Returns (B1 launches, engine,
    images, its replies)."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    t0 = time.time()
    engine = noisy(InversionEngine(e4e_opt(), seed=SEED, device="cuda"))
    n_params = sum(p.numel() for p in engine.net.parameters())
    log(f"[main] engine: 1024px, IR-SE-50, {n_params} parameters, "
        f"built in {time.time() - t0:.1f} s")
    rs = np.random.RandomState(SEED)
    imgs = [rs.rand(1024, 1024, 3).astype(np.float32) for _ in range(3)]
    engine.invert(imgs[0], seed=7)           # warm-up: cuDNN plans, libraries
    torch.cuda.synchronize()
    alone, batch, launches, ms_single, ms_batch = drive(engine, imgs)
    want = expected_counts(warp_blend=8 * 4)
    if launches != want:
        raise AssertionError(f"default path launched {launches}, expected {want}")
    check_replies("default", alone, batch)
    log(f"[main] 4 requests answered; launches {launches} (warp_blend 8 per "
        "image); slot 2 of the batch == the lone request: True")
    log(f"[main] ms/img: invert {ms_single:.2f}, invert_batch_perkey "
        f"{ms_batch:.2f} (CUDA events, 1024px, float32)")
    return launches["warp_blend"], engine, imgs, (alone, batch)


def phase_packed_tail(engine, imgs, replies):
    """The same engine's weights with the packed tail: plain ("none"), B3
    ("pair") and B4 ("stage"). Each path's launch counts, its replies
    against the unpacked engine's (mask and lats bit-identical: the tail
    lies after every SAMM block), per-seed determinism; then invert ms/img
    of the four configurations, 5 interleaved rounds. Returns the B3 count
    of the pair path and the B4 count of the stage path."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.nn.stylegan2 import TAIL_KERNELS
    params = engine.net.state_dict()
    engines, launches = {"unpacked": engine}, {}
    per_image = {"none": {}, "pair": {"fused_conv3x3_act": 4},
                 "stage": {"fused_packed_stage": 2}}
    for kern in TAIL_KERNELS:
        eng = InversionEngine(e4e_opt(), params=params, device="cuda",
                              packed_tail=True, tail_kernel=kern)
        eng.invert(imgs[0], seed=7)          # warm-up
        torch.cuda.synchronize()
        alone, batch, counts, _, _ = drive(eng, imgs)
        want = expected_counts(warp_blend=8 * 4,
                               **{k: 4 * v for k, v in per_image[kern].items()})
        if counts != want:
            raise AssertionError(f"packed tail {kern!r} launched {counts}, expected {want}")
        check_replies(f"packed tail {kern!r}", alone, batch)
        errs = {}
        for got, ref in zip((alone, batch), replies):
            for k in ("mask", "lats"):
                if not torch.equal(got[k], ref[k]):
                    raise AssertionError(f"packed tail {kern!r}: {k} differs from "
                                         "the unpacked engine")
            for k in ("image", "gen_image"):
                err = float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
                if not err <= TAIL_RTOL:
                    raise AssertionError(f"packed tail {kern!r} {k}: rel err {err} "
                                         f"> {TAIL_RTOL}")
                errs[k] = max(errs.get(k, 0.0), err)
        log(f"[main] packed tail {kern!r}: launches {counts}; mask and lats "
            "bit-identical to the unpacked engine; max rel err image "
            f"{errs['image']:.2e}, gen_image {errs['gen_image']:.2e} <= {TAIL_RTOL}; "
            "slot 2 == the lone request: True")
        launches.update({k: counts[k] for k in per_image[kern]})
        engines[f"packed {kern}"] = eng
    reps = {name: [] for name in engines}
    for i in range(5):
        for name, eng in engines.items():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            eng.invert(imgs[i % 3], seed=i)
            b.record()
            b.synchronize()
            reps[name].append(a.elapsed_time(b))
    for name, r in reps.items():
        log(f"[main] invert ms/img, {name} tail, 5 interleaved rounds: median "
            f"{float(np.median(r)):.2f}, all {[round(v, 2) for v in r]}")
    return launches


def phase_samm_body0(engine, imgs, replies):
    """The same engine's weights with AlignNet's body0 through the fused
    kernels ("fused": B2a and B2b at every scale) and through the
    conv3x3 + activation kernel ("literal" + samm_conv_kernel: B5 for both
    body0 convs at every scale). Each path's launch counts, its replies
    against the default engine's (lats bit-identical: the encoder runs
    before any SAMM block; image, gen_image and mask within BODY0_RTOL of
    max|ref|), per-seed determinism; then invert ms/img of the three,
    5 interleaved rounds. Returns each kernel's count from its path."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    params = engine.net.state_dict()
    engines, launches = {"algebraic (default)": engine}, {}
    modes = {"fused": ({"samm_body0": "fused"},
                       {"alignnet_conv1": 8, "alignnet_conv2": 8}),
             "literal + B5": ({"samm_body0": "literal", "samm_conv_kernel": True},
                              {"conv3x3_act": 16})}
    for label, (kwargs, per_image) in modes.items():
        eng = InversionEngine(e4e_opt(), params=params, device="cuda", **kwargs)
        eng.invert(imgs[0], seed=7)          # warm-up
        torch.cuda.synchronize()
        alone, batch, counts, _, _ = drive(eng, imgs)
        want = expected_counts(warp_blend=8 * 4, **{k: 4 * v for k, v in per_image.items()})
        if counts != want:
            raise AssertionError(f"body0 {label!r} launched {counts}, expected {want}")
        check_replies(f"body0 {label!r}", alone, batch)
        errs = {}
        for got, ref in zip((alone, batch), replies):
            if not torch.equal(got["lats"], ref["lats"]):
                raise AssertionError(f"body0 {label!r}: lats differ from the default engine")
            for k in ("image", "gen_image", "mask"):
                err = float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
                if not err <= BODY0_RTOL:
                    raise AssertionError(f"body0 {label!r} {k}: rel err {err} > {BODY0_RTOL}")
                errs[k] = max(errs.get(k, 0.0), err)
        log(f"[main] body0 {label!r}: launches {counts}; lats bit-identical to the default "
            f"engine; max rel err image {errs['image']:.2e}, gen_image "
            f"{errs['gen_image']:.2e}, mask {errs['mask']:.2e} <= {BODY0_RTOL}; "
            "slot 2 == the lone request: True")
        launches.update({k: counts[k] for k in per_image})
        engines[label] = eng
    reps = {name: [] for name in engines}
    for i in range(5):
        for name, eng in engines.items():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            eng.invert(imgs[i % 3], seed=i)
            b.record()
            b.synchronize()
            reps[name].append(a.elapsed_time(b))
    for name, r in reps.items():
        log(f"[main] invert ms/img, body0 {name}, 5 interleaved rounds: median "
            f"{float(np.median(r)):.2f}, all {[round(v, 2) for v in r]}")
    return launches


def phase_small_reference():
    """The slice at a small width on the card (kernels) against the same
    weights on the CPU (plain versions), the port's CPU path being the one
    the tests hold against the JAX package: unpacked, with the packed tail
    through the whole-stage kernel, and with body0 "fused" and "literal" +
    B5, the gates' channel floors lowered so that every SAMM scale runs
    the kernels."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.ops import alignnet, samm_conv
    opt = e4e_opt(out_size=512, channel_multiplier=1, narrow=0.25,
                  encoder_num_layers=4)
    params = noisy(InversionEngine(opt, seed=SEED + 1, device="cuda")).net.state_dict()
    img = np.random.RandomState(SEED + 1).rand(512, 512, 3).astype(np.float32)
    x = torch.from_numpy(img[None] * 2.0 - 1.0)
    # (what, engine options, launches of the card's forward); SAMM C is 128,
    # 64, 32, 16 at 32..256px, so 2C >= 32 everywhere
    cases = [("unpacked", {}, {}),
             ("packed tail, stage kernel", {"packed_tail": True, "tail_kernel": "stage"},
              {"fused_packed_stage": 1}),
             ("body0 fused", {"samm_body0": "fused"},
              {"alignnet_conv1": 8, "alignnet_conv2": 8}),
             ("body0 literal + B5", {"samm_body0": "literal", "samm_conv_kernel": True},
              {"conv3x3_act": 16})]
    floors = (alignnet.FUSED_MIN_CHANNELS, samm_conv.CONV_ACT_MIN_CHANNELS)
    alignnet.FUSED_MIN_CHANNELS, samm_conv.CONV_ACT_MIN_CHANNELS = 16, 32
    try:
        for what, kwargs, launches in cases:
            gpu = InversionEngine(opt, params=params, device="cuda", **kwargs)
            cpu = InversionEngine(opt, params=params, device="cpu", **kwargs)
            # the same noise on both devices: draw it on the CPU, copy to the card
            noise = cpu.net.generator.make_noise(
                1, torch.Generator().manual_seed(3), torch.device("cpu"))
            with torch.inference_mode():
                ref = cpu.net(x, mod_size=256, noise=noise)
                reset_counts()
                out = gpu.net(x.cuda(), mod_size=256, noise=[n.cuda() for n in noise])
                torch.cuda.synchronize()
                counts = read_counts()
            want = expected_counts(warp_blend=8, **launches)
            if counts != want:
                raise AssertionError(f"small slice {what}: launched {counts}, expected {want}")
            for k in ("image", "mask", "gen_image"):
                r = ref[k].numpy()
                err = float(np.abs(out[k].cpu().numpy() - r).max() / np.abs(r).max())
                if not err <= 1e-3:
                    raise AssertionError(f"small slice {what} {k}: card vs CPU rel err {err}")
                log(f"[check] small slice (512px, {what}) {k}: card vs CPU max rel err "
                    f"{err:.2e}")
    finally:
        alignnet.FUSED_MIN_CHANNELS, samm_conv.CONV_ACT_MIN_CHANNELS = floors


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    # plain versions and yardsticks in full float32 (cuDNN defaults to
    # TF32), as InversionEngine sets it for the main path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    entries = [phase_kernels(), *phase_packed_kernels(), *phase_samm_kernels()]
    entries[0]["launches"], engine, imgs, replies = phase_main_path()
    launches = phase_packed_tail(engine, imgs, replies)
    launches.update(phase_samm_body0(engine, imgs, replies))
    for e in entries[1:]:
        e["launches"] = launches[e["name"]]
    phase_small_reference()
    entries.append(phase_probe())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
