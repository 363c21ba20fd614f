#!/usr/bin/env python3
"""What the TMA kernel's drains buy, and B2a, B3 and B4 on the TMA kernel, on
a CUDA card:
python3 tools/prof_tma_conv.py [--sections bf16,f32,b2b-f32,b4-f32,b3-f32,b4-bf16,b3-bf16]

Seven sections, all by default:

bf16. The bfloat16 path of B2b (csrc/tma_conv.cuh, `ogi_alignnet_conv2`)
adds its products to its accumulator on the CUDA cores every DRAIN_STAGES
stages (the drain); in between, and in B5 throughout, the tensor cores
accumulate, adding with truncation. This script builds copies of
csrc/alignnet_conv2.cu under build/tma_conv_variants/ that drain every
16 stages and never, then at the four SAMM scales of the 1024px model (b = 1,
2C -> 2C, seeded inputs) prints, for the shipped B2b and each copy, y2's
and both moments' max|err| / max|ref| against the plain version on the
same bfloat16 operands, the mean signed relative error of sum y2^2 (the
truncation's bias), and each one's time (L2 flushed, median of 10), beside
B5's on the same operands. Then, at each scale, bfloat16 B2a
(`alignnet_conv1`: the repack pass's x1 mode, then the TMA kernel in B5's
mode) on seeded s, t (b = 1, C = 2C / 2): its max|err| / max|ref| against
its kernel's plain version, its time, its x1 repack's alone, and cuDNN's
bfloat16 conv + PReLU on the same x1.

f32. The float32 mode (3xTF32, B5's and B2a's float32 path), which drains
every TF32_DRAIN_STAGES stages: copies of csrc/samm_conv.cu that drain
every 1, 2 and 4 stages, and never; at each SAMM scale (b = 1) float32 B5
(act none) on `tf32_cancel_inputs` (where one TF32 pass misses 1e-4 of
max|ref| by >10x) and on zero-mean inputs, each variant's max|err| /
max|ref| against the plain version (cuDNN, TF32 off) and its time, the
float32 repack pass alone, cuDNN's float32 conv, and float32 B2a with its
x1 repack alone.

b2b-f32. float32 B2b (AN_CONV2_TF32), which drains every
TF32_CONV2_DRAIN_STAGES stages: copies of csrc/alignnet_conv2.cu that drain
every stage, every 2 stages and never; at each SAMM scale (b = 1), on
zero-mean inputs and on `tf32_cancel_inputs`, each variant's max|err| /
max|ref| of y2 and of both moments against the plain version
(`alignnet_conv2_kernel_reference`), the mean signed relative error of sum
y2^2, and its time (two readings in turns, zero-mean inputs), beside the
float32 repack pass alone and cuDNN's float32 conv + moments.

b4-f32, b4-bf16. B4 (csrc/packed_stage.cu on the TMA core) in float32 or
bfloat16 at both packed stages of the 1024px generator (b = 1): the whole
call, and each of its launches alone (the repack, conv1 with z out as
conv2's operand, conv2 with z2 and the toRGB partials, the rgb pass),
beside the tensor-core bound of the dense and of the useful convs (3xTF32
or bfloat16).

b3-f32, b3-bf16. B3 (csrc/packed_stage.cu on the TMA core, PACKED_TF32 or
PACKED) in float32 or bfloat16 at both convs of both packed stages (b =
1): the whole call and its two launches alone (the repack of x * s_in and
k into the core's operands, the conv), beside the dense and useful bounds
of the conv (3xTF32 or bfloat16).
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import time_ms  # noqa: E402

from ood_gan_inversion_tpu_torch import build  # noqa: E402
from ood_gan_inversion_tpu_torch.ops import alignnet, samm_conv  # noqa: E402

SCALES = [(32, 1024), (64, 1024), (128, 512), (256, 256)]   # (H = W, 2C)
SECTIONS = ("bf16", "f32", "b2b-f32", "b4-f32", "b3-f32", "b4-bf16", "b3-bf16")


KEY = "constexpr int DRAIN_STAGES = "
VARIANTS = {"every 16 stages": 16, "none": 1 << 20}
TF32_KEY = "constexpr int TF32_DRAIN_STAGES = "
TF32_VARIANTS = {"every stage": 1, "every 2 stages": 2, "every 4 stages": 4, "none": 1 << 20}
CONV2_KEY = "constexpr int TF32_CONV2_DRAIN_STAGES = "
CONV2_VARIANTS = {"every stage": 1, "every 2 stages": 2, "none": 1 << 20}


def variant_libraries(key, variants, source):
    """{label: library} of csrc/<source>.cu built with each of `variants`'
    values of the constant `key` of csrc/tma_conv.cuh, all nvcc at once."""
    out = os.path.join(ROOT, "build", "tma_conv_variants", source, key.split()[2])
    shutil.rmtree(out, ignore_errors=True)
    libs, procs = {}, {}
    for label, period in variants.items():
        d = os.path.join(out, label.replace(" ", "_"))
        shutil.copytree(build.CSRC, d)
        header = os.path.join(d, "tma_conv.cuh")
        src = open(header).read()
        start = src.index(key) + len(key)
        src = src[:start] + str(period) + src[src.index(";", start):]
        open(header, "w").write(src)
        so = os.path.join(d, f"lib{source}.so")
        procs[label] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, os.path.join(d, f"{source}.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    for label, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {label} variant")
        libs[label] = ctypes.CDLL(so)
    return libs


def rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def conv2_libraries(key, variants):
    """variant_libraries of csrc/alignnet_conv2.cu, its entries typed."""
    libs = variant_libraries(key, variants, "alignnet_conv2")
    for lib in libs.values():
        lib.ogi_alignnet_conv2.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.ogi_samm_conv_tiles.argtypes = [ctypes.c_int] * 3
    return libs


def conv2_run(lib, label, z, k, zr, wr, y2, part):
    """A B2b run of the library `lib` (z's dtype) into y2 and part."""
    b, c, h, w = z.shape
    tiles = torch.empty(b, lib.ogi_samm_conv_tiles(h, w, c), 2, c, device="cuda")

    def run():
        err = lib.ogi_alignnet_conv2(
            z.data_ptr(), k.data_ptr(), zr.data_ptr(), wr.data_ptr(), y2.data_ptr(),
            tiles.data_ptr(), part.data_ptr(), b, h, w, c, int(z.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"B2b drain {label}: error {err}")
        return y2, part
    return run


def shipped_constant(key):
    shipped = open(os.path.join(build.CSRC, "tma_conv.cuh")).read()
    return shipped[shipped.index(key) + len(key):].split(";")[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help=f"comma-separated, of {', '.join(SECTIONS)}")
    sections = ap.parse_args().sections.split(",")
    if not set(sections) <= set(SECTIONS):
        ap.error(f"unknown section in {sections}")
    if not torch.cuda.is_available():
        print("prof_tma_conv: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    if "bf16" in sections:
        bf16_drain(g)
    if "f32" in sections:
        tf32_libs = variant_libraries(TF32_KEY, TF32_VARIANTS, "samm_conv")
        for lib in tf32_libs.values():
            lib.ogi_conv3x3_act.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        print(f"float32 mode: shipped drain period {shipped_constant(TF32_KEY)} stages", flush=True)
        for h, c in SCALES:
            tf32_drain(h, c, tf32_libs, g)
    if "b2b-f32" in sections:
        libs = conv2_libraries(CONV2_KEY, CONV2_VARIANTS)
        print(f"float32 B2b: shipped drain period {shipped_constant(CONV2_KEY)} stages", flush=True)
        for h, c in SCALES:
            b2b_f32_drain(h, c, libs, g)
    if "b4-f32" in sections:
        b4(torch.float32)
    if "b3-f32" in sections:
        b3(torch.float32)
    if "b4-bf16" in sections:
        b4(torch.bfloat16)
    if "b3-bf16" in sections:
        b3(torch.bfloat16)
    return 0


def bf16_drain(g):
    """The bfloat16 B2b drain variants and bfloat16 B2a at each SAMM scale."""
    libs = conv2_libraries(KEY, VARIANTS)
    period = shipped_constant(KEY)
    for h, c in SCALES:
        z = torch.randn(1, c, h, h, device="cuda", generator=g).bfloat16()
        k = (torch.randn(c, c, 3, 3, device="cuda", generator=g) / (9 * c) ** 0.5).bfloat16()
        y2_ref, part_ref = alignnet.alignnet_conv2_kernel_reference(z, k)
        zr, wr = samm_conv.tma_scratch(z, k)
        runs = {f"shipped (drain period {period})": lambda: alignnet.alignnet_conv2(z, k)}
        for label, lib in libs.items():
            runs[f"drain {label}"] = conv2_run(lib, label, z, k, zr, wr, torch.empty_like(y2_ref),
                                               torch.empty_like(part_ref))
        times = {}
        for label, fn in runs.items():
            yy, pp = fn()
            torch.cuda.synchronize()
            bias = float(((pp[:, 1] - part_ref[:, 1]) / part_ref[:, 1]).mean())
            print(f"{h}px {c}->{c} B2b {label}: y2 {rel(yy, y2_ref):.3e}, sum y2 "
                  f"{rel(pp[:, 0], part_ref[:, 0]):.3e}, sum y2^2 {rel(pp[:, 1], part_ref[:, 1]):.3e}"
                  f" of max|ref|; mean signed error of sum y2^2 {bias:.3e}", flush=True)
        for label, fn in [*runs.items(), *reversed(runs.items())]:
            times.setdefault(label, []).append(time_ms(fn, iters=10))
        b5 = time_ms(lambda: samm_conv.conv3x3_act(z, k, None, "none"), iters=10)
        print(f"{h}px {c}->{c} ms (L2 flushed, two readings in turns): "
              + ", ".join(f"B2b {label} {t[0]:.4f} / {t[1]:.4f}" for label, t in times.items())
              + f", B5 (bfloat16 out) {b5:.4f}", flush=True)
        b2a(h, c, k, g)


def b2a(h, c2, k1, g):
    """bfloat16 B2a at (h, 2C = c2) with the weights k1: its error against
    its kernel's plain version, and the times of it, of its x1 repack alone
    and of cuDNN's conv + PReLU on the same x1."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import entry
    c = c2 // 2
    s = torch.randn(1, c, h, h, device="cuda", generator=g).bfloat16()
    t = (2.0 * torch.randn(1, c, h, h, device="cuda", generator=g) + 0.3).bfloat16()
    coeffs = alignnet._alignnet_coeffs(s.float(), t.float(),
                                       1.0 + 0.1 * torch.randn(c2, device="cuda", generator=g),
                                       0.1 * torch.randn(c2, device="cuda", generator=g),
                                       True, 1e-5)[0]
    alpha = (0.25 + 0.05 * torch.randn(c2, device="cuda", generator=g)).bfloat16().float()
    z = alignnet.alignnet_conv1(s, t, coeffs, k1, alpha)
    ref = alignnet.alignnet_conv1_kernel_reference(s, t, coeffs, k1, alpha)
    x1 = alignnet.alignnet_x1(s, t, coeffs)
    xr, wr = samm_conv.tma_scratch(s, k1)
    repack = entry("alignnet_conv1", "ogi_tma_repack_x1", 6, 5)
    stream = torch.cuda.current_stream().cuda_stream
    ms = {"B2a": time_ms(lambda: alignnet.alignnet_conv1(s, t, coeffs, k1, alpha), iters=10),
          "x1 repack": time_ms(lambda: repack(s.data_ptr(), t.data_ptr(), coeffs.data_ptr(),
                                              k1.data_ptr(), xr.data_ptr(), wr.data_ptr(), 1, c,
                                              h, h, xr.shape[3], stream), iters=10),
          "cudnn conv + prelu": time_ms(lambda: F.prelu(F.conv2d(x1, k1, padding=1),
                                                        alpha.bfloat16()), iters=10)}
    print(f"{h}px {c2}->{c2} B2a bfloat16: max|err| {rel(z, ref):.3e} of max|ref|; ms (L2 "
          "flushed): " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)


def tf32_drain(h, c, libs, g):
    """float32 B5 (act none) at (h, c -> c) through each drain variant in
    `libs`: error on the cancelling and on zero-mean inputs, and time (two
    readings in turns); the float32 repack alone; cuDNN's float32 conv;
    float32 B2a and its x1 repack alone."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import entry
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_inputs import tf32_cancel_inputs
    cases = {"tf32_cancel": [torch.from_numpy(v).cuda() for v in
                             tf32_cancel_inputs(1, c, c, h, h, seed=h + c)],
             "zero-mean": [torch.randn(1, c, h, h, device="cuda", generator=g),
                           torch.randn(c, c, 3, 3, device="cuda", generator=g) / (9 * c) ** 0.5]}
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for case, (x, k) in cases.items():
        ref = samm_conv.conv3x3_act_kernel_reference(x, k, None, "none")
        xr, wr = samm_conv.tma_scratch(x, k)
        errs = []
        for label, lib in libs.items():
            out = torch.empty_like(ref)

            def run(lib=lib, out=out, label=label):
                err = lib.ogi_conv3x3_act(x.data_ptr(), k.data_ptr(), xr.data_ptr(), wr.data_ptr(),
                                          None, out.data_ptr(), 1, h, h, c, c, 0, stream)
                if err != 0:
                    raise RuntimeError(f"float32 B5 drain {label}: error {err}")
                return out
            got = run()
            torch.cuda.synchronize()
            errs.append(f"{label} {rel(got, ref):.3e}")
            if case == "zero-mean":
                for _ in range(2):
                    times.setdefault(label, []).append(time_ms(run, iters=10))
        print(f"{h}px {c}->{c} float32 B5 max|err| / max|ref| on {case}: " + ", ".join(errs),
              flush=True)
    x, k = cases["zero-mean"]
    xr, wr = samm_conv.tma_scratch(x, k)
    repack = entry("samm_conv", "ogi_tma_repack_tf32", 4, 6)
    ms = {"repack (float32)": time_ms(lambda: repack(
        x.data_ptr(), k.data_ptr(), xr.data_ptr(), wr.data_ptr(), 1, c, h, h, c,
        xr.shape[3] // 2, stream), iters=10),
        "cudnn conv (float32, TF32 off)": time_ms(lambda: F.conv2d(x, k, padding=1), iters=10)}
    print(f"{h}px {c}->{c} float32 ms (L2 flushed): "
          + ", ".join(f"B5 drain {label} {t[0]:.4f} / {t[1]:.4f}" for label, t in times.items())
          + ", " + ", ".join(f"{key} {v:.4f}" for key, v in ms.items()), flush=True)
    c1 = c // 2
    s = torch.randn(1, c1, h, h, device="cuda", generator=g)
    t = 2.0 * torch.randn(1, c1, h, h, device="cuda", generator=g) + 0.3
    coeffs = alignnet._alignnet_coeffs(s, t, 1.0 + 0.1 * torch.randn(c, device="cuda", generator=g),
                                       0.1 * torch.randn(c, device="cuda", generator=g),
                                       True, 1e-5)[0]
    alpha = 0.25 + 0.05 * torch.randn(c, device="cuda", generator=g)
    z = alignnet.alignnet_conv1(s, t, coeffs, k, alpha)
    ref = alignnet.alignnet_conv1_kernel_reference(s, t, coeffs, k, alpha)
    xr, wr = samm_conv.tma_scratch(s, k)
    repack_x1 = entry("alignnet_conv1", "ogi_tma_repack_x1_tf32", 6, 5)
    ms = {"B2a": time_ms(lambda: alignnet.alignnet_conv1(s, t, coeffs, k, alpha), iters=10),
          "x1 repack (float32)": time_ms(lambda: repack_x1(
              s.data_ptr(), t.data_ptr(), coeffs.data_ptr(), k.data_ptr(), xr.data_ptr(),
              wr.data_ptr(), 1, c1, h, h, xr.shape[3] // 2, stream), iters=10)}
    print(f"{h}px {c}->{c} B2a float32: max|err| {rel(z, ref):.3e} of max|ref|; ms (L2 flushed): "
          + ", ".join(f"{key} {v:.4f}" for key, v in ms.items()), flush=True)


def b2b_f32_drain(h, c, libs, g):
    """float32 B2b at (h, c -> c) through each drain variant in `libs`: y2's
    and both moments' error on zero-mean and on cancelling inputs, the mean
    signed error of sum y2^2, and the time (two readings in turns, zero-mean
    inputs); the shipped wrapper, the float32 repack alone and cuDNN's
    float32 conv + moments beside it."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import entry
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_inputs import tf32_cancel_inputs
    cases = {"zero-mean": [torch.randn(1, c, h, h, device="cuda", generator=g),
                           torch.randn(c, c, 3, 3, device="cuda", generator=g) / (9 * c) ** 0.5],
             "tf32_cancel": [torch.from_numpy(v).cuda() for v in
                             tf32_cancel_inputs(1, c, c, h, h, seed=h + c)]}
    runs = {}
    for case, (z, k) in cases.items():
        y2_ref, part_ref = alignnet.alignnet_conv2_kernel_reference(z, k)
        zr, wr = samm_conv.tma_scratch(z, k)
        errs = []
        for label, lib in libs.items():
            run = conv2_run(lib, label, z, k, zr, wr, torch.empty_like(y2_ref),
                            torch.empty_like(part_ref))
            y2, part = run()
            torch.cuda.synchronize()
            bias = float(((part[:, 1] - part_ref[:, 1]) / part_ref[:, 1]).mean())
            errs.append(f"{label}: y2 {rel(y2, y2_ref):.3e}, sum y2 "
                        f"{rel(part[:, 0], part_ref[:, 0]):.3e}, sum y2^2 "
                        f"{rel(part[:, 1], part_ref[:, 1]):.3e} (mean signed {bias:.3e})")
            if case == "zero-mean":
                runs[label] = run
        print(f"{h}px {c}->{c} float32 B2b max|err| / max|ref| on {case}: " + "; ".join(errs),
              flush=True)
    z, k = cases["zero-mean"]
    runs["shipped"] = lambda: alignnet.alignnet_conv2(z, k)
    times = {}
    for label, fn in [*runs.items(), *reversed(runs.items())]:
        times.setdefault(label, []).append(time_ms(fn, iters=10))
    zr, wr = samm_conv.tma_scratch(z, k)
    repack = entry("samm_conv", "ogi_tma_repack_tf32", 4, 6)
    stream = torch.cuda.current_stream().cuda_stream
    ms = {"repack (float32)": time_ms(lambda: repack(
        z.data_ptr(), k.data_ptr(), zr.data_ptr(), wr.data_ptr(), 1, c, h, h, c,
        zr.shape[3] // 2, stream), iters=10)}
    ms["cudnn conv + moments (float32, TF32 off)"] = time_ms(
        lambda: alignnet.alignnet_conv2_reference(z, k), iters=10)
    print(f"{h}px {c}->{c} float32 B2b ms (L2 flushed, two readings in turns): "
          + ", ".join(f"{label} {t[0]:.4f} / {t[1]:.4f}" for label, t in times.items())
          + ", " + ", ".join(f"{key} {v:.4f}" for key, v in ms.items()), flush=True)


def b4(dtype):
    """B4 in `dtype` at both packed stages (b = 1): the call and its
    launches alone (chip_smoke.stage_step_ms), beside the bounds of its
    convs."""
    from chip_smoke import PACKED_STAGES, conv_flops, packed_operands, stage_step_ms, tc_bound_ms
    from ood_gan_inversion_tpu_torch.ops.packed_conv import fused_packed_stage
    itemsize, what = (4, "float32 B4, 3xTF32") if dtype == torch.float32 else (2, "bfloat16 B4")
    total = {}
    for h, c1, cmid in PACKED_STAGES:
        a = packed_operands(1, h, c1, cmid, seed=h + 1)
        for k in ("x", "skip", "k1", "k2", "k3sr", "k4"):
            a[k] = a[k].to(dtype)
        args = tuple(a.values())
        call = time_ms(lambda: fused_packed_stage(*args), iters=10)
        steps = stage_step_ms(args)
        (d1, u1), (d2, u2) = conv_flops(1, h, a["k1"]), conv_flops(1, h, a["k2"])
        dense = tc_bound_ms(d1 + d2, 0, itemsize)[0]
        useful = tc_bound_ms(u1 + u2, 0, itemsize)[0]
        conv_ms = steps["conv1"] + steps["conv2"]
        print(f"{2 * h}px stage ({h}x{h}, {c1}->{4 * cmid}->{4 * cmid}) {what}: call "
              f"{call:.4f} ms; alone " + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
              + f"; convs {conv_ms:.4f} ms against their dense bound {dense:.4f} "
              f"({dense / conv_ms:.0%}) and useful {useful:.4f} ({useful / conv_ms:.0%})",
              flush=True)
        for k, v in (("call", call), *steps.items(), ("dense bound", dense)):
            total[k] = total.get(k, 0.0) + v
    print(f"{what} per 1024px image (2 stages, b = 1): "
          + ", ".join(f"{k} {v:.4f}" for k, v in total.items()), flush=True)


def b3(dtype):
    """B3 in `dtype` at both convs of both packed stages (b = 1): the call
    and its two launches alone (chip_smoke.conv_step_ms), beside the conv's
    bounds."""
    from chip_smoke import (PACKED_STAGES, conv_flops, conv_step_ms, packed_operands,
                            tc_bound_ms)
    from ood_gan_inversion_tpu_torch.ops.packed_conv import (fused_conv3x3_act,
                                                             packed_conv3x3_act_reference)
    itemsize, what = (4, "float32 B3, 3xTF32") if dtype == torch.float32 else (2, "bfloat16 B3")
    total = {}
    for h, c1, cmid in PACKED_STAGES:
        a = packed_operands(1, h, c1, cmid, seed=h + 1)
        for k in ("x", "k1", "k2"):
            a[k] = a[k].to(dtype)
        conv1 = tuple(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1"))
        z = packed_conv3x3_act_reference(*conv1)
        for name, args in (("conv1", conv1), ("conv2", (z, a["n2"], a["k2"], a["s2"], a["d2"],
                                                      a["b2"]))):
            k = args[2]
            call = time_ms(lambda: fused_conv3x3_act(*args), iters=10)
            steps = conv_step_ms(args)
            dense, useful = (tc_bound_ms(f, 0, itemsize)[0] for f in conv_flops(1, h, k))
            print(f"{2 * h}px stage {name} ({h}x{h}, {k.shape[2]}->{k.shape[3]}) {what}: "
                  f"call {call:.4f} ms; alone repack {steps['repack']:.4f}, conv "
                  f"{steps['conv']:.4f}; the conv against its dense bound {dense:.4f} "
                  f"({dense / steps['conv']:.0%}) and useful {useful:.4f} "
                  f"({useful / steps['conv']:.0%})", flush=True)
            for key, v in (("call", call), *steps.items(), ("dense bound", dense)):
                total[key] = total.get(key, 0.0) + v
    print(f"{what} per 1024px image (4 calls, b = 1): "
          + ", ".join(f"{k} {v:.4f}" for k, v in total.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
