#!/usr/bin/env python3
"""What B2b's drain buys, and bfloat16 B2a on the TMA kernel, on a CUDA
card: python3 tools/prof_tma_conv.py

The bfloat16 path of B2b (csrc/tma_conv.cuh, `ogi_alignnet_conv2_tma`)
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
"""

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


KEY = "constexpr int DRAIN_STAGES = "
VARIANTS = {"every 16 stages": 16, "none": 1 << 20}


def variant_libraries():
    """{label: library} of csrc/alignnet_conv2.cu built with each of
    VARIANTS' drain periods."""
    out = os.path.join(ROOT, "build", "tma_conv_variants")
    shutil.rmtree(out, ignore_errors=True)
    libs, procs = {}, {}
    for label, period in VARIANTS.items():
        d = os.path.join(out, label.replace(" ", "_"))
        shutil.copytree(build.CSRC, d)
        header = os.path.join(d, "tma_conv.cuh")
        src = open(header).read()
        start = src.index(KEY) + len(KEY)
        src = src[:start] + str(period) + src[src.index(";", start):]
        open(header, "w").write(src)
        so = os.path.join(d, "libalignnet_conv2.so")
        procs[label] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, os.path.join(d, "alignnet_conv2.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    for label, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {label} variant")
        lib = ctypes.CDLL(so)
        lib.ogi_alignnet_conv2_tma.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.ogi_samm_conv_tiles.argtypes = [ctypes.c_int] * 3
        libs[label] = lib
    return libs


def rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def main():
    if not torch.cuda.is_available():
        print("prof_tma_conv: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = variant_libraries()
    shipped = open(os.path.join(build.CSRC, "tma_conv.cuh")).read()
    period = shipped[shipped.index(KEY) + len(KEY):].split(";")[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    for h, c in SCALES:
        z = torch.randn(1, c, h, h, device="cuda", generator=g).bfloat16()
        k = (torch.randn(c, c, 3, 3, device="cuda", generator=g) / (9 * c) ** 0.5).bfloat16()
        y2_ref, part_ref = alignnet.alignnet_conv2_kernel_reference(z, k)
        zr, wr = samm_conv.tma_scratch(z, k)
        runs = {f"shipped (drain period {period})": lambda: alignnet.alignnet_conv2(z, k)}
        for label, lib in libs.items():
            y2 = torch.empty_like(y2_ref)
            tiles = torch.empty(1, lib.ogi_samm_conv_tiles(h, h, c), 2, c, device="cuda")
            part = torch.empty_like(part_ref)

            def run(lib=lib, y2=y2, tiles=tiles, part=part, label=label):
                err = lib.ogi_alignnet_conv2_tma(
                    z.data_ptr(), k.data_ptr(), zr.data_ptr(), wr.data_ptr(), y2.data_ptr(),
                    tiles.data_ptr(), part.data_ptr(), 1, h, h, c,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"B2b drain {label}: error {err}")
                return y2, part
            runs[f"drain {label}"] = run
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
    return 0


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


if __name__ == "__main__":
    sys.exit(main())
