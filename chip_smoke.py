#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

1. Builds every hand-written kernel of the port from `csrc/` with nvcc, one
   process per source, all at once.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (plus border-pinned flows, ragged tiles
   and bfloat16: B1's bit for bit; B5's, B2a's and B2b's through the TMA
   kernel of csrc/tma_conv.cuh, one launch of it per call, its repack pass
   (B2a's builds x1) and its host-side tensor-map encoding timed apart;
   B4's two convs in both dtypes through the same kernel, two launches of
   it per call, its launches timed apart; B3 in both dtypes through it,
   one per call, its repack launch timed apart; bfloat16 against the
   kernel's plain version on the same operands), and
   times the kernel, the plain version and the closest PyTorch library
   call with CUDA events.
3. Drives the main path -- E4E inversion at 1024px with the IR-SE-50
   encoder, cycle_align 2, warp_scale 0.08, ModSize 256, float32, seeded
   random weights -- through `InversionEngine.invert`, the batched
   `invert_batch_perkey` and `invert_batch_perkey_split`, checks the
   outputs, the kernel launch counts and per-seed determinism across batch
   slots, and times it. Then drives the same engine with the phase-packed
   >=512px tail, plain and through each packed kernel ("pair": B3,
   "stage": B4), each path with the launch counts set to 0 just before it
   and read just after, and checks it against the unpacked engine. Then
   drives the engine with AlignNet's body0 through the fused kernels
   ("fused": B2a, B2b) and through the conv3x3 + activation kernel
   ("literal" + samm_conv_kernel: B5), checks each against the default
   engine. Then the bfloat16 serving configuration on the same weights:
   the bfloat16 engine against the float32 one, and its kernel paths (B4,
   B2a + B2b, B5 in bfloat16) against the bfloat16 default; the batched
   decode at b = 1, 2, 4, 8 in both dtypes, slot by slot against lone
   requests, with its ms/img curve; the bfloat16 engine behind
   `BatchingServer` (in process and over HTTP), every reply against the
   direct per-seed inversion, then requests/s and reply latency at 1, 4
   and 8 clients. Then times every configuration in interleaved rounds,
   the float32 engine with samm_conv_bf16 (body0's convs on cuDNN in
   bfloat16) among them.
   Then holds the slice on the card against the same slice on the CPU at a
   small width, unpacked, with the whole-stage kernel, in both body0 modes
   and in bfloat16. Then runs the halo probe, the box-sum kernel's own
   path, against its oracle. Before the main path, runs every kernel's
   autograd Function with inputs that require grad: its output must come
   from the Function and equal the kernel's, its gradients those of the
   plain version.
   Before the inversion paths, drives the training step of every shipped
   options/train/*.yml -- E4E, ReStyle (enc_cycle 5) and FeatureStyle
   (cycle_align 3) -- at full width (1024px, b = 2, float32, seeded
   weights and batch) through OODFaceGANModel.train_step, step 0 (R1 and
   the path regularizer, B1 differentiated twice through its twin) and
   two fused steps at ModSize 256, with B1's launches per step checked,
   frozen parameters held bit for bit, the step times and peak memory
   printed; then steps at 256px on the card against the CPU: E4E's, each
   family's step 0, and an E4E step at stage WTraining with Ranger and the
   cosine-restart schedule. Then drives the training entry point:
   `train.train_pipeline` (what `python -m
   ood_gan_inversion_tpu_torch.run_train` runs) on
   options/train/E4E_Face.yml at full width over synthetic 1024px PNGs,
   4 iterations with validation (PSNR, SSIM, LPIPS) and a checkpoint,
   --auto_resume to 6, and 8 iterations at ModSize 256; checks the losses,
   B1's launches against the curriculum, the validation metrics against
   direct calls, the checkpoints, the resumed iteration and the frozen
   parameters, and prints ms per iteration, data_time, validation ms per
   image and checkpoint seconds; then `train.train_pipeline` on
   options/train/ReStyle_Face.yml at ModSize 256 for 2 iterations, a
   validation of 1 image and a save, its ms/iteration beside the bare
   step's. Then drives this slice's main path, the
   evaluation entry point: `test.test_pipeline` (what `python -m
   ood_gan_inversion_tpu_torch.run_test` runs) on each shipped
   options/test/*.yml -- E4E, ReStyle (enc_cycle 5) and FeatureStyle
   (cycle_align 3) at 1024px over synthetic PNGs, with PSNR, SSIM, LPIPS
   and identity; checks B1's launches (8, 8 and 12 per image), the
   metrics against direct calls and the dumps, prints ms per image of the
   forward and of each metric, and holds InceptionV3FID's features of the
   outputs and inputs on the card against the CPU, with their FID. Later,
   beside the small E4E slice, holds the ReStyle and FeatureStyle
   forwards on the card against the CPU at a small width. Then the options
   and modules no shipped config uses (phase_inventory): the engine at
   1024px with the SAMM bottleneck (`mod_btn: style_bottleneck_IR`), with
   it and `modulation_type: ADD` in float32 and bfloat16, and bfloat16
   with the float32 SAMM island, each timed, with B1's 8 launches per
   forward, and held against the CPU at 256px (in bfloat16 beside each
   device's own move under a 1e-6 nudge of the input); E4E_Face.yml's train step
   with the bottleneck (step 0 and a fused step, B1 4 and 8); and one
   call each of GPENGenerator and GCFSRGenerator at 1024px, pSp's and the
   single-W encoder, ResNetArcFace, deform_conv2d and LPIPS_Loss against
   the same call on the CPU, each timed.
   Then the port on several devices, on this one card: E4E_Face.yml's
   train step at full width (b = 2, step 0 and a fused step) in one
   process, under torchrun on NCCL at world size 1 (bit for bit the one
   process) and on two gloo ranks sharing the card (within the
   card-against-CPU train bounds, replicas bit for bit), those ranks then
   running `train_pipeline` (only rank 0 writes, the replicas agree); the data-sharded inversions on meshes of 2 and 4 slots on the
   card, bit for bit the unsharded calls, and the bfloat16 server behind
   a mesh; the H-banded `invert_spatial` against `invert`: the default
   engine at min_h 512, 256 and 128 (the last through the 256px SAMM
   stage, its banded input gathered), and the packed tail through B3
   and B4 on bands in float32 and bfloat16, with each kernel's launches
   per band. Beside the training phases, E4E_Face.yml's full-width train
   step banded over 2 slots (min_h 512) against the unbanded step, both
   timed with their peak memory, and a micro decode banded over the
   slots ["cuda:0", "cpu"] whose bands' gradients must reach the
   parameters on the card. Then the bfloat16-operand SAMM options
   (samm_conv_bf16, samm_warp_bf16 "fit" and "all", samm_gather_bf16,
   the last through B1's third instantiation) on the 1024px float32
   engine, and on the card against the CPU at a small width. `python3
   chip_smoke.py --dp-worker ...` is the process those phases start
   through torchrun.
4. Prints the card's name and power limit, which of cv2, PIL and yaml are
   installed, one JSON line describing the kernels (B1's `launches` are
   the test runs', with the train steps', the training pipeline's and
   phase_inventory's under their own keys; every kernel with its
   bfloat16 bound and bfloat16 library call), and as the last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no last
line. It needs CUDA and refuses to run on the CPU.
"""

import contextlib
import copy
import ctypes
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32
# (non-tensor-core), TF32 and bf16 tensor-core rates. A card run below its
# 700 W limit is slower.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
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
# cuDNN); bfloat16 operands within 2^-7 of max|ref| of the kernel's plain
# version on the same operands (`*_kernel_reference`: float32 sums, one
# rounding; a value near a rounding boundary may round the other way, one
# bfloat16 step, at most 2^-7 of max|ref|)
SAMM_TOL, SAMM_TOL_BF16 = 1e-4, 2.0 ** -7
# the body0 kernel paths against the algebraic engine: SAMM moves the
# flows, so a float32 difference in body0 moves sample positions
BODY0_RTOL = 1e-3
# bfloat16 against float32 on the same weights, image and seed, and one
# bfloat16 path against another: JAX's bound for its bfloat16 island
# (tests/test_arch_e4e.py), image (and gen_image) within 2% of the
# reference's range, mask within 0.02, latents within 2% of theirs. Against
# the float32 engine the script holds what JAX's test holds, image and
# mask, and reports gen_image against the same bound (at 1024px with seeded
# weights it reaches it: PERF.md, the drift grows at the 256px SAMM block);
# a bfloat16 kernel path against the bfloat16 default, and the card's
# bfloat16 forward against the CPU's, are held on all three
BF16_SPAN, BF16_MASK = 0.02, 0.02
# a request's reply from a batched forward against the same request decoded
# alone: float32 within 1e-5 of max|ref| (JAX's bound for the contract,
# tests/test_infer.py), bfloat16 within 2^-7 of max|ref|. The port computes
# every batch-size-dependent op sample by sample (ops/batch_invariant.py),
# so the two are expected bit for bit; the script says which held
SLOT_RTOL, BF16_SLOT_RTOL = 1e-5, 2.0 ** -7
# warp_blend_taps_bf16 against its plain version: the same bfloat16
# roundings in the same order, so bit for bit is expected; the bound is
# far below the 2^-9 of one rounding that the kernel could skip
TAPS_BF16_RTOL = 1e-6
# forwards in one drive(): invert, one batched invert_batch_perkey of 3,
# invert_batch_perkey_split of 3 (one forward each)
DRIVE_FORWARDS = 5


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
    """Builds every source, one nvcc each, all at once; prints each kernel
    instantiation's registers and spills from ptxas, and fails on a ptxas
    C7517 ("warpgroup.wait is injected"): a wgmma hazard that the compiler
    papers over by serialising the tensor cores."""
    from ood_gan_inversion_tpu_torch import build
    t0 = time.time()
    logs = build.build_all(["warp_blend", "packed_stage", "samm_conv",
                            "alignnet_conv1", "alignnet_conv2", "halo_probe"])
    log(f"[build] nvcc sm_90a: {sorted(logs)} in {time.time() - t0:.1f} s")
    hazards = []
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                log(f"[build] {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}:   {line.strip()}")
            if "C7517" in line:
                hazards.append(f"{name}: {line.strip()}")
            elif "C7514" in line:        # wgmmas serialised: a cost, not a hazard
                log(f"[build] {name}: {line.strip()}")
    if hazards:
        raise AssertionError("ptxas injected warpgroup waits:\n" + "\n".join(hazards))


def phase_kernels():
    """warp_blend against warp_blend_reference at the main-path shapes;
    timed beside a plain copy of the same target and on a zero flow, with
    a bfloat16 target (bit for bit its plain version, which samples in
    bfloat16 arithmetic), its bound and its library call (F.grid_sample in
    bfloat16 + the blend). Then its instantiation for samm_gather_bf16
    (warp_blend_taps_bf16: a float32 target sampled in JAX's gather4bf16
    bfloat16 arithmetic) at the same shapes: within TAPS_BF16_RTOL of
    max|x| of its plain version (the same roundings; whether bit for bit is
    logged), which lies further than that from F.grid_sample of the
    rounded target in float32; timed beside its plain version and that
    library call + the blend. Returns the two kernels-line entries."""
    from ood_gan_inversion_tpu_torch.ops.grid_sample import grid_sample_bilinear
    from ood_gan_inversion_tpu_torch.ops.warp_blend import (
        warp_blend, warp_blend_reference, warp_blend_taps_bf16)
    per_image = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                 "bf16_bound_ms": 0.0, "bf16_library_ms": 0.0}
    taps = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    taps_err, taps_exact = 0.0, True
    max_err, bound_by, copy_per_image, bf16_per_image = 0.0, "bytes", 0.0, 0.0
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
            # bfloat16 target (dtype code 1): bit for bit its plain version on
            # the same target, which samples in bfloat16 arithmetic
            xb = x.to(torch.bfloat16)
            outb = warp_blend(xb, grid, alpha)
            refb = warp_blend_reference(xb, grid, alpha)
            if not torch.equal(outb, refb):
                raise AssertionError(f"warp_blend bf16 {b}x{size}x{c}: max|err| "
                                     f"{float((outb.float() - refb.float()).abs().max())}, "
                                     "not bit for bit its plain version")
            xn = x.permute(0, 3, 1, 2).contiguous()
            an = alpha.permute(0, 3, 1, 2).contiguous()

            def library():
                w = F.grid_sample(xn, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=False)
                return w * an + xn * (1.0 - an)

            xnb, anb, gridb = xn.to(torch.bfloat16), an.to(torch.bfloat16), grid.to(torch.bfloat16)

            def library_bf16():
                w = F.grid_sample(xnb, gridb, mode="bilinear",
                                  padding_mode="zeros", align_corners=False)
                return w * anb + xnb * (1.0 - anb)

            lib_err = float((library().permute(0, 2, 3, 1) - ref).abs().max())
            ms = time_ms(lambda: warp_blend(x, grid, alpha))
            lib_b = time_ms(library_bf16)
            plain = time_ms(lambda: warp_blend_reference(x, grid, alpha))
            lib = time_ms(library)
            # yardsticks: a plain copy of the target (the bound's bytes but
            # the grid's and alpha's, without the gather), and the kernel on
            # a zero flow (every tap at or next to its own pixel)
            copied = torch.empty_like(x)
            copy = time_ms(lambda: copied.copy_(x))
            zero = warp_inputs(b, size, c, 0.0, seed=size + c + b)
            zero_ms = time_ms(lambda: warp_blend(*zero))
            msb = time_ms(lambda: warp_blend(xb, grid, alpha))
            bound, bound_by = warp_bound_ms(b, size, c, 4)
            nbytes = 2 * x.numel() * 4 + 12 * b * size * size
            log(f"[kernel] warp_blend b={b} {size}px C={c} fp32: max|err| "
                f"{err:.3e} <= {tol:.3e}; bf16 bit for bit its plain version; "
                f"kernel {ms:.5f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                f"{bound / ms:.0%} of the bound), bf16 kernel {msb:.5f} ms (bound "
                f"{warp_bound_ms(b, size, c, 2)[0]:.5f}), zero flow {zero_ms:.5f} ms, "
                f"copy of the target {copy:.5f} ms (kernel / copy {ms / copy:.2f}), "
                f"plain {plain:.4f} ms, "
                f"grid_sample+blend {lib:.4f} ms (|diff| {lib_err:.1e}), "
                f"bound {bound:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB); bf16 "
                f"grid_sample+blend {lib_b:.4f} ms")
            # samm_gather_bf16's instantiation against its plain version,
            # and how far that lies from rounding only the taps
            tap_out = warp_blend_taps_bf16(x, grid, alpha)
            plain_taps = warp_blend_reference(x, grid, alpha, taps_bf16=True)
            taps_only = (grid_sample_bilinear(x.bfloat16().float(), grid) * alpha
                         + x * (1.0 - alpha))
            top = float(x.abs().max())
            err_p = float((tap_out - plain_taps).abs().max())
            err_t = float((plain_taps - taps_only).abs().max())
            if not (err_p <= TAPS_BF16_RTOL * top < err_t):
                raise AssertionError(f"warp_blend_taps_bf16 {b}x{size}x{c}: vs its plain "
                                     f"version {err_p} (<= {TAPS_BF16_RTOL * top}); the plain "
                                     f"version vs the taps alone rounded {err_t} (> that)")
            taps_err = max(taps_err, err_p)
            taps_exact = taps_exact and torch.equal(tap_out, plain_taps)
            xr = xn.to(torch.bfloat16)

            def library_taps():
                w = F.grid_sample(xr.float(), grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=False)
                return w * an + xn * (1.0 - an)

            tt = {"ms": time_ms(lambda: warp_blend_taps_bf16(x, grid, alpha)),
                  "plain_ms": time_ms(lambda: warp_blend_reference(x, grid, alpha, True)),
                  "library_ms": time_ms(library_taps), "bound_ms": bound}
            log(f"[kernel] warp_blend_taps_bf16 b={b} {size}px C={c}: max|err| {err_p:.3e} "
                f"against its plain version (<= {TAPS_BF16_RTOL * top:.3e}; bit for bit: "
                f"{torch.equal(tap_out, plain_taps)}), which lies {err_t:.3e} from the taps "
                f"alone rounded; kernel {tt['ms']:.5f} ms, plain "
                f"{tt['plain_ms']:.4f} ms, grid_sample on the rounded target+blend "
                f"{tt['library_ms']:.4f} ms, bound {bound:.5f} ms")
            if b == 1:      # the main path: 2 align cycles per scale per image
                for k, v in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bound), ("library_ms", lib),
                             ("bf16_bound_ms", warp_bound_ms(b, size, c, 2)[0]),
                             ("bf16_library_ms", lib_b)):
                    per_image[k] += 2 * v
                for k, v in tt.items():
                    taps[k] += 2 * v
                copy_per_image += 2 * copy
                bf16_per_image += 2 * msb
    log(f"[kernel] warp_blend per image (8 launches, b=1): "
        + ", ".join(f"{k} {v:.4f}" for k, v in per_image.items())
        + f", copy of the targets {copy_per_image:.4f}, bf16 targets {bf16_per_image:.4f}")
    log(f"[kernel] warp_blend_taps_bf16 per image (8 launches, b=1): "
        + ", ".join(f"{k} {v:.4f}" for k, v in taps.items())
        + f"; bit for bit its plain version at every shape: {taps_exact}")
    return [{"name": "warp_blend", "route": "cuda",
             "source": "ood_gan_inversion_tpu_torch/csrc/warp_blend.cu",
             "replaces": "ood_gan_inversion_tpu/ops/pallas_warp.py:380",
             "max_abs_err": max_err, "bound_by": bound_by, "bf16_ms": bf16_per_image,
             **per_image},
            {"name": "warp_blend_taps_bf16", "route": "cuda",
             "source": "ood_gan_inversion_tpu_torch/csrc/warp_blend.cu",
             "replaces": "ood_gan_inversion_tpu/ops/pallas_warp.py:380",
             "serves": "ood_gan_inversion_tpu/ops/grid_sample.py:169",
             "max_abs_err": taps_err, "bound_by": bound_by, **taps}]


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


def tc_bound_ms(flops, nbytes, itemsize):
    """The tensor-core bound of a convolution: float32 operands as 3xTF32
    (three TF32 products for each float32 one, 3 * flops over 495 TFLOP/s),
    bfloat16 ones as flops over 989 TFLOP/s; or bytes over HBM."""
    if itemsize == 4:
        return bound_ms(3 * flops, nbytes, TF32_FLOPS)
    return bound_ms(flops, nbytes, BF16_FLOPS)


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
    # bound_ms: the tensor-core bound; cc_bound_ms: the CUDA-core one;
    # bf16_*: the bfloat16 operands' bound and library call
    keys = ("ms", "plain_ms", "bound_ms", "cc_bound_ms", "library_ms", "bf16_ms",
            "bf16_bound_ms", "bf16_library_ms")
    per_image = {"B3": dict.fromkeys(keys, 0.0), "B4": dict.fromkeys(keys, 0.0)}
    max_err = {"B3": 0.0, "B4": 0.0}
    bound_by = {"B3": {}, "B4": {}}        # per image: bound ms by what bounds it
    gflop = {"B3": [0.0, 0.0], "B4": [0.0, 0.0]}          # dense, useful per image
    # the repack launches of B3 and B4 in each dtype
    repack_per_image = {"B3": 0.0, "B4": 0.0, "B3 bf16": 0.0, "B4 bf16": 0.0}
    # the bfloat16 kernels' launches per image: {launch: [ms, bound, cudnn]}
    bf16_steps = {"B3": {}, "B4": {}}
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
                tma_before = tma_launches("packed_stage")
                out = fused_conv3x3_act(*args)
                torch.cuda.synchronize()
                if tma_launches("packed_stage") != tma_before + 1:
                    raise AssertionError(f"B3 {stage} {name} b={b}: "
                                         f"{tma_launches('packed_stage') - tma_before} TMA kernel "
                                         "launches, expected 1")
                err, lim = check_close(f"B3 {stage} {name} b={b}", out,
                                       packed_conv3x3_act_reference(*args), PACKED_TOL)
                xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
                argsb = (xb, n4, kb, s, d, bias)
                # the plain version in float32 on the input as JAX rounds it:
                # x * s_in in bfloat16, s_in rounded first
                xs = (xb * s[:, None, None, :].to(torch.bfloat16)).float()
                tma_before = tma_launches("packed_stage")
                outb = fused_conv3x3_act(*argsb)
                torch.cuda.synchronize()
                if tma_launches("packed_stage") != tma_before + 1:
                    raise AssertionError(f"B3 {stage} {name} b={b} bf16: "
                                         f"{tma_launches('packed_stage') - tma_before} TMA kernel "
                                         "launches, expected 1")
                errb, limb = check_close(
                    f"B3 {stage} {name} b={b} bf16", outb,
                    packed_conv3x3_act_reference(xs, n4, kb.float(), torch.ones_like(s), d, bias),
                    PACKED_TOL_BF16)
                xn, n4n = x.permute(0, 3, 1, 2), n4.permute(0, 3, 1, 2)
                wk = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                lib = lambda: library_conv_act(xn, n4n, wk, s, d, bias, co // 4)
                opb = [v.to(torch.bfloat16) for v in (xn, n4n, wk, s, d, bias)]
                lib_b = lambda: library_conv_act(*opb, co // 4)
                lib_diff = float((lib().permute(0, 2, 3, 1)
                                  - packed_conv3x3_act_reference(*args)).abs().max())
                t = {"ms": time_ms(lambda: fused_conv3x3_act(*args), iters=10),
                     "plain_ms": time_ms(lambda: packed_conv3x3_act_reference(*args), iters=10),
                     "library_ms": time_ms(lib, iters=10)}
                msb = t["bf16_ms"] = time_ms(lambda: fused_conv3x3_act(*argsb), iters=10)
                t["bf16_library_ms"] = time_ms(lib_b, iters=10)
                steps = conv_step_ms(args)
                dense, useful = conv_flops(b, h, k)
                px = b * h * h
                epi = 5 * px * co
                nbytes = lambda isz: ((px * (ci + co) + 9 * ci * co) * isz
                                      + px * 16 + 4 * b * (ci + 2 * co))
                t["bound_ms"], by = tc_bound_ms(useful + epi, nbytes(4), 4)
                cc_ms, cc_by = bound_ms(useful + epi, nbytes(4), FP32_FLOPS)
                t["cc_bound_ms"] = cc_ms
                dense_ms, _ = bound_ms(dense + epi, nbytes(4), FP32_FLOPS)
                bf16_ms, bf16_by = tc_bound_ms(useful + epi, nbytes(2), 2)
                t["bf16_bound_ms"] = bf16_ms
                # bfloat16 B3's two launches alone, each beside its bound and
                # cuDNN's call (none for the repack)
                steps_b = conv_step_ms(argsb)
                cp = -(-ci // 8) * 8
                step_bounds = {       # (flops, bytes) of each bfloat16 launch
                    "repack": (0, 2 * (px * (ci + cp) + 9 * co * (ci + cp)) + 4 * b * ci),
                    "conv": (useful + epi, 2 * (px * (cp + co) + 9 * co * cp)
                             + 4 * (px * 4 + 2 * b * co))}
                step_text = []
                for step, step_ms in steps_b.items():
                    sb_ms, sb_by = tc_bound_ms(*step_bounds[step], 2)
                    lib_ms = t["bf16_library_ms"] if step == "conv" else None
                    step_text.append(f"{step} {step_ms:.4f} (bound {sb_ms:.4f}, {sb_by}; cudnn "
                                     + ("none" if lib_ms is None else f"{lib_ms:.4f}") + ")")
                    if b == 1:
                        acc = bf16_steps["B3"].setdefault(step, [0.0, 0.0, 0.0])
                        acc[0] += step_ms
                        acc[1] += sb_ms
                        acc[2] += lib_ms or 0.0
                log(f"[kernel] B3 {stage} {name} b={b} bf16 on the TMA core, its launches alone "
                    "(ms): " + ", ".join(step_text)
                    + f"; the repack {steps_b['repack'] / msb:.1%} of the call")
                log(f"[kernel] B3 {stage} {name} b={b} ({h}x{h}, {ci}->{co}): fp32 "
                    f"max|err| {err:.3e} <= {lim:.3e}, bf16 {errb:.3e} <= {limb:.3e}; "
                    f"kernel {t['ms']:.4f} ms (TMA core; its launches alone: repack "
                    f"{steps['repack']:.4f}, conv {steps['conv']:.4f}; the repack "
                    f"{steps['repack'] / t['ms']:.1%}), plain {t['plain_ms']:.4f} ms, "
                    f"cudnn+epilogue {t['library_ms']:.4f} ms (|diff| {lib_diff:.1e}); "
                    f"kernel {useful / t['ms'] / 1e9:.1f} useful TFLOP/s; bound: tensor cores "
                    f"{t['bound_ms']:.4f} ms ({by}), CUDA cores {cc_ms:.4f} ms ({cc_by}: "
                    f"{bound_parts(useful + epi, nbytes(4), FP32_FLOPS)}; "
                    f"{useful / 1e9:.2f} useful GFLOP), dense {dense_ms:.4f} ms "
                    f"({dense / 1e9:.2f} GFLOP); "
                    f"bf16 kernel {msb:.4f} ms, bound {bf16_ms:.4f} ms ({bf16_by}), "
                    f"cudnn+epilogue in bf16 {t['bf16_library_ms']:.4f} ms")
                max_err["B3"] = max(max_err["B3"], err)
                if b == 1:
                    bound_by["B3"][by] = bound_by["B3"].get(by, 0.0) + t["bound_ms"]
                    for key in keys:
                        per_image["B3"][key] += t[key]
                    repack_per_image["B3"] += steps["repack"]
                    repack_per_image["B3 bf16"] += steps_b["repack"]
                    gflop["B3"][0] += dense / 1e9
                    gflop["B3"][1] += useful / 1e9
            # ---- B4: the whole stage; float32: two TMA kernel launches
            args = tuple(a.values())
            tma_before = tma_launches("packed_stage")
            rgb, z2 = fused_packed_stage(*args)
            torch.cuda.synchronize()
            if tma_launches("packed_stage") != tma_before + 2:
                raise AssertionError(f"B4 {stage} b={b}: {tma_launches('packed_stage') - tma_before}"
                                     " TMA kernel launches, expected 2")
            rgb_ref, z2_ref = packed_stage_reference(*args)
            err = max(check_close(f"B4 {stage} b={b} z2", z2, z2_ref, PACKED_TOL)[0],
                      check_close(f"B4 {stage} b={b} rgb", rgb, rgb_ref, PACKED_TOL)[0])
            bf = {k: (v.to(torch.bfloat16) if k in ("x", "skip", "k1", "k2", "k3sr", "k4")
                      else v) for k, v in a.items()}
            argsb = tuple(bf.values())
            tma_before = tma_launches("packed_stage")
            rgbb, z2b = fused_packed_stage(*argsb)
            torch.cuda.synchronize()
            if tma_launches("packed_stage") != tma_before + 2:
                raise AssertionError(f"B4 {stage} b={b} bf16: "
                                     f"{tma_launches('packed_stage') - tma_before} TMA kernel "
                                     "launches, expected 2")
            # the plain version in float32 on conv1's input as JAX rounds it:
            # x * s1 in bfloat16, s1 rounded first
            refb = {k: v.float() for k, v in bf.items()}
            refb["x"] = (bf["x"] * a["s1"][:, None, None, :].to(torch.bfloat16)).float()
            refb["s1"] = torch.ones_like(a["s1"])
            rgbb_ref, z2b_ref = packed_stage_reference(*refb.values())
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

            lb = {k: v.to(torch.bfloat16) for k, v in a.items()}
            wb1, wb2, wb4 = (v.to(torch.bfloat16) for v in (wk1, wk2, wk4))
            xnb, sknb = xn.to(torch.bfloat16), skn.to(torch.bfloat16)
            n1b, n2b = n1n.to(torch.bfloat16), n2n.to(torch.bfloat16)

            def lib_b():
                zz = library_conv_act(xnb, n1b, wb1, lb["s1"], lb["d1"], lb["b1"], cmid)
                zz2 = library_conv_act(zz, n2b, wb2, lb["s2"], lb["d2"], lb["b2"], cmid)
                return (torch.einsum("bchw,bco->bohw", zz2, lb["k3sr"])
                        + lb["b3"][None, :, None, None] + F.conv2d(sknb, wb4, padding=1))

            # bfloat16 B4's launches alone, each beside its bound and its
            # library call (none for the repack)
            lib_steps_b = {
                "conv1": lambda: library_conv_act(xnb, n1b, wb1, lb["s1"], lb["d1"], lb["b1"],
                                                  cmid),
                "conv2": lambda: library_conv_act(zzb, n2b, wb2, lb["s2"], lb["d2"], lb["b2"],
                                                  cmid),
                "rgb": lambda: (torch.einsum("bchw,bco->bohw", zz2b, lb["k3sr"])
                                + lb["b3"][None, :, None, None] + F.conv2d(sknb, wb4, padding=1))}
            zzb = library_conv_act(xnb, n1b, wb1, lb["s1"], lb["d1"], lb["b1"], cmid)
            zz2b = library_conv_act(zzb, n2b, wb2, lb["s2"], lb["d2"], lb["b2"], cmid)
            lib_diff = float((lib().permute(0, 2, 3, 1) - rgb_ref).abs().max())
            t = {"ms": time_ms(lambda: fused_packed_stage(*args), iters=10),
                 "plain_ms": time_ms(lambda: packed_stage_reference(*args), iters=10),
                 "library_ms": time_ms(lib, iters=10)}
            steps = stage_step_ms(args)
            msb = t["bf16_ms"] = time_ms(lambda: fused_packed_stage(*argsb), iters=10)
            t["bf16_library_ms"] = time_ms(lib_b, iters=10)
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
            t["bound_ms"], by = tc_bound_ms(useful, nbytes(4), 4)
            cc_ms, cc_by = bound_ms(useful, nbytes(4), FP32_FLOPS)
            t["cc_bound_ms"] = cc_ms
            dense_ms, _ = bound_ms(dense, nbytes(4), FP32_FLOPS)
            bf16_ms, bf16_by = tc_bound_ms(useful, nbytes(2), 2)
            t["bf16_bound_ms"] = bf16_ms
            steps_b = stage_step_ms(argsb)
            cp1, cp4 = (-(-c // 8) * 8 for c in (c1, c4))
            step_bounds = {       # (flops, bytes) of each bfloat16 launch
                "repack": (0, 2 * (px * (c1 + cp1) + 9 * c4 * (c1 + cp1 + c4 + cp4)) + 4 * b * c1),
                "conv1": (u1 + 5 * px * c4, 2 * (px * (cp1 + cp4) + 9 * c4 * cp1)
                          + 4 * (px * 4 + 4 * b * c4)),
                "conv2": (u2 + u3 + 5 * px * c4, 2 * (px * (cp4 + c4) + 9 * c4 * cp4 + b * c4 * 12)
                          + 4 * (px * 4 + 3 * b * c4 + px * 12 * -(-c4 // 128))),
                "rgb": (u4 + 2 * px * 12, 4 * px * 12 * -(-c4 // 128) + 2 * (px * 15 + 9 * 36)
                        + 4 * b * 12)}
            step_text = []
            for name, step_ms in steps_b.items():
                sb_ms, sb_by = tc_bound_ms(*step_bounds[name], 2)
                lib_ms = time_ms(lib_steps_b[name], iters=10) if name in lib_steps_b else None
                step_text.append(f"{name} {step_ms:.4f} (bound {sb_ms:.4f}, {sb_by}; cudnn "
                                 + ("none" if lib_ms is None else f"{lib_ms:.4f}") + ")")
                if b == 1:
                    acc = bf16_steps["B4"].setdefault(name, [0.0, 0.0, 0.0])
                    acc[0] += step_ms
                    acc[1] += sb_ms
                    acc[2] += lib_ms or 0.0
            log(f"[kernel] B4 {stage} b={b} bf16 on the TMA core, its launches alone (ms): "
                + ", ".join(step_text) + f"; the repack {steps_b['repack'] / msb:.1%} of the call")
            log(f"[kernel] B4 {stage} b={b} ({h}x{h}, {c1}->{c4}->{c4}, rgb 12): fp32 "
                f"max|err| {err:.3e} <= {PACKED_TOL:.0e} of max|ref|, bf16 "
                f"{errb:.3e}; kernel {t['ms']:.4f} ms (TMA core; its launches alone: "
                + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
                + f"; the repack {steps['repack'] / t['ms']:.1%}), plain {t['plain_ms']:.4f} ms, "
                f"cudnn chain {t['library_ms']:.4f} ms (|diff| {lib_diff:.1e}); "
                f"kernel {useful / t['ms'] / 1e9:.1f} useful TFLOP/s; bound: tensor cores "
                f"{t['bound_ms']:.4f} ms ({by}), CUDA cores {cc_ms:.4f} ms ({cc_by}: "
                f"{bound_parts(useful, nbytes(4), FP32_FLOPS)}; {useful / 1e9:.2f} useful GFLOP), "
                f"dense {dense_ms:.4f} ms ({dense / 1e9:.2f} GFLOP); bf16 kernel "
                f"{msb:.4f} ms, bound {bf16_ms:.4f} ms ({bf16_by}), cudnn chain in bf16 "
                f"{t['bf16_library_ms']:.4f} ms")
            max_err["B4"] = max(max_err["B4"], err)
            if b == 1:
                bound_by["B4"][by] = bound_by["B4"].get(by, 0.0) + t["bound_ms"]
                for key in keys:
                    per_image["B4"][key] += t[key]
                repack_per_image["B4"] += steps["repack"]
                repack_per_image["B4 bf16"] += steps_b["repack"]
                gflop["B4"][0] += dense / 1e9
                gflop["B4"][1] += useful / 1e9
    entries = []
    for kid, name, src, line in (
            ("B3", "fused_conv3x3_act", "packed_stage.cu", 158),
            ("B4", "fused_packed_stage", "packed_stage.cu", 275)):
        pi = per_image[kid]
        text = f"; {gflop[kid][0]:.2f} dense, {gflop[kid][1]:.2f} useful GFLOP"
        tma = "ood_gan_inversion_tpu_torch/csrc/tma_conv.cuh"
        # the core of each dtype's convs, and the repack launch per image
        extra = {"f32_core": tma, "bf16_core": tma, "repack_ms": repack_per_image[kid],
                 "bf16_repack_ms": repack_per_image[f"{kid} bf16"]}
        text += (f"; f32: {pi['bound_ms'] / pi['ms']:.0%} of its bound, kernel / cudnn "
                 f"{pi['ms'] / pi['library_ms']:.2f}, the repack {repack_per_image[kid]:.4f} "
                 f"({repack_per_image[kid] / pi['ms']:.1%}); bf16: "
                 f"{pi['bf16_bound_ms'] / pi['bf16_ms']:.0%} of its bound, kernel / cudnn "
                 f"{pi['bf16_ms'] / pi['bf16_library_ms']:.2f}, the repack "
                 f"{repack_per_image[kid + ' bf16']:.4f}")
        text += ("; bf16 launches alone per image (ms, bound, cudnn): " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f} / {v[2]:.4f}" for k, v in bf16_steps[kid].items()))
        log(f"[kernel] {kid} {name} per image (b=1): "
            + ", ".join(f"{k} {v:.4f}" for k, v in pi.items()) + text)
        entries.append({"name": name, "route": "cuda",
                        "source": f"ood_gan_inversion_tpu_torch/csrc/{src}",
                        "replaces": f"ood_gan_inversion_tpu/ops/pallas_kernels.py:{line}",
                        "max_abs_err": max_err[kid],
                        "bound_by": max(bound_by[kid], key=bound_by[kid].get),
                        **extra, **pi})
    return entries


def stage_step_ms(args):
    """{step: ms} of B4's launches one at a time on the operands args, in
    x's dtype (ogi_packed_stage_step, L2 flushed): the repack, conv1 (z out
    as conv2's operand), conv2 (z2 and the toRGB partials) and the rgb
    pass, each on what the steps before it wrote."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import DTYPES, entry
    from ood_gan_inversion_tpu_torch.ops.packed_conv import stage_pointers
    x, k1 = args[0], args[4]
    b, h, w, c1 = x.shape
    ptrs, _, _, scratch = stage_pointers(*args)     # scratch lives while the steps run
    fn = entry("packed_stage", "ogi_packed_stage_step", 22, 7)
    stream = torch.cuda.current_stream().cuda_stream

    def step(i):
        err = fn(*ptrs, b, h, w, c1, k1.shape[-1], DTYPES[x.dtype], i, stream)
        if err != 0:
            raise RuntimeError(f"B4 step {i}: error {err}")
    out = {}
    for i, name in enumerate(("repack", "conv1", "conv2", "rgb")):
        out[name] = time_ms(lambda: step(i), iters=10)
    return out


def conv_step_ms(args):
    """{step: ms} of B3's two launches one at a time on the operands args,
    in x's dtype (ogi_packed_conv3x3_act_step, L2 flushed): the repack of x
    * s_in and k into the core's operands, then the conv on them."""
    from ood_gan_inversion_tpu_torch.ops.cuda_call import DTYPES, entry
    from ood_gan_inversion_tpu_torch.ops.packed_conv import _vec, conv_scratch
    x, n4, k, s, d, bias = args
    b, h, w, ci = x.shape
    co = k.shape[-1]
    s, d, bias = _vec(s, b, ci), _vec(d, b, co), _vec(bias, b, co)
    out = x.new_empty((b, h, w, co))
    xr, wr = conv_scratch(x, co)
    fn = entry("packed_stage", "ogi_packed_conv3x3_act_step", 9, 7)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in (x, n4, k, s, d, bias, out, xr, wr)]

    def step(i):
        err = fn(*ptrs, b, h, w, ci, co, DTYPES[x.dtype], i, stream)
        if err != 0:
            raise RuntimeError(f"B3 step {i}: error {err}")
    return {name: time_ms(lambda: step(i), iters=10) for i, name in enumerate(("repack", "conv"))}


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


def tma_launches(lib):
    """ogi_tma_conv_launches of csrc/<lib>.cu: its TMA conv launches."""
    from ood_gan_inversion_tpu_torch import build
    fn = build.load(lib).ogi_tma_conv_launches
    fn.restype = ctypes.c_longlong
    return fn()


def tma_repack_costs(x, k, t=None, coeffs=None):
    """(ms of the TMA conv's repack pass alone on x, k -- with t and coeffs,
    B2a's x1 mode on s = x, t; float32 operands: the pass's float32 form,
    which splits them -- host us of encoding one bfloat16 launch's two
    tensor maps): csrc/tma_conv.cuh."""
    from ood_gan_inversion_tpu_torch import build
    from ood_gan_inversion_tpu_torch.ops.cuda_call import entry
    from ood_gan_inversion_tpu_torch.ops.samm_conv import tma_scratch
    b, c, h, w = x.shape
    co = k.shape[0]
    xr, wr = tma_scratch(x, k)
    suffix, cp = ("_tf32", xr.shape[3] // 2) if x.dtype == torch.float32 else ("", xr.shape[3])
    stream = torch.cuda.current_stream().cuda_stream
    if t is None:
        repack = entry("samm_conv", "ogi_tma_repack" + suffix, 4, 6)
        ms = time_ms(lambda: repack(x.data_ptr(), k.data_ptr(), xr.data_ptr(), wr.data_ptr(), b,
                                    c, h, w, co, cp, stream), iters=10)
    else:
        repack = entry("alignnet_conv1", "ogi_tma_repack_x1" + suffix, 6, 5)
        ms = time_ms(lambda: repack(x.data_ptr(), t.data_ptr(), coeffs.data_ptr(), k.data_ptr(),
                                    xr.data_ptr(), wr.data_ptr(), b, c, h, w, cp, stream),
                     iters=10)
    if x.dtype == torch.float32:
        xr, wr = tma_scratch(x.bfloat16(), k.bfloat16())
    enc = build.load("samm_conv").ogi_tma_encode_us
    enc.restype = ctypes.c_double
    enc.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    return ms, enc(xr.data_ptr(), wr.data_ptr(), b, h, w, xr.shape[3], co, 1000)


def phase_samm_kernels():
    """B2a (alignnet_conv1), B2b (alignnet_conv2) and B5 (conv3x3_act)
    against their plain versions at AlignNet body0's launch shapes at the
    four SAMM scales of the 1024px model (b = 1, and b = 2 at 64px),
    float32 and bfloat16 operands; times and bounds; and the whole body0
    fused against the port's algebraic body0. Per image = b = 1, 2 align
    cycles per scale: B2a 8 launches, B2b 8, B5 16 (conv1 + PReLU and
    conv2 in each cycle). All three run the TMA kernel (csrc/tma_conv.cuh)
    in both dtypes: one TMA conv launch per call, each after its repack
    pass, timed alone too."""
    from ood_gan_inversion_tpu_torch.ops import alignnet as an
    from ood_gan_inversion_tpu_torch.ops.samm_conv import (conv3x3_act, conv3x3_act_kernel_reference,
                                                          conv3x3_act_reference)
    # bound_ms: the tensor-core bound; cc_bound_ms: the CUDA-core one;
    # bf16_*: the bfloat16 operands' bound and library call
    keys = ("ms", "plain_ms", "bound_ms", "cc_bound_ms", "library_ms", "bf16_ms",
            "bf16_bound_ms", "bf16_library_ms")
    ids = ("B2a", "B2b", "B5")
    per_image = {k: dict.fromkeys(keys, 0.0) for k in ids}
    max_err = dict.fromkeys(ids, 0.0)
    # the repack passes' ms per image, bfloat16 and float32
    repack_per_image = {k: {"bf16": 0.0, "f32": 0.0} for k in ids}
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
            x1_b, alpha_b = bf16(a["x1"]), bf16(a["alpha"])
            # B2a's slopes as alignnet_conv1 reads them: rounded to bfloat16
            alpha_r = alpha_b.float()
            libs_b = {   # the library calls on bfloat16 operands
                "B2a": lambda: F.prelu(F.conv2d(bf16(body0_x1(a)), k1_b, padding=1), alpha_b),
                "B2b": lambda: conv_moments(z_b, k2_b),
                "B5 conv1": lambda: F.prelu(F.conv2d(x1_b, k1_b, padding=1), alpha_b),
                "B5 conv2": lambda: F.conv2d(z_b, k2_b, padding=1)}
            # the bfloat16 operands of the TMA kernel's calls
            tma_inputs = {"B2a": (s_b, k1_b, t_b, a["coeffs"]), "B2b": (z_b, k2_b),
                          "B5 conv1": (x1_b, k1_b), "B5 conv2": (z_b, k2_b)}
            runs = {
                # id: (kernel, plain, library, bf16 kernel, the kernel's bf16
                # plain version on the same operands, flops, bytes at an
                # itemsize)
                "B2a": (lambda: an.alignnet_conv1(*conv1),
                        lambda: an.alignnet_conv1_reference(*conv1),
                        lambda: F.prelu(F.conv2d(body0_x1(a), a["k1"], padding=1), a["alpha"]),
                        lambda: an.alignnet_conv1(s_b, t_b, a["coeffs"], k1_b, a["alpha"]),
                        lambda: an.alignnet_conv1_kernel_reference(s_b, t_b, a["coeffs"], k1_b,
                                                                   alpha_r),
                        conv_flops + 6 * px * c2,
                        lambda isz: (2 * px * c + 9 * c2 * c2 + px * c2) * isz
                        + 4 * (5 * b * c + c2)),
                "B2b": (lambda: an.alignnet_conv2(z, a["k2"]),
                        lambda: an.alignnet_conv2_reference(z, a["k2"]),
                        lambda: conv_moments(z, a["k2"]),
                        lambda: an.alignnet_conv2(z_b, k2_b),
                        lambda: an.alignnet_conv2_kernel_reference(z_b, k2_b),
                        conv_flops + 3 * px * c2,
                        lambda isz: (px * c2 + 9 * c2 * c2) * isz + 4 * (px * c2 + 2 * b * c2)),
                "B5 conv1": (lambda: conv3x3_act(a["x1"], a["k1"], a["alpha"], "prelu"),
                             lambda: conv3x3_act_reference(a["x1"], a["k1"], a["alpha"], "prelu"),
                             lambda: F.prelu(F.conv2d(a["x1"], a["k1"], padding=1), a["alpha"]),
                             lambda: conv3x3_act(bf16(a["x1"]), k1_b, a["alpha"], "prelu"),
                             lambda: conv3x3_act_kernel_reference(x1_b, k1_b, a["alpha"],
                                                                  "prelu"),
                             conv_flops + 2 * px * c2,
                             lambda isz: (2 * px * c2 + 9 * c2 * c2) * isz + 4 * c2),
                "B5 conv2": (lambda: conv3x3_act(z, a["k2"], None, "none"),
                             lambda: conv3x3_act_reference(z, a["k2"], None, "none"),
                             lambda: F.conv2d(z, a["k2"], padding=1),
                             lambda: conv3x3_act(z_b, k2_b, None, "none"),
                             lambda: conv3x3_act_kernel_reference(z_b, k2_b, None, "none"),
                             conv_flops,
                             lambda isz: (2 * px * c2 + 9 * c2 * c2) * isz),
            }
            f32_inputs = {"B2a": (a["s"], a["k1"], a["t"], a["coeffs"]), "B2b": (z, a["k2"]),
                          "B5 conv1": (a["x1"], a["k1"]), "B5 conv2": (z, a["k2"])}
            for name, (kern, plain, lib, kern_b, plain_b, flops, nbytes) in runs.items():
                what = f"{name} {h}px b={b} ({c2}->{c2})"
                # float32: one TMA kernel launch
                lib_name = {"B2a": "alignnet_conv1", "B2b": "alignnet_conv2"}.get(name, "samm_conv")
                tma_before = tma_launches(lib_name)
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                if tma_launches(lib_name) != tma_before + 1:
                    raise AssertionError(f"{what} f32: {tma_launches(lib_name) - tma_before} "
                                         "TMA kernel launches, expected 1")
                err = check_close(what, first(got), first(ref), SAMM_TOL)[0]
                # B2b's moments, each row against its own max|ref|
                moments = [check_close(f"{what} moments {m}", got[1][:, m], ref[1][:, m],
                                       SAMM_TOL) for m in range(2) if name == "B2b"]
                moment_text = "".join(f", sum y{'^2' if m else ''} rel err {e / l * SAMM_TOL:.2e}"
                                      for m, (e, l) in enumerate(moments))
                # the bfloat16 run: one TMA kernel launch (tma_conv.cuh),
                # against the kernel's plain version on the same operands
                tma_before = tma_launches(lib_name)
                got_b, ref_b = kern_b(), plain_b()
                torch.cuda.synchronize()
                if tma_launches(lib_name) != tma_before + 1:
                    raise AssertionError(f"{what} bf16: {tma_launches(lib_name) - tma_before} "
                                         "TMA kernel launches")
                errb, limb = check_close(f"{what} bf16", first(got_b), first(ref_b),
                                         SAMM_TOL if name == "B2b" else SAMM_TOL_BF16)
                moments_b = [check_close(f"{what} bf16 moments {m}", got_b[1][:, m],
                                         ref_b[1][:, m], SAMM_TOL)
                             for m in range(2) if name == "B2b"]
                moment_text += "".join(f", bf16 sum y{'^2' if m else ''} rel err "
                                       f"{e / l * SAMM_TOL:.2e}" for m, (e, l) in enumerate(moments_b))
                lib_diff = float((first(lib()) - first(ref)).abs().max())
                t = {"ms": time_ms(kern, iters=10), "plain_ms": time_ms(plain, iters=10),
                     "library_ms": time_ms(lib, iters=10)}
                msb = t["bf16_ms"] = time_ms(kern_b, iters=10)
                t["bf16_library_ms"] = time_ms(libs_b[name], iters=10)
                t["bound_ms"], by = tc_bound_ms(flops, nbytes(4), 4)
                cc_ms, cc_by = bound_ms(flops, nbytes(4), FP32_FLOPS)
                t["cc_bound_ms"] = cc_ms
                bf16_ms, bf16_by = tc_bound_ms(flops, nbytes(2), 2)
                t["bf16_bound_ms"] = bf16_ms
                # the repack pass alone (B2a's builds x1), and the host cost
                # of the two tensor maps that every launch encodes
                t["bf16_repack_ms"], enc_us = tma_repack_costs(*tma_inputs[name])
                tma_text = (f" (of which the repack pass {t['bf16_repack_ms']:.4f} ms; "
                            f"tensor maps {enc_us:.2f} us of host time per launch)")
                t["repack_ms"] = tma_repack_costs(*f32_inputs[name])[0]
                f32_text = (f" (TMA core; of which the float32 repack pass "
                            f"{t['repack_ms']:.4f} ms, {t['repack_ms'] / t['ms']:.1%})")
                log(f"[kernel] {what}: fp32 max|err| {err:.3e} (<= {SAMM_TOL:.0e} of max|ref|)"
                    f"{moment_text}, "
                    f"bf16 {errb:.3e} <= {limb:.3e}; kernel {t['ms']:.4f} ms{f32_text} "
                    f"({flops / t['ms'] / 1e9:.1f} TFLOP/s, {t['bound_ms'] / t['ms']:.0%} of its "
                    f"bound), plain {t['plain_ms']:.4f} ms, "
                    f"cudnn+epilogue {t['library_ms']:.4f} ms (|diff| {lib_diff:.1e}); bound: "
                    f"tensor cores {t['bound_ms']:.4f} ms ({by}), CUDA cores {cc_ms:.4f} ms "
                    f"({cc_by}: {bound_parts(flops, nbytes(4), FP32_FLOPS)}; "
                    f"{flops / 1e9:.2f} GFLOP); bf16 kernel {msb:.4f} ms{tma_text} "
                    f"({flops / msb / 1e9:.1f} TFLOP/s, {bf16_ms / msb:.0%} of its bound), "
                    f"bound {bf16_ms:.4f} ms ({bf16_by}), "
                    f"cudnn+epilogue in bf16 {t['bf16_library_ms']:.4f} ms "
                    f"(kernel / cudnn {msb / t['bf16_library_ms']:.2f})")
                kid = name.split()[0]
                max_err[kid] = max(max_err[kid], err)
                if b == 1:      # the main path: 2 align cycles per scale per image
                    bound_by[kid][by] = bound_by[kid].get(by, 0.0) + 2 * t["bound_ms"]
                    for key in keys:
                        per_image[kid][key] += 2 * t[key]
                    repack_per_image[kid]["bf16"] += 2 * t["bf16_repack_ms"]
                    repack_per_image[kid]["f32"] += 2 * t["repack_ms"]
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
    # all three run the TMA core in both dtypes
    for kid, name, line, src in (("B2a", "alignnet_conv1", 982, "tma_conv.cuh"),
                                 ("B2b", "alignnet_conv2", 1005, "tma_conv.cuh"),
                                 ("B5", "conv3x3_act", 517, "tma_conv.cuh")):
        pi, rp = per_image[kid], repack_per_image[kid]
        log(f"[kernel] {kid} {name} per image (b=1): "
            + ", ".join(f"{k} {v:.4f}" for k, v in pi.items())
            + f"; f32: {pi['bound_ms'] / pi['ms']:.0%} of its bound, kernel / cudnn "
            f"{pi['ms'] / pi['library_ms']:.2f}, the repack pass {rp['f32']:.4f} "
            f"({rp['f32'] / pi['ms']:.1%}); bf16: {pi['bf16_bound_ms'] / pi['bf16_ms']:.0%} of "
            f"its bound, kernel / cudnn {pi['bf16_ms'] / pi['bf16_library_ms']:.2f}, the repack "
            f"pass {rp['bf16']:.4f} ({rp['bf16'] / pi['bf16_ms']:.1%})")
        entries.append({"name": name, "route": "cuda",
                        "source": f"ood_gan_inversion_tpu_torch/csrc/{src}",
                        "replaces": f"ood_gan_inversion_tpu/ops/pallas_kernels.py:{line}",
                        "max_abs_err": max_err[kid],
                        "bound_by": max(bound_by[kid], key=bound_by[kid].get),
                        "bf16_source": "ood_gan_inversion_tpu_torch/csrc/tma_conv.cuh",
                        "repack_ms": rp["f32"], "bf16_repack_ms": rp["bf16"],
                        **per_image[kid]})
    return entries


def grads_of(fn, args, cotangents):
    """(outputs, gradients of sum(out * cotangent) for every tensor
    argument) of fn on fresh leaves of args; a None cotangent drops its
    output from the loss."""
    leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) else a
              for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    used = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
    grads = torch.autograd.grad([o for o, _ in used],
                                [v for v in leaves if isinstance(v, torch.Tensor)],
                                [g for _, g in used], allow_unused=True)
    return outs, grads


def phase_gradients():
    """Every kernel wrapper with grad on and inputs that require grad, at a
    launch shape of the main path, float32: its output must come from its
    autograd Function (grad_fn), equal the kernel's output without grad bit
    for bit, and its gradients must equal the plain version's own autograd
    gradients within 1e-5 of max|ref| (the same computation; the backward's
    scatters and cuDNN sum in run-dependent order). B4's loss reads rgb
    only (z2's cotangent None), B2b's both y2 and the moments."""
    from ood_gan_inversion_tpu_torch.ops import alignnet as an
    from ood_gan_inversion_tpu_torch.ops import halo_probe, samm_conv
    from ood_gan_inversion_tpu_torch.ops import packed_conv as pc
    from ood_gan_inversion_tpu_torch.ops import warp_blend as wb
    a = packed_operands(1, 256, 128, 64, seed=5)
    s = samm_operands(1, 32, 512, seed=6)
    conv1 = (s["s"], s["t"], s["coeffs"], s["k1"], s["alpha"])
    g = torch.Generator(device="cuda").manual_seed(7)
    cases = [
        ("WarpBlend", wb.warp_blend, wb.warp_blend_reference,
         warp_inputs(1, 128, 256, WARP_SCALE, seed=7)),
        ("PackedConv3x3Act", pc.fused_conv3x3_act, pc.packed_conv3x3_act_reference,
         tuple(a[k] for k in ("x", "n1", "k1", "s1", "d1", "b1"))),
        ("PackedStage", pc.fused_packed_stage, pc.packed_stage_reference, tuple(a.values())),
        ("AlignNetConv1", an.alignnet_conv1, an.alignnet_conv1_reference, conv1),
        ("AlignNetConv2", an.alignnet_conv2, an.alignnet_conv2_reference,
         (an.alignnet_conv1_reference(*conv1), s["k2"])),
        ("Conv3x3Act", samm_conv.conv3x3_act, samm_conv.conv3x3_act_reference,
         (s["x1"], s["k1"], s["alpha"], "prelu")),
        ("Box3x3", halo_probe.box3x3, halo_probe.box3x3_reference,
         (torch.randn(32, 32, generator=g, device="cuda"),))]
    for name, fn, twin, args in cases:
        with torch.no_grad():
            direct = fn(*args)
        direct = direct if isinstance(direct, tuple) else (direct,)
        cts = [torch.randn(o.shape, generator=g, device="cuda") for o in direct]
        if name == "PackedStage":
            cts[1] = None
        outs, grads = grads_of(fn, args, cts)
        node = type(outs[0].grad_fn).__name__
        if node != name + "Backward":
            raise AssertionError(f"gradients: {name}'s output has grad_fn {node}")
        if not all(torch.equal(o, d) for o, d in zip(outs, direct)):
            raise AssertionError(f"gradients: {name}'s forward differs from the kernel's")
        _, ref = grads_of(twin, args, cts)
        rel = []
        for i, (got, want) in enumerate(zip(grads, ref)):
            if (got is None) != (want is None):
                raise AssertionError(f"gradients: {name} input {i}: None against a gradient")
            if want is not None:
                rel.append(float((got - want).abs().max()) / float(want.abs().max()))
        if not max(rel) <= 1e-5:
            raise AssertionError(f"gradients: {name} max rel err {max(rel)} > 1e-5")
        log(f"[grad] {name}: grad_fn {node}, forward == kernel, {len(rel)} gradients "
            f"within {max(rel):.2e} of max|ref| of the plain version's (<= 1e-5)")


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
    xb, ones_b = x.to(torch.bfloat16), torch.ones(1, 1, 3, 3, device="cuda", dtype=torch.bfloat16)
    t = {"ms": time_ms(lambda: box3x3(x)), "plain_ms": time_ms(lambda: box3x3_reference(x)),
         "library_ms": time_ms(oracle),
         "bf16_library_ms": time_ms(lambda: F.conv2d(xb[None, None], ones_b, padding=1))}
    t["bound_ms"], by = bound_ms(8 * x.numel(), 2 * 4 * x.numel(), FP32_FLOPS)
    t["bf16_bound_ms"] = bound_ms(8 * x.numel(), 2 * 2 * x.numel(), FP32_FLOPS)[0]
    log(f"[probe] box3x3 (32, 32): equal to its plain version, max|err| vs the oracle "
        f"{err:.3e} <= 1e-5; kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"conv2d {t['library_ms']:.4f} ms (bf16 {t['bf16_library_ms']:.4f}), bound "
        f"{t['bound_ms']:.6f} ms ({by}), bf16 {t['bf16_bound_ms']:.6f}; launches "
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
                   "alignnet_conv1", "alignnet_conv2", "conv3x3_act", "box3x3",
                   "warp_blend_taps_bf16")


def counters():
    from ood_gan_inversion_tpu_torch.ops.alignnet import alignnet_conv1, alignnet_conv2
    from ood_gan_inversion_tpu_torch.ops.halo_probe import box3x3
    from ood_gan_inversion_tpu_torch.ops.packed_conv import (
        fused_conv3x3_act, fused_packed_stage)
    from ood_gan_inversion_tpu_torch.ops.samm_conv import conv3x3_act
    from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend, warp_blend_taps_bf16
    return dict(zip(KERNEL_COUNTERS, (warp_blend, fused_conv3x3_act, fused_packed_stage,
                                      alignnet_conv1, alignnet_conv2, conv3x3_act, box3x3,
                                      warp_blend_taps_bf16)))


def expected_counts(**launches):
    """Every kernel's count: 0 except the ones given."""
    return {**dict.fromkeys(KERNEL_COUNTERS, 0), **launches}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def drive(engine, imgs):
    """The main path's requests: one `invert`, one batched
    `invert_batch_perkey` of three whose slot 2 repeats it, and the same
    three through `invert_batch_perkey_split` (DRIVE_FORWARDS forwards).
    Counts set to 0 just before, read just after. Returns (alone, batch,
    split, launches, ms of invert, ms/img of the batch)."""
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    alone = engine.invert(imgs[0], seed=7)
    ev[1].record()
    batch = engine.invert_batch_perkey([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    ev[2].record()
    split = engine.invert_batch_perkey_split([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    torch.cuda.synchronize()
    return (alone, batch, split, read_counts(), ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / 3)


def rel_err(got, ref):
    """max|got - ref| / max|ref|, in float32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max())


def slot_err(what, batched, alone, dtype):
    """A batched forward's reply against the lone request: (rel err, 0.0 if
    bit for bit, and its text). Within SLOT_RTOL in float32 and
    BF16_SLOT_RTOL in bfloat16 of max|ref|, or it raises."""
    keys = [k for k in ("image", "gen_image", "mask") if k in batched]
    err = max(0.0 if torch.equal(batched[k], alone[k]) else rel_err(batched[k], alone[k])
              for k in keys)
    if err == 0.0:
        return err, "bit for bit"
    bound = SLOT_RTOL if dtype == torch.float32 else BF16_SLOT_RTOL
    if not err <= bound:
        raise AssertionError(f"{what}: batched reply vs the lone request rel err "
                             f"{err} > {bound}")
    return err, f"rel err {err:.2e} (<= {bound:.3g})"


def check_replies(what, alone, batch, split, dtype=torch.float32):
    """Shapes, finite values, the mask in [0, 1]; the split path's slot 2
    bit for bit the lone request; the batched forward's slot 2 within
    slot_err's bound of it. Returns slot_err's (rel err, text)."""
    for name, out, n in (("invert", alone, 1), ("invert_batch_perkey", batch, 3),
                         ("invert_batch_perkey_split", split, 3)):
        if tuple(out["image"].shape) != (n, 1024, 1024, 3):
            raise AssertionError(f"{what} {name} image shape {tuple(out['image'].shape)}")
        if tuple(out["mask"].shape) != (n, 1024, 1024, 1):
            raise AssertionError(f"{what} {name} mask shape {tuple(out['mask'].shape)}")
        for k in ("image", "gen_image", "mask", "lats"):
            if out[k].dtype != dtype:
                raise AssertionError(f"{what} {name} {k} is {out[k].dtype}, not {dtype}")
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"{what} {name} {k} has non-finite values")
        m = out["mask"]
        if not (float(m.min()) >= 0.0 and float(m.max()) <= 1.0):
            raise AssertionError(f"{what} {name} mask outside [0, 1]")
        for k, s in ((1, 32), (2, 64), (3, 128), (4, 256)):
            if tuple(out["aligns"][k].shape) != (n, s, s, 3):
                raise AssertionError(f"{what} {name} align {k} shape")
    for k in ("image", "gen_image", "mask", "lats"):
        if not torch.equal(alone[k][0], split[k][2]):
            raise AssertionError(f"{what}: seed 7 gave a different {k} in split slot 2")
    if torch.equal(batch["image"][0], batch["image"][1]):
        raise AssertionError(f"{what}: different seeds and images gave one image")
    return slot_err(what, {k: batch[k][2] for k in ("image", "gen_image", "mask", "lats")},
                    {k: alone[k][0] for k in ("image", "gen_image", "mask", "lats")}, dtype)


def per_forward(**launches):
    """expected_counts of one drive(): each kernel's launches per forward
    times DRIVE_FORWARDS, B1's 8 included."""
    return expected_counts(**{k: DRIVE_FORWARDS * v
                              for k, v in {"warp_blend": 8, **launches}.items()})


def fused_body0(engine, kwargs=None, forwards=1):
    """B2a's and B2b's launches in `forwards` forwards of `engine` at
    mod_size 256, where every SAMM block runs, worked out from the options
    the engine was built with (`kwargs`) and its blocks' widths, not from
    the route the engine picked: body0 is the caller's samm_body0, else
    "fused" for a float32 engine on the card without samm_conv_bf16; a
    fused engine launches each kernel once per align cycle of every block
    with C >= alignnet.FUSED_MIN_CHANNELS (as set when it is called).
    Raises if the engine took another route."""
    from ood_gan_inversion_tpu_torch.nn.samm import SPMWarp
    from ood_gan_inversion_tpu_torch.ops import alignnet
    kwargs = kwargs or {}
    want = kwargs.get("samm_body0") or (
        "fused" if engine.dtype == torch.float32 and not kwargs.get("samm_conv_bf16")
        else "algebraic")
    if engine.samm_body0 != want:
        raise AssertionError(f"body0 took {engine.samm_body0!r}; its options ask for {want!r}")
    n = 0 if want != "fused" else forwards * sum(
        m.cycle_align for m in engine.net.modules()
        if isinstance(m, SPMWarp) and m.body.in_ch >= alignnet.FUSED_MIN_CHANNELS)
    return {"alignnet_conv1": n, "alignnet_conv2": n}


def cpu_twin(gpu, opt, params, **kwargs):
    """The CPU engine a card engine is held against: the same options and
    the same body0 route, so that the CPU runs the plain versions of the
    card's kernels."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    return InversionEngine(opt, params=params, device="cpu",
                           **{**kwargs, "samm_body0": gpu.samm_body0})


def phase_main_path():
    """The default engine (unpacked tail; body0 through B2a and B2b, the
    float32 default on the card). Returns (each kernel's launches in
    drive(), engine, images, its replies)."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    t0 = time.time()
    engine = noisy(InversionEngine(e4e_opt(), seed=SEED, device="cuda"))
    n_params = sum(p.numel() for p in engine.net.parameters())
    log(f"[main] engine: 1024px, IR-SE-50, {n_params} parameters, "
        f"built in {time.time() - t0:.1f} s")
    rs = np.random.RandomState(SEED)
    imgs = [rs.rand(1024, 1024, 3).astype(np.float32) for _ in range(3)]
    engine.invert(imgs[0], seed=7)           # warm-up: cuDNN plans, libraries
    engine.invert_batch_perkey(imgs, [0, 1, 2])
    torch.cuda.synchronize()
    alone, batch, split, launches, ms_single, ms_batch = drive(engine, imgs)
    if engine.samm_body0 != "fused":
        raise AssertionError(f"the default float32 engine took body0 {engine.samm_body0!r}")
    want = per_forward(alignnet_conv1=8, alignnet_conv2=8)
    if launches != want:
        raise AssertionError(f"default path launched {launches}, expected {want}")
    _, slot = check_replies("default", alone, batch, split)
    log(f"[main] 7 requests in 5 forwards answered; launches {launches} (warp_blend, "
        f"alignnet_conv1 and alignnet_conv2 8 per forward); split slot 2 == the lone "
        f"request: True; batched slot 2 vs the lone request: {slot}")
    log(f"[main] ms/img: invert {ms_single:.2f}, invert_batch_perkey (b=3) "
        f"{ms_batch:.2f} (CUDA events, 1024px, float32)")
    return launches, engine, imgs, (alone, batch, split)


def phase_packed_tail(engine, imgs, replies):
    """The same engine's weights with the packed tail: plain ("none"), B3
    ("pair") and B4 ("stage"). Each path's launch counts, its replies
    against the unpacked engine's (mask and lats bit-identical: the tail
    lies after every SAMM block), per-seed determinism. Returns the B3
    count of the pair path, the B4 count of the stage path, and the three
    engines by name."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.nn.stylegan2 import TAIL_KERNELS
    params = engine.net.state_dict()
    engines, launches = {}, {}
    per_image = {"none": {}, "pair": {"fused_conv3x3_act": 4},
                 "stage": {"fused_packed_stage": 2}}     # per forward
    for kern in TAIL_KERNELS:
        kwargs = {"packed_tail": True, "tail_kernel": kern}
        eng = InversionEngine(e4e_opt(), params=params, device="cuda", **kwargs)
        eng.invert(imgs[0], seed=7)          # warm-up
        torch.cuda.synchronize()
        alone, batch, split, counts, _, _ = drive(eng, imgs)
        want = per_forward(**per_image[kern], **fused_body0(eng, kwargs))
        if counts != want:
            raise AssertionError(f"packed tail {kern!r} launched {counts}, expected {want}")
        check_replies(f"packed tail {kern!r}", alone, batch, split)
        errs = {}
        for got, ref in zip((alone, batch, split), replies):
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
            "split slot 2 == the lone request: True")
        launches.update({k: counts[k] for k in per_image[kern]})
        engines[f"packed tail {kern}"] = eng
    return launches, engines


def phase_samm_body0(engine, imgs, replies):
    """The same engine's weights with AlignNet's body0 by the algebraic
    formulation in plain PyTorch ("algebraic": cuDNN's float32 convs, no
    body0 kernel; the reference here) and through the conv3x3 + activation
    kernel ("literal" + samm_conv_kernel: B5 for both body0 convs at every
    scale). Each path's launch counts and per-seed determinism; the default
    engine's replies (body0 through B2a and B2b) and the literal path's
    against the algebraic engine's (lats bit-identical: the encoder runs
    before any SAMM block; image, gen_image and mask within BODY0_RTOL of
    max|ref|). Returns B5's count from its path and the two engines by
    name."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    params = engine.net.state_dict()
    engines, launches, ref = {}, {}, None

    def against_algebraic(label, outs):
        errs = {}
        for got, r in zip(outs, ref):
            if not torch.equal(got["lats"], r["lats"]):
                raise AssertionError(f"body0 {label!r}: lats differ from the algebraic engine")
            for k in ("image", "gen_image", "mask"):
                err = float((got[k] - r[k]).abs().max() / r[k].abs().max())
                if not err <= BODY0_RTOL:
                    raise AssertionError(f"body0 {label!r} {k}: rel err {err} > {BODY0_RTOL}")
                errs[k] = max(errs.get(k, 0.0), err)
        return (f"lats bit-identical to the algebraic engine; max rel err image "
                f"{errs['image']:.2e}, gen_image {errs['gen_image']:.2e}, mask "
                f"{errs['mask']:.2e} <= {BODY0_RTOL}")

    modes = {"algebraic": ({"samm_body0": "algebraic"}, {}),
             "literal + B5": ({"samm_body0": "literal", "samm_conv_kernel": True},
                              {"conv3x3_act": 16})}
    for label, (kwargs, per_image) in modes.items():
        eng = InversionEngine(e4e_opt(), params=params, device="cuda", **kwargs)
        eng.invert(imgs[0], seed=7)          # warm-up
        torch.cuda.synchronize()
        alone, batch, split, counts, _, _ = drive(eng, imgs)
        want = per_forward(**per_image)
        if counts != want:
            raise AssertionError(f"body0 {label!r} launched {counts}, expected {want}")
        check_replies(f"body0 {label!r}", alone, batch, split)
        text = "the reference of the kernel paths"
        if ref is None:
            ref = (alone, batch, split)
            log(f"[main] body0 'fused' (the default engine): {against_algebraic('fused', replies)}")
        else:
            text = against_algebraic(label, (alone, batch, split))
        log(f"[main] body0 {label!r}: launches {counts}; {text}; split slot 2 == the lone "
            "request: True")
        launches.update({k: counts[k] for k in per_image})
        engines[f"body0 {label}"] = eng
    return launches, engines


def span_errs(got, ref):
    """bf16_compare's readings of got against ref: image, gen_image and lats
    as max|diff| over the reference's range, mask as max|diff|."""
    errs = {}
    for k in ("image", "gen_image", "lats"):
        r = ref[k].float()
        errs[k] = float((got[k].float() - r).abs().max() / (r.max() - r.min()))
    errs["mask"] = float((got["mask"].float() - ref["mask"].float()).abs().max())
    return errs


def bf16_compare(what, got, ref, held=("image", "gen_image", "mask")):
    """A bfloat16 path's replies against a reference path's on the same
    image and seed, against JAX's island bound: image, gen_image and lats
    as a share of the reference's range (under BF16_SPAN), mask as max|diff|
    (under BF16_MASK). Raises if the latents or a key in `held` miss it;
    reports the rest. Returns (errors, text)."""
    errs = span_errs(got, ref)
    beyond = [k for k, v in errs.items() if not v < (BF16_MASK if k == "mask" else BF16_SPAN)]
    if set(beyond) & {"lats", *held}:
        raise AssertionError(f"{what}: {beyond} beyond JAX's island bound "
                             f"({BF16_SPAN} of the range, mask {BF16_MASK}): {errs}")
    text = (", ".join(f"{k} {v:.4f}" for k, v in errs.items() if k != "mask")
            + f" of the range, mask max|diff| {errs['mask']:.4f}: "
            + (f"{', '.join(beyond)} BEYOND" if beyond else "within")
            + f" JAX's island bound ({BF16_SPAN}, {BF16_MASK})"
            + ("" if set(held) >= {"image", "gen_image", "mask"}
               else f", held on lats, {', '.join(held)}"))
    return errs, text


def record_b1_dtypes():
    """Wraps the SAMM blocks' warp_blend to record the dtype of every target
    it is given (the count stays the wrapper's own); returns (the list,
    a function that restores the original)."""
    from ood_gan_inversion_tpu_torch.nn import samm
    real, seen = samm.warp_blend, []

    def spy(target, grid, alpha):
        seen.append(target.dtype)
        return real(target, grid, alpha)

    samm.warp_blend = spy
    return seen, lambda: setattr(samm, "warp_blend", real)


def drift_profile(f32, bf, img):
    """max|bf16 - float32| / range of the float32 output at the encoder's
    latents, each SAMM block's output feature, and each generator stage's
    second conv and toRGB, through one forward (same weights, image and
    seed), in forward order: where the bfloat16 drift grows."""
    n = len(f32.net.generator.to_rgbs)
    profile = [("encoder", "lats"), *((f"modulation.{3 - k}", f"SAMM {32 << k}px")
                                      for k in range(4)),
               *((f"generator.convs.{2 * i + 1}", f"stage {8 << i}px") for i in range(n)),
               *((f"generator.to_rgbs.{i}", f"toRGB {8 << i}px") for i in range(n))]
    outs = {}
    for tag, eng in (("f32", f32), ("bf16", bf)):
        hooks = []
        for name, label in profile:
            def keep(mod, inp, out, label=label, tag=tag):
                o = out[0] if isinstance(out, tuple) else out
                outs.setdefault(tag, []).append((label, o.float()))
            hooks.append(eng.net.get_submodule(name).register_forward_hook(keep))
        try:
            eng.invert(img, seed=7)
        finally:
            for h in hooks:
                h.remove()
    rows = []
    for (label, a), (_, b) in zip(outs["f32"], outs["bf16"]):
        rows.append(f"{label} {float((a - b).abs().max() / (a.max() - a.min())):.4f}")
    return rows


def phase_bf16(engine, imgs, replies):
    """The bfloat16 engine on the float32 engine's weights: the main path's
    requests (B1 8 launches per forward, every target bfloat16), the split
    path's slot bit for bit the lone request, the replies against the
    float32 engine's (bf16_compare), and the drift's profile through one
    forward. Then the bfloat16 kernel paths (packed tail "stage": B4;
    "pair": B3; body0 "fused": B2a, B2b; "literal" + samm_conv_kernel:
    B5): launch
    counts, the latents bit for bit the bfloat16 default's (the mask too
    for the tail, which lies after every SAMM block), the rest compared
    with the default. Returns the engines by name."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    params = engine.net.state_dict()
    opt = e4e_opt(dtype="bfloat16")
    bf = InversionEngine(opt, params=params, device="cuda")
    bf.invert(imgs[0], seed=7)
    bf.invert_batch_perkey(imgs, [0, 1, 2])
    torch.cuda.synchronize()
    seen, restore = record_b1_dtypes()
    try:
        alone, batch, split, counts, ms_single, ms_batch = drive(bf, imgs)
    finally:
        restore()
    if counts != per_forward():
        raise AssertionError(f"bf16 default launched {counts}, expected {per_forward()}")
    if len(seen) != counts["warp_blend"] or set(seen) != {torch.bfloat16}:
        raise AssertionError(f"bf16 default: B1 targets {set(seen)} in {len(seen)} calls")
    _, slot = check_replies("bf16 default", alone, batch, split, torch.bfloat16)
    log(f"[bf16] default: launches {counts} (B1 8 per forward, {len(seen)} bfloat16 "
        f"targets); split slot 2 == the lone request: True; batched slot 2 vs the lone "
        f"request: {slot}; ms/img invert {ms_single:.2f}, invert_batch_perkey (b=3) "
        f"{ms_batch:.2f}")
    for name, got, ref in zip(("invert", "batched", "split"), (alone, batch, split), replies):
        log(f"[bf16] {name} vs the float32 engine: "
            f"{bf16_compare(f'bf16 {name} vs float32', got, ref, ('image', 'mask'))[1]}")
    log("[bf16] drift from float32 along one forward (max|diff| / range): "
        + ", ".join(drift_profile(engine, bf, imgs[0])))
    engines = {"bf16 default": bf}
    modes = {"packed tail stage": ({"packed_tail": True, "tail_kernel": "stage"},
                                   {"fused_packed_stage": 2}),
             "packed tail pair": ({"packed_tail": True, "tail_kernel": "pair"},
                                  {"fused_conv3x3_act": 4}),
             "body0 fused": ({"samm_body0": "fused"},
                             {"alignnet_conv1": 8, "alignnet_conv2": 8}),
             "body0 literal + B5": ({"samm_body0": "literal", "samm_conv_kernel": True},
                                    {"conv3x3_act": 16})}
    for label, (kwargs, per_fwd) in modes.items():
        eng = InversionEngine(opt, params=params, device="cuda", **kwargs)
        eng.invert(imgs[0], seed=7)
        torch.cuda.synchronize()
        reset_counts()
        got = eng.invert(imgs[1], seed=8)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != expected_counts(warp_blend=8, **per_fwd):
            raise AssertionError(f"bf16 {label} launched {counts}")
        ref = bf.invert(imgs[1], seed=8)
        same = ("lats", "mask") if "tail" in label else ("lats",)
        for k in same:
            if not torch.equal(got[k], ref[k]):
                raise AssertionError(f"bf16 {label}: {k} differs from the bf16 default")
        log(f"[bf16] {label}: launches {counts}; {' and '.join(same)} bit-identical to the "
            f"bf16 default; {bf16_compare(f'bf16 {label}', got, ref)[1]}")
        engines[f"bf16 {label}"] = eng
    return engines


def phase_batched(engines, imgs, sizes=(1, 2, 4, 8), reps=3):
    """The batched invert_batch_perkey at b = 1, 2, 4, 8 in float32 and
    bfloat16: every slot against the same request alone (slot_err: within
    SLOT_RTOL or BF16_SLOT_RTOL), and ms/img of each b (CUDA events, median of
    `reps` after a warm-up) beside b lone requests. Returns
    {dtype: {b: ms/img}}."""
    curve = {}
    for name, eng in engines.items():
        pool = [imgs[i % 3] for i in range(max(sizes))]
        seeds = list(range(100, 100 + max(sizes)))
        alone = [eng.invert(pool[i], seed=seeds[i]) for i in range(max(sizes))]
        ms = {}
        for b in sizes:
            out = eng.invert_batch_perkey(pool[:b], seeds[:b])
            worst = (-1.0, "")
            for i in range(b):
                one = {k: out[k][i] for k in ("image", "gen_image", "mask", "lats")}
                ref = {k: alone[i][k][0] for k in ("image", "gen_image", "mask", "lats")}
                worst = max(worst, slot_err(f"{name} b={b} slot {i}", one, ref, eng.dtype))
            times = []
            for _ in range(reps):
                a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                eng.invert_batch_perkey(pool[:b], seeds[:b])
                z.record()
                z.synchronize()
                times.append(a.elapsed_time(z) / b)
            ms[b] = float(np.median(times))
            log(f"[batched] {name} b={b}: {ms[b]:.2f} ms/img (median of {reps}, "
                f"{[round(t, 2) for t in times]}); worst slot vs its lone request: "
                f"{worst[1]}")
        lone = ms[1]
        log(f"[batched] {name} curve ms/img: {ms}; a batch of b against b lone requests "
            f"({lone:.2f} ms each): "
            + ", ".join(f"b={b} {ms[b] * b:.1f} vs {lone * b:.1f} ms" for b in sizes[1:]))
        curve[name] = ms
    return curve


def percentile(v, q):
    return float(np.percentile(np.asarray(v), q))


def phase_serving(engine, imgs):
    """The bfloat16 engine in BatchingServer (max_batch 4, max_inflight 2,
    after warmup()): 8 concurrent requests in process and 2 over HTTP on
    127.0.0.1 (one asking for float16), each reply against the engine's
    direct per-seed inversion of its image (the batched policy within
    BF16_SLOT_RTOL, the split policy bit for bit); the B1 count of the
    served forwards, set to 0 just before and read just after; then
    requests/s and reply latency at 1, 4 and 8 concurrent clients,
    max_inflight 1 and 2. Returns B1's launches in the batched run."""
    import asyncio
    import socket
    from ood_gan_inversion_tpu_torch.serve import BatchingServer
    rs = np.random.RandomState(SEED + 2)
    reqs = [(imgs[i % 3] * (0.8 + 0.2 * rs.rand())).astype(np.float32) for i in range(10)]
    direct = [engine.invert(im, seed=0) for im in reqs]
    srv = BatchingServer(engine, max_batch=4, max_wait_ms=5.0, max_inflight=2)
    t0 = time.time()
    sizes = srv.warmup()
    log(f"[serve] warmup ran batch sizes {sizes} in {time.time() - t0:.1f} s")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]

    async def http(img, dtype):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        body = img.tobytes()
        writer.write(b"POST /invert HTTP/1.1\r\nx-shape: " + json.dumps(list(img.shape)).encode()
                     + b"\r\nx-dtype: " + dtype.encode() + b"\r\ncontent-length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        await writer.drain()
        status = await reader.readline()
        if b"200" not in status:
            raise AssertionError(f"serve: HTTP status {status!r}")
        hdrs = {}
        while (h := (await reader.readline()).decode().strip()):
            k, _, v = h.partition(":")
            hdrs[k.strip().lower()] = v.strip()
        dt = np.dtype(hdrs["x-dtype"])
        shape = tuple(json.loads(hdrs["x-shape"]))
        n_img = int(np.prod(shape)) * dt.itemsize
        image = np.frombuffer(await reader.readexactly(n_img), dt).reshape(shape)
        rest = int(hdrs["content-length"]) - n_img
        mshape = tuple(json.loads(hdrs["x-mask-shape"]))
        mask = np.frombuffer(await reader.readexactly(rest), dt).reshape(mshape)
        writer.close()
        if dt != np.dtype(dtype):
            raise AssertionError(f"serve: asked for {dtype}, got {dt}")
        return image.astype(np.float32), mask.astype(np.float32)

    async def correctness(server):
        task = asyncio.create_task(server.serve_http(port=port))
        await asyncio.sleep(0.5)
        outs = await asyncio.gather(*[server.invert(im) for im in reqs[:8]],
                                    http(reqs[8], "float32"), http(reqs[9], "float16"))
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        return outs

    # the default policy (one batched forward per group), then the split
    # policy over every group size (each request decoded alone)
    split = BatchingServer(engine, max_batch=4, max_wait_ms=5.0, max_inflight=2,
                           split_below=5)
    for label, server in (("batched", srv), ("split_below 5", split)):
        reset_counts()
        outs = asyncio.run(correctness(server))
        torch.cuda.synchronize()
        counts, stats = read_counts(), server.stats
        forwards = stats["batches"] if server is srv else stats["requests"]
        if server is srv:
            launched = counts["warp_blend"]
        if counts != expected_counts(warp_blend=8 * forwards):
            raise AssertionError(f"serve {label}: launched {counts}, stats {stats}")
        if not (stats["requests"] == 10 and stats["batches"] < stats["requests"]):
            raise AssertionError(f"serve {label}: stats {stats} show no coalescing")
        worst = (-1.0, "")
        for i, ((image, mask), ref) in enumerate(zip(outs, direct)):
            want = {"image": ref["image"][0].float().cpu(), "mask": ref["mask"][0].float().cpu()}
            got = {"image": torch.from_numpy(image), "mask": torch.from_numpy(mask)}
            for k in got:
                if got[k].shape != want[k].shape or not bool(torch.isfinite(got[k]).all()):
                    raise AssertionError(f"serve {label} reply {i} {k}: {tuple(got[k].shape)}")
            if i == 9:     # the float16 reply: the float32 one rounded to float16
                want = {k: v.half().float() for k, v in want.items()}
            if server is split:
                if not all(torch.equal(got[k], want[k]) for k in got):
                    raise AssertionError(f"serve {label} reply {i} differs from the direct "
                                         "per-seed inversion")
                continue
            worst = max(worst, slot_err(f"serve {label} reply {i}", got, want,
                                        torch.bfloat16))
        log(f"[serve] {label}: 10 concurrent requests (8 in process, 2 over HTTP, one "
            f"float16) in {stats['batches']} groups, stats {stats}; launches {counts} (8 "
            f"per forward); every reply against the direct per-seed inversion: "
            + ("bit for bit" if server is split else f"worst {worst[1]}"))

    async def load(server, clients, per_client):
        lat = []

        async def client(c):
            for j in range(per_client):
                t = time.perf_counter()
                await server.invert(reqs[(c + j) % 8])
                lat.append(1e3 * (time.perf_counter() - t))

        await server.start()
        t = time.perf_counter()
        await asyncio.gather(*[client(c) for c in range(clients)])
        wall = time.perf_counter() - t
        await server.stop()
        return lat, wall

    for inflight in (1, 2):
        for clients in (1, 4, 8):
            server = BatchingServer(engine, max_batch=4, max_wait_ms=5.0,
                                    max_inflight=inflight)
            per_client = 32 // clients if clients > 1 else 16
            lat, wall = asyncio.run(load(server, clients, per_client))
            log(f"[serve] max_inflight {inflight}, {clients} clients x {per_client} "
                f"requests: {len(lat) / wall:.2f} requests/s, reply latency p50 "
                f"{percentile(lat, 50):.1f} ms, p95 {percentile(lat, 95):.1f} ms "
                f"(host clock; bfloat16, 1024px, max_batch 4; stats {server.stats})")
    return launched


def phase_end_to_end(engines, imgs, rounds=15):
    """invert ms/img of every configuration on the same weights, `rounds`
    interleaved rounds (one call of each configuration per round, in turn,
    images and seeds cycling), CUDA events around each call."""
    reps = {name: [] for name in engines}
    for i in range(rounds):
        for name, eng in engines.items():
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            eng.invert(imgs[i % 3], seed=i)
            b.record()
            b.synchronize()
            reps[name].append(a.elapsed_time(b))
    for name, r in reps.items():
        log(f"[main] invert ms/img, {name}, {rounds} interleaved rounds: median "
            f"{float(np.median(r)):.2f}, spread {min(r):.2f}-{max(r):.2f}, "
            f"all {[round(v, 2) for v in r]}")
    return reps


def phase_small_reference():
    """The slice at a small width on the card (kernels) against the same
    weights on the CPU (plain versions), the port's CPU path being the one
    the tests hold against the JAX package: unpacked, with the packed tail
    through the whole-stage kernel, and with body0 "fused" and "literal" +
    B5, the gates' channel floors lowered so that every SAMM scale runs
    the kernels; and unpacked in bfloat16, within JAX's island bound
    (bf16_compare; cuDNN and oneDNN round and sum in their own orders: the
    reading was 1.2% of the range and 0.012 on the mask)."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.ops import alignnet, samm_conv
    opt = e4e_opt(out_size=512, channel_multiplier=1, narrow=0.25,
                  encoder_num_layers=4)
    params = noisy(InversionEngine(opt, seed=SEED + 1, device="cuda")).net.state_dict()
    img = np.random.RandomState(SEED + 1).rand(512, 512, 3).astype(np.float32)
    x = torch.from_numpy(img[None] * 2.0 - 1.0)
    bf16 = e4e_opt(out_size=512, channel_multiplier=1, narrow=0.25,
                   encoder_num_layers=4, dtype="bfloat16")
    # (what, options, engine options, launches of the card's forward); SAMM
    # C is 128, 64, 32, 16 at 32..256px, so 2C >= 32 everywhere
    cases = [("unpacked, body0 algebraic", opt, {"samm_body0": "algebraic"}, {}),
             ("packed tail, stage kernel", opt,
              {"packed_tail": True, "tail_kernel": "stage"}, {"fused_packed_stage": 1}),
             ("body0 fused", opt, {"samm_body0": "fused"},
              {"alignnet_conv1": 8, "alignnet_conv2": 8}),
             ("body0 literal + B5", opt, {"samm_body0": "literal", "samm_conv_kernel": True},
              {"conv3x3_act": 16}),
             ("bfloat16, unpacked", bf16, {}, {})]
    floors = (alignnet.FUSED_MIN_CHANNELS, samm_conv.CONV_ACT_MIN_CHANNELS)
    alignnet.FUSED_MIN_CHANNELS, samm_conv.CONV_ACT_MIN_CHANNELS = 16, 32
    try:
        for what, case_opt, kwargs, launches in cases:
            gpu = InversionEngine(case_opt, params=params, device="cuda", **kwargs)
            cpu = cpu_twin(gpu, case_opt, params, **kwargs)
            # the same noise on both devices: draw it on the CPU, copy to the card
            noise = cpu.net.generator.make_noise(
                1, torch.Generator().manual_seed(3), torch.device("cpu"))
            with torch.inference_mode():
                ref = cpu.net(x, mod_size=256, noise=noise)
                reset_counts()
                out = gpu.net(x.cuda(), mod_size=256, noise=[n.cuda() for n in noise])
                torch.cuda.synchronize()
                counts = read_counts()
            want = expected_counts(warp_blend=8, **{**fused_body0(gpu, kwargs), **launches})
            if counts != want:
                raise AssertionError(f"small slice {what}: launched {counts}, expected {want}")
            if gpu.dtype == torch.bfloat16:
                text = bf16_compare(f"small slice {what}, card vs CPU", out,
                                    {k: ref[k].cuda() for k in ("image", "gen_image",
                                                                "mask", "lats")})[1]
                log(f"[check] small slice (512px, {what}): card vs CPU {text}")
                continue
            for k in ("image", "mask", "gen_image"):
                r = ref[k].numpy()
                err = float(np.abs(out[k].cpu().numpy() - r).max() / np.abs(r).max())
                if not err <= 1e-3:
                    raise AssertionError(f"small slice {what} {k}: card vs CPU rel err {err}")
                log(f"[check] small slice (512px, {what}) {k}: card vs CPU max rel err "
                    f"{err:.2e}")
    finally:
        alignnet.FUSED_MIN_CHANNELS, samm_conv.CONV_ACT_MIN_CHANNELS = floors


def e4e_train_opt(**g):
    """options/train/E4E_Face.yml's model and train sections, as a dict
    (tests/test_torch_train.py holds it to the file); `g` overrides
    network_g."""
    opt = {
        "is_mimo": True,
        "network_g": {"type": "ood_faceGAN_e4e", "out_size": 1024, "style_dim": 512,
                      "encoder": "E4E", "enable_modulation": True, "modulation_type": "NOISE",
                      "warp_scale": 0.08, "cycle_align": 2, "blend_with_gen": True,
                      "ModSize": None, "progressiveModSize": [32, 64, 128, 256],
                      "stage": "Inference", "progressiveStart": 2000, "progressiveStep": 4000,
                      "progressiveStageSteps": None},
        "network_d": {"type": "StyleGAN2Discriminator_mod", "out_size": 1024,
                      "channel_multiplier": 2, "resample_kernel": [1, 3, 3, 1]},
        "network_d2": {"type": "LatentDiscrinimator", "chn": 18, "dim": 512, "n_mlp": 8,
                       "hidden_chn": 4},
        "train": {
            "optim_g": {"type": "Adam", "lr": 2e-05, "generator_lr_decay": 1.0},
            "optim_d": {"type": "Adam", "lr": 2e-05},
            "optim_d2": {"type": "Adam", "lr": 2e-06},
            "scheduler": {"type": "MultiStepLR", "milestones": 15000, "gamma": 0.75},
            "total_iter": 1800000, "warmup_iter": -1, "startup_iter": 1800000,
            "fix_and_grad": {"fix": ["generator", "avg_latent", "encoder"], "grad": []},
            "skip_latent_g": True, "skip_gen_g": False, "which_gt": "gt",
            "grad_clip_norm": 999.0,
            "gan_opt": {"type": "GANLoss", "gan_type": "wgan_softplus", "loss_weight": 0.5},
            "r1_reg_weight": 10, "path_batch_shrink": 2, "path_reg_weight": 2,
            "net_g_reg_every": 99999999, "net_d_reg_every": 99999999,
            "mixing_prob": 0.9, "net_d_iters": 1, "net_d_init_iters": 0,
            "pix_opt": {"type": "MSELoss", "loss_weight": 1.0},
            "id_opt": {"type": "IDLoss", "loss_weight": 0.1, "ref_loss_weight": 0.0,
                       "ckpt": "checkpoints/converted/ir_se50"},
            "perceptual_opt": {"type": "PerceptualLoss",
                               "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                                                 "conv4_4": 1, "conv5_4": 1},
                               "vgg_type": "vgg19", "use_input_norm": True,
                               "perceptual_weight": 1.0, "style_weight": 50,
                               "range_norm": True, "criterion": "l1"},
            "mask_opt": {"type": "MaskLoss", "loss_weight": 5.0,
                         "loss_func": {"binary": [32, 64, 128, 256, 1024],
                                       "area": {"32": 0.3, "64": 0.3, "128": 0.2,
                                                "256": 0.2, "1024": 0.2},
                                       "target": 1, "binary_weight": 0.04}}}}
    opt["network_g"].update(g)
    return opt


def shipped_train_opt(yml):
    """The model and train sections of options/train/<yml> (E4E_Face.yml,
    ReStyle_Face.yml or FeatureStyle_Face.yml) as a dict
    (tests/test_torch_train.py holds each to its file): E4E_Face.yml's,
    with what the other two change."""
    opt = e4e_train_opt()
    g = opt["network_g"]
    if yml == "ReStyle_Face.yml":
        del g["stage"]
        g.update(type="ood_faceGAN_restyle", encoder="ReStyle", enc_cycle=5)
    elif yml == "FeatureStyle_Face.yml":
        del g["stage"]
        g.update(type="ood_faceGAN_FeatureStyle", encoder="FeatureStyle", cycle_align=3)
        opt["train"].update(total_iter=700000, startup_iter=700000)
    elif yml != "E4E_Face.yml":
        raise ValueError(yml)
    return opt


# a step past the last milestone of the shipped curriculum: ModSize 256
FUSED_STEP = 16001
STEP0_KEYS = {"l_d", "real_score", "fake_score", "l_d_r1", "l_g_path", "path_length", "l_g",
              "l_id_target", "l_pix", "l_percep", "l_style", "l_bin", "l_area", "l_total"}
FUSED_KEYS = STEP0_KEYS - {"l_d_r1", "l_g_path", "path_length"}
# B1 launches per train step: one SAMM block per ModSize octave from 32px,
# cycle_align each, per G forward. Step 0 (ModSize 32): the D phase's
# forward and the G phase's decode, 1 + 1 blocks; a fused step at ModSize
# 256: one forward, 4 blocks. ReStyle's encoder decodes carry no SAMM.
# The backward runs B1's twin, which launches nothing.
TRAIN_FAMILIES = (("E4E_Face.yml", 2), ("ReStyle_Face.yml", 2), ("FeatureStyle_Face.yml", 3))


def train_b1(cycle_align):
    return {0: 2 * cycle_align, FUSED_STEP: 4 * cycle_align}

# the card's train step against the CPU's on the same state and draws, at
# a small width, float32 without TF32: every logged loss within 1e-3
# relative; every gradient within 1e-2 of max(its leaf's max|ref|, 1e-3 of
# the net's largest gradient). R1's and the path regularizer's
# second-order gradients sum large terms that cancel: on the CPU the port
# and JAX differ by up to 5e-4 of a leaf's max there, and cuDNN sums in
# yet another order. A leaf whose exact gradient is 0 (a bias ahead of an
# instance norm: feats_conv.3.bias) holds float32 noise, ~9e-7 of the
# largest gradient of the 256px step 0 on an H100, held to 1e-5 of it.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_NOISE_FLOOR = 1e-3, 1e-2, 1e-3


def train_batch(model, size, seed):
    """A seeded (2, 1, size, size, 3) batch in [-1, 1] with its lq_size
    scores, on the model's device; the noise strengths set to 0.1 (seeded
    weights leave them 0), so that the noise matters."""
    from ood_gan_inversion_tpu_torch.nn.stylegan2 import NoiseInjection
    for m in model.net_g.modules():
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.1)
    rs = np.random.RandomState(seed)
    return {"gt": torch.from_numpy(rs.uniform(-1, 1, (2, 1, size, size, 3)).astype(np.float32)
                                   ).to(model.device),
            "lq_size": torch.from_numpy(rs.rand(2, 1).astype(np.float32)).to(model.device)}


def check_train_logs(what, logs, keys):
    if set(logs) != keys:
        raise AssertionError(f"{what}: logged {sorted(logs)}, expected {sorted(keys)}")
    bad = [k for k, v in logs.items() if not bool(torch.isfinite(v))]
    if bad:
        raise AssertionError(f"{what}: non-finite {bad}")


def phase_training(yml, cycle_align, fused_steps=2, reps=3, **g):
    """options/train/<yml>'s train step at full width (1024px, the family's
    encoder -- IR-SE-50 E4E, ReStyle's IR-SE-50 over enc_cycle 5 decodes,
    FeatureStyle's iresnet50 --, the 1024px discriminator, VGG19 and
    IR-SE-50 ArcFace losses, b = 2, float32, seeded weights and batch)
    through OODFaceGANModel.train_step: step 0 (the split phases: R1, and
    the path regularizer's double backward through B1's twin), then
    `fused_steps` fused steps at ModSize 256, each with the counts set to 0
    just before and read just after. Checks the logged losses, that frozen
    parameters stay bit for bit while the trainable G, D and EMA ones move,
    and B1's launches per step. Then times step 0 and the fused step (CUDA
    events, median of `reps` after a warm-up) with their peak memory.
    `g` overrides network_g. Returns (B1's launches, {step: median ms})."""
    from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
    t_phase = t0 = time.time()
    what = yml.split("_")[0] + "".join(f" {k}={v}" for k, v in g.items())
    b1 = train_b1(cycle_align)
    opt = shipped_train_opt(yml)
    opt["network_g"].update(g)
    model = OODFaceGANModel(opt, device="cuda", seed=SEED)
    batch = train_batch(model, 1024, SEED + 2)
    n_frozen = sum(p.numel() for p in model.net_g.parameters()) - sum(
        p.numel() for p in model.train_g.values())
    log(f"[train] {yml} model: 1024px, b = 2, {sum(p.numel() for p in model.train_g.values())}"
        f" trainable G parameters in {len(model.train_g)} tensors (feats_conv, SAMM), "
        f"{n_frozen} frozen, D {sum(p.numel() for p in model.net_d.parameters())}, built in "
        f"{time.time() - t0:.1f} s")
    frozen = {k: p.detach().clone() for k, p in model.net_g.named_parameters()
              if k not in model.train_g}
    train0 = {k: p.detach().clone() for k, p in model.train_g.items()}
    d0 = [p.detach().clone() for p in model.net_d.parameters()]
    ema0 = {k: v.clone() for k, v in model.ema.items()}
    launches = 0
    for step in (0,) + (FUSED_STEP,) * fused_steps:
        reset_counts()
        logs = model.train_step(batch, step)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expected_counts(warp_blend=b1[step])
        if counts != want:
            raise AssertionError(f"{what} train step {step}: launched {counts}, expected {want}")
        launches += counts["warp_blend"]
        check_train_logs(f"{what} train step {step}", logs,
                         STEP0_KEYS if step == 0 else FUSED_KEYS)
        log(f"[train] {what} step {step} (ModSize {model.schedule_at(step)[1]}): B1 launched "
            f"{counts['warp_blend']}; " + ", ".join(f"{k} {float(v):.5g}" for k, v in logs.items()))
    moved = [k for k, p in model.net_g.named_parameters()
             if k in frozen and not torch.equal(p, frozen[k])]
    if moved:
        raise AssertionError(f"{what} train: frozen parameters moved: {moved[:5]}")
    if all(torch.equal(p, train0[k]) for k, p in model.train_g.items()):
        raise AssertionError(f"{what} train: no trainable G parameter moved")
    if all(torch.equal(p, q) for p, q in zip(model.net_d.parameters(), d0)):
        raise AssertionError(f"{what} train: no D parameter moved")
    if all(torch.equal(v, ema0[k]) for k, v in model.ema.items()):
        raise AssertionError(f"{what} train: the EMA did not move")
    log(f"[train] {what}: frozen G parameters bit for bit ({len(frozen)} tensors); trainable "
        f"G, D and the EMA moved; B1 {launches} launches in {1 + fused_steps} steps ({b1[0]} "
        f"at step 0, {b1[FUSED_STEP]} per fused step)")
    medians = {}
    for step, kind in ((0, "step 0 (split, R1 + path reg)"), (FUSED_STEP, "fused step")):
        model.train_step(batch, step)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            model.train_step(batch, step)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
        medians[step] = float(np.median(times))
        log(f"[train] {what} {kind}: median {medians[step]:.2f} ms/step, all "
            f"{[round(t, 2) for t in times]} (CUDA events, b = 2, 1024px, float32, TF32 off); "
            f"peak memory {peak / 2 ** 30:.2f} GiB ({base / 2 ** 30:.2f} GiB held before it)")
    del model
    torch.cuda.empty_cache()
    log(f"[train] {what} phase took {time.time() - t_phase:.1f} s")
    return launches, medians


def copy_train_state(src, dst):
    """src's weights, EMA and path mean into dst (another device)."""
    for a, b in ((src.net_g, dst.net_g), (src.net_d, dst.net_d), (src.net_d2, dst.net_d2),
                 (src.cri_perceptual, dst.cri_perceptual), (src.cri_id, dst.cri_id)):
        b.load_state_dict(a.state_dict(), strict=True)
    with torch.no_grad():
        for k, v in src.ema.items():
            dst.ema[k].copy_(v)
        dst.mean_path_length.copy_(src.mean_path_length)


def recorded_grads(model):
    """Makes `model` keep every gradient it computes, by parameter name."""
    names = {id(p): n for net in ("net_g", "net_d", "net_d2")
             for n, p in getattr(model, net).named_parameters(prefix=net)}
    grads, inner = {}, model._grads

    def record(loss, params):
        out = inner(loss, params)
        grads.update({names[id(p)]: g.detach().cpu() for p, g in zip(params, out)})
        return out

    model._grads = record
    return grads


def small_train_opt(yml, **g):
    """options/train/<yml> at 256px (all four SAMM scales) with narrow
    widths and a 4-layer IR-SE trunk (FeatureStyle's iresnet50 keeps its
    depth); `g` overrides network_g."""
    opt = shipped_train_opt(yml)
    opt["network_g"].update(out_size=256, channel_multiplier=1, narrow=0.125,
                            encoder_num_layers=4, n_mlp=2, **g)
    opt["network_d"].update(out_size=256, channel_multiplier=1, narrow=0.125)
    opt["network_d2"].update(chn=14, n_mlp=2)
    return opt


# the small reference's steps: (what, options, step, B1 launches per step)
RANGER_COSINE = {"optim_g": {"type": "Ranger", "lr": 2e-05},
                 "optim_d": {"type": "Ranger", "lr": 2e-05},
                 "scheduler": {"type": "CosineAnnealingRestartLR", "periods": [2, 4],
                               "restart_weights": [1.0, 0.5], "eta_min": 1e-07},
                 "warmup_iter": 3}


def small_train_cases():
    e4e, wtrain = small_train_opt("E4E_Face.yml"), small_train_opt("E4E_Face.yml",
                                                                     stage="WTraining")
    wtrain["train"].update(RANGER_COSINE)
    return [("E4E", e4e, 0, train_b1(2)[0]), ("E4E", e4e, FUSED_STEP, train_b1(2)[FUSED_STEP]),
            ("ReStyle (enc_cycle 2)", small_train_opt("ReStyle_Face.yml", enc_cycle=2), 0,
             train_b1(2)[0]),
            ("FeatureStyle", small_train_opt("FeatureStyle_Face.yml"), 0, train_b1(3)[0]),
            ("E4E WTraining + Ranger + cosine restart", wtrain, FUSED_STEP,
             train_b1(2)[FUSED_STEP])]


def phase_train_small_reference():
    """The train step on the card against the same step on the CPU (the
    port's CPU path, which the tests hold against JAX), at 256px with
    narrow widths (small_train_opt): E4E_Face.yml's step 0 and a fused step
    at ModSize 256, ReStyle_Face.yml's and FeatureStyle_Face.yml's step 0,
    and a fused step of E4E_Face.yml at stage WTraining (stage 4 by step
    16001) with Ranger and the cosine restart; each with the CPU model's
    state copied to the card first and the same noise, path cotangent and
    z. Every logged loss and every gradient within TRAIN_LOSS_RTOL /
    TRAIN_GRAD_RTOL; B1 launched as the derived counts say."""
    from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
    t0 = time.time()
    for what, opt, step, b1 in small_train_cases():
        cpu = OODFaceGANModel(opt, device="cpu", seed=SEED + 3)
        gpu = OODFaceGANModel(opt, device="cuda", seed=SEED + 3)
        batch = train_batch(cpu, 256, SEED + 4)
        grads = [recorded_grads(m) for m in (cpu, gpu)]
        copy_train_state(cpu, gpu)
        g = torch.Generator().manual_seed(SEED + 5)
        noise = cpu.net_g.make_noise(2, g, torch.device("cpu"))
        cot = torch.randn(2, 256, 256, 3, generator=g) / 256.0
        z = torch.randn(2, 512, generator=g)
        ref = cpu.train_step(batch, step, noise=noise, path_cot=cot, z=z)
        reset_counts()
        got = gpu.train_step({k: v.cuda() for k, v in batch.items()}, step,
                             noise=[n.cuda() for n in noise], path_cot=cot.cuda(), z=z.cuda())
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != expected_counts(warp_blend=b1):
            raise AssertionError(f"small {what} train step {step}: launched {counts}")
        loss_err = max(abs(float(got[k]) - float(v)) / max(abs(float(v)), 1e-6)
                       for k, v in ref.items())
        if set(got) != set(ref) or not loss_err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"small {what} train step {step}: losses card vs CPU rel err "
                                 f"{loss_err}")
        top = max(float(v.abs().max()) for v in grads[0].values())
        worst, worst_k = 0.0, None
        for k, r in grads[0].items():
            scale = max(float(r.abs().max()), TRAIN_NOISE_FLOOR * top)
            err = float((grads[1][k] - r).abs().max()) / scale if scale > 0 else 0.0
            if err > worst:
                worst, worst_k = err, k
        if set(grads[0]) != set(grads[1]) or not worst <= TRAIN_GRAD_RTOL:
            raise AssertionError(f"small {what} train step {step}: gradient {worst_k} card vs "
                                 f"CPU {worst} of its scale")
        moved = max(float((p.detach().cpu() - q.detach()).abs().max()) for p, q in
                    zip(gpu.train_g.values(), cpu.train_g.values()))
        log(f"[check] small {what} train step {step} (256px, narrow, float32, TF32 off): card "
            f"vs CPU losses within {loss_err:.2e} relative (<= {TRAIN_LOSS_RTOL}), "
            f"{len(grads[0])} gradients within {worst:.2e} of their scale (<= "
            f"{TRAIN_GRAD_RTOL}, largest at {worst_k}); trainable G after the step within "
            f"{moved:.2e} abs; B1 launched {counts['warp_blend']}")
        del cpu, gpu
    log(f"[check] small train steps took {time.time() - t0:.1f} s")


# --- the training entry point: train_pipeline on options/train/E4E_Face.yml -----------------
PIPELINE_TRAIN, PIPELINE_VAL = 8, 2          # synthetic 1024px PNGs
PIPELINE_TIMED_ITERS = 8                     # the ModSize 256 run's length
# the validation metrics recomputed from the final model: within 1e-6
# relative (the same forward on the same weights and noise)
PIPELINE_METRIC_RTOL = 1e-6


def write_face_pngs(folder, n, seed):
    """n seeded 1024px PNGs: smooth colour fields (a 16x16 field resized
    bilinearly) with a little noise, so that they compress and decode as
    photographs do."""
    import os
    from ood_gan_inversion_tpu_torch.utils.img_util import imwrite, resize_linear
    os.makedirs(folder)
    rs = np.random.RandomState(seed)
    for i in range(n):
        img = resize_linear(rs.rand(16, 16, 3).astype(np.float32), 1024)
        img = np.clip(img * 255 + rs.randn(1024, 1024, 3) * 4, 0, 255).astype(np.uint8)
        imwrite(img, f"{folder}/{i}.png")


class StepRecorder:
    """Wraps OODFaceGANModel.train_step while installed: records each call's
    step, its logs, and CUDA events before and after it (the iteration's
    period is start to next start, its step start to end); snapshots the
    frozen generator parameters at the first call."""

    def __init__(self):
        from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
        self.cls, self.orig = OODFaceGANModel, OODFaceGANModel.train_step
        self.calls, self.frozen = [], None
        rec = self

        def train_step(model, batch, step, **kw):
            if rec.frozen is None:
                rec.frozen = {k: p.detach().clone() for k, p in model.net_g.named_parameters()
                              if k not in model.train_g}
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            logs = rec.orig(model, batch, step, **kw)
            b.record()
            rec.calls.append((step, logs, a, b))
            return logs

        self.wrapped = train_step

    def __enter__(self):
        self.cls.train_step = self.wrapped
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig

    def steps(self):
        return [c[0] for c in self.calls]

    def times_ms(self, skip=2):
        """(median period, median step) in ms over the calls after `skip`."""
        torch.cuda.synchronize()
        c = self.calls[skip:]
        periods = [x[2].elapsed_time(y[2]) for x, y in zip(c, c[1:])]
        steps = [x[2].elapsed_time(x[3]) for x in c]
        return float(np.median(periods)), float(np.median(steps)), periods


def pipeline_b1(model, steps, val_iters, n_val):
    """B1 launches of a run: per G forward, one per SAMM block (ModSize 32:
    one; each octave up to 256: one more) per align cycle (2), at the
    ModSize of the step; a train step at reg_every 99999999 is one fused
    G forward; a validation one forward per image."""
    def per_forward(step):
        return 2 * (int(math.log2(model.schedule_at(step)[1] // 32)) + 1)
    return sum(per_forward(s) for s in steps) + n_val * sum(per_forward(s) for s in val_iters)


def check_pipeline_run(what, run, rec, first, n_val, b1, val_iters):
    """The run's losses are finite, its B1 launches what its curriculum
    gives, its steps consecutive from `first`."""
    got = list(range(first, run.current_iter + 1))
    if rec.steps() != got:
        raise AssertionError(f"{what}: train_step saw steps {rec.steps()}, expected {got}")
    bad = [(s, k) for s, logs, _, _ in rec.calls for k, v in logs.items()
           if not bool(torch.isfinite(v))]
    if bad:
        raise AssertionError(f"{what}: non-finite losses {bad[:5]}")
    want = expected_counts(warp_blend=pipeline_b1(run.model, got, val_iters, n_val))
    if b1 != want:
        raise AssertionError(f"{what}: launched {b1}, expected {want}")


def check_validation(run, val_dir, vis_dir, n_val):
    """The final validation's metrics against direct calculate_* calls on
    the images it scored, recomputed from the final model (the state it
    validated) with validation's noise; its dumps are those images, byte
    for byte as the same encoder writes them."""
    import os
    from ood_gan_inversion_tpu_torch.metrics import (calculate_lpips, calculate_psnr,
                                                     calculate_ssim)
    from ood_gan_inversion_tpu_torch.utils.img_util import imread, imwrite, tensor2img
    model, it = run.model, run.current_iter
    fns = {"psnr": calculate_psnr, "ssim": calculate_ssim, "lpips": calculate_lpips}
    sums = dict.fromkeys(fns, 0.0)
    for i in range(n_val):
        gt = (imread(f"{val_dir}/{i}.png") - 0.5) / 0.5
        x = torch.from_numpy(gt[None]).cuda()
        noise = model.make_noise(1, torch.Generator("cuda").manual_seed(0))
        sr = tensor2img(model.infer(x, step=it, noise=noise)["image"][0].cpu().numpy())
        gt_img = tensor2img(gt)
        for k, fn in fns.items():
            sums[k] += fn(sr, gt_img, crop_border=2, test_y_channel=True, device="cuda")
        # the dumps are the scored images, through the same JPEG encoder
        for img, f in ((sr, f"{i}_{it}.jpg"), (gt_img, f"{i}_gt.jpg")):
            imwrite(img, f"{vis_dir}/check.jpg")
            with open(f"{vis_dir}/check.jpg", "rb") as a, open(f"{vis_dir}/{i}/{f}", "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"validation dump {i}/{f} is not the scored image")
        if not os.path.isfile(f"{vis_dir}/{i}/{i}_{it}_masks.jpg"):
            raise AssertionError(f"validation dump {i}/{i}_{it}_masks.jpg missing")
    errs = {}
    for k in fns:
        direct, got = sums[k] / n_val, run.val_results[k]
        errs[k] = abs(got - direct) / max(abs(direct), 1e-12)
        if not errs[k] <= PIPELINE_METRIC_RTOL:
            raise AssertionError(f"validation {k}: {got} against a direct call's {direct}")
    return errs


def phase_train_pipeline():
    """This slice's main path: `train.train_pipeline`, the entry point of
    `python -m ood_gan_inversion_tpu_torch.run_train`, on
    options/train/E4E_Face.yml at full width (1024px, b = 2, float32, TF32
    off, seeded weights) over 8 train and 2 val synthetic 1024px PNGs. The
    only overrides: the dataroots, no pretrained G or D (absent files),
    the experiment root, total_iter / val_freq / print_freq /
    save_checkpoint_freq. Run 1: 4 iterations, validation and a save at 4
    (and the final save and validation at 4, as JAX); run 2:
    --auto_resume to 6; run 3: ModSize 256 (every SAMM scale), 8
    iterations, for the fused step's time at full width. Each run with the
    counts set to 0 just before it and read just after. Returns B1's
    launches."""
    import os
    import shutil
    import tempfile
    from ood_gan_inversion_tpu_torch.train import train_pipeline
    from ood_gan_inversion_tpu_torch.utils.checkpoint import find_resume_state
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="ogi_pipeline_")
    try:
        write_face_pngs(f"{root}/train", PIPELINE_TRAIN, SEED + 20)
        write_face_pngs(f"{root}/val", PIPELINE_VAL, SEED + 21)
        log(f"[pipeline] wrote {PIPELINE_TRAIN} + {PIPELINE_VAL} 1024px PNGs in "
            f"{time.time() - t_phase:.1f} s")

        def args(exp, total, val_freq, save_freq, print_freq, *extra):
            return ["--opt", "options/train/E4E_Face.yml", "--device", "cuda", "--force_yml",
                    f"datasets:train:dataroot_gt_list=[{root}/train]",
                    f"datasets:val:dataroot_gt={root}/val",
                    "path:pretrain_network_g=~", "path:pretrain_network_d=~",
                    f"path:experiments_root={exp}", f"train:total_iter={total}",
                    f"val:val_freq={val_freq}", f"logger:print_freq={print_freq}",
                    f"logger:save_checkpoint_freq={save_freq}", *extra]

        launches, frozen0, start2 = 0, None, None
        for name, argv, first, val_iters in (
                ("run 1 (4 iterations)", args(f"{root}/exp", 4, 4, 4, 2), 1, (4, 4)),
                ("run 2 (--auto_resume to 6)",
                 ["--auto_resume"] + args(f"{root}/exp", 6, 4, 4, 2), 5, (6,)),
                ("run 3 (ModSize 256)",
                 args(f"{root}/exp256", PIPELINE_TIMED_ITERS, 1000, 1000, 4,
                      "network_g:ModSize=256"), 1, (PIPELINE_TIMED_ITERS,))):
            with StepRecorder() as rec:
                rec.frozen = frozen0         # run 2 holds its G to run 1's start
                reset_counts()
                t0 = time.time()
                run = train_pipeline(".", args=argv)
                torch.cuda.synchronize()
                wall = time.time() - t0
                counts = read_counts()
            check_pipeline_run(name, run, rec, first, PIPELINE_VAL, counts, val_iters)
            launches += counts["warp_blend"]
            frozen0 = rec.frozen
            skip = 2 if len(rec.calls) > 3 else 0
            period, step, periods = rec.times_ms(skip)
            log(f"[pipeline] {name}: iterations {run.start_iter + 1}..{run.current_iter}, "
                f"B1 launched {counts['warp_blend']} (training + {len(val_iters)} validations "
                f"of {PIPELINE_VAL} images), {wall:.1f} s in all; ms/iteration (CUDA events, "
                f"start to next start, after {skip} warm-up) median {period:.2f}, all "
                f"{[round(p, 2) for p in periods]}; train_step median {step:.2f} ms; "
                f"host clock {1e3 * run.iter_time:.2f} ms/iteration, data_time "
                f"{1e3 * run.data_time:.3f} ms; checkpoint saves "
                f"{[round(s, 2) for s in run.save_seconds]} s; validation "
                f"{[round(1e3 * s / PIPELINE_VAL, 1) for s in run.val_seconds]} ms/image; "
                f"metrics {run.val_results}")
            if name.startswith("run 2"):
                start2 = run.start_iter
                moved = [k for k, p in run.model.net_g.named_parameters()
                         if k in rec.frozen and not torch.equal(p, rec.frozen[k])]
                if moved:
                    raise AssertionError(f"pipeline: frozen G parameters moved: {moved[:5]}")
                log(f"[pipeline] frozen G parameters bit for bit after 6 iterations "
                    f"({len(rec.frozen)} tensors)")
                errs = check_validation(run, f"{root}/val", f"{root}/exp/visualization",
                                        PIPELINE_VAL)
                log(f"[pipeline] final validation against direct calculate_* calls: relative "
                    f"{errs} (<= {PIPELINE_METRIC_RTOL}); its JPEG dumps are the scored images")
                frozen0 = None
            del run, rec
        for f in ("models/net_4.pth", "training_states/state_4.pth", "models/net_6.pth",
                  "training_states/state_6.pth"):
            if not os.path.isfile(f"{root}/exp/{f}"):
                raise AssertionError(f"pipeline: checkpoint {f} missing")
        if start2 != 4 or find_resume_state(f"{root}/exp/training_states")[1] != 6:
            raise AssertionError(f"pipeline: resumed at {start2}")
        size = os.path.getsize(f"{root}/exp/training_states/state_4.pth")
        log(f"[pipeline] checkpoints written; a training state is {size / 2 ** 30:.2f} GiB; the "
            f"resumed run started at iteration {start2 + 1}")
        log(f"[pipeline] phase took {time.time() - t_phase:.1f} s")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_restyle_pipeline(bare_step_ms):
    """`train.train_pipeline` on options/train/ReStyle_Face.yml at full
    width (1024px, b = 2, enc_cycle 5, float32, seeded weights) over 2
    train and 1 val synthetic PNGs, at ModSize 256: 2 iterations, the
    final validation of 1 image and the final save; the only overrides
    those of phase_train_pipeline. Checks the losses, B1's launches
    against the curriculum and the checkpoint, and prints ms/iteration
    beside the bare fused step's `bare_step_ms`. Returns B1's launches."""
    import os
    import shutil
    import tempfile
    from ood_gan_inversion_tpu_torch.train import train_pipeline
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="ogi_restyle_pipeline_")
    try:
        write_face_pngs(f"{root}/train", 2, SEED + 22)
        write_face_pngs(f"{root}/val", 1, SEED + 23)
        argv = ["--opt", "options/train/ReStyle_Face.yml", "--device", "cuda", "--force_yml",
                f"datasets:train:dataroot_gt_list=[{root}/train]",
                f"datasets:val:dataroot_gt={root}/val",
                "path:pretrain_network_g=~", "path:pretrain_network_d=~",
                f"path:experiments_root={root}/exp", "train:total_iter=2", "val:val_freq=1000",
                "logger:print_freq=1", "logger:save_checkpoint_freq=1000",
                "network_g:ModSize=256"]
        with StepRecorder() as rec:
            reset_counts()
            t0 = time.time()
            run = train_pipeline(".", args=argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = read_counts()
        check_pipeline_run("ReStyle_Face.yml run", run, rec, 1, 1, counts, (2,))
        for f in ("models/net_2.pth", "training_states/state_2.pth"):
            if not os.path.isfile(f"{root}/exp/{f}"):
                raise AssertionError(f"ReStyle pipeline: checkpoint {f} missing")
        period, step, periods = rec.times_ms(0)
        log(f"[pipeline] ReStyle_Face.yml (enc_cycle 5, ModSize 256): iterations 1..2, B1 "
            f"launched {counts['warp_blend']} (training + a validation of 1 image), {wall:.1f} s "
            f"in all; ms/iteration (CUDA events, start to next start, no warm-up) "
            f"{[round(x, 2) for x in periods]}; train_step median {step:.2f} ms, all "
            f"{[round(c[2].elapsed_time(c[3]), 2) for c in rec.calls]}; the bare fused step "
            f"{bare_step_ms:.2f} ms (phase_training); checkpoint save "
            f"{[round(x, 2) for x in run.save_seconds]} s; validation "
            f"{[round(1e3 * x, 1) for x in run.val_seconds]} ms/image; metrics "
            f"{run.val_results}")
        log(f"[pipeline] ReStyle phase took {time.time() - t_phase:.1f} s")
        return counts["warp_blend"]
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- the evaluation entry point: test_pipeline on every options/test/*.yml ----------------
# (family, B1 launches per image: one per SAMM block (4 at ModSize 256) per align cycle)
TEST_FAMILIES = (("E4E", 8), ("ReStyle", 8), ("FeatureStyle", 12))
TEST_IMAGES = 2                              # synthetic 1024px PNGs
# the test metrics recomputed from the model: within 1e-6 relative (the
# same forward on the same weights and noise)
TEST_METRIC_RTOL = 1e-6
# the Inception features on the card against the CPU's: float32, ~95 convs
FID_FEATURE_RTOL = 1e-4


class ValidationRecorder:
    """Wraps test.py's run_validation while installed: records the model,
    the loader's options and the results of each call."""

    def __init__(self):
        from ood_gan_inversion_tpu_torch import test as test_mod
        self.mod, self.orig, self.calls = test_mod, test_mod.run_validation, []

    def __enter__(self):
        def run_validation(model, loader, opt, **kw):
            results = self.orig(model, loader, opt, **kw)
            self.calls.append((model, opt, results))
            return results
        self.mod.run_validation = run_validation
        return self

    def __exit__(self, *exc):
        self.mod.run_validation = self.orig


def recheck_test_run(what, model, opt, results, data_dir):
    """The run's metrics against direct calculate_* calls on the images it
    scored, recomputed from its model with validation's noise (seed
    manual_seed, step 0); its JPEG dumps are those images, byte for byte as
    the same encoder writes them. Returns (the outputs in [0, 1] RGB, ms of
    each forward, {metric: ms per image})."""
    from ood_gan_inversion_tpu_torch.metrics import calculate_metric
    from ood_gan_inversion_tpu_torch.utils.img_util import imread, imwrite, tensor2img
    vis = opt["path"]["visualization"]
    metrics = opt["val"]["metrics"]
    sums, metric_s, fwd_ms, outs = dict.fromkeys(metrics, 0.0), dict.fromkeys(metrics, 0.0), [], []
    for i in range(TEST_IMAGES):
        gt = (imread(f"{data_dir}/{i}.png") - 0.5) / 0.5
        x = torch.from_numpy(gt[None]).cuda()
        noise = model.make_noise(1, torch.Generator("cuda").manual_seed(opt["manual_seed"]))
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = model.infer(x, step=0, noise=noise)["image"]
        b.record()
        b.synchronize()
        fwd_ms.append(a.elapsed_time(b))
        out = out[0].float().cpu().numpy()
        if not np.isfinite(out).all():
            raise AssertionError(f"{what}: non-finite inversion")
        outs.append((out + 1.0) / 2.0)
        sr, gt_img = tensor2img(out), tensor2img(gt)
        for name, m_opt in metrics.items():
            t0 = time.time()
            sums[name] += calculate_metric({"img": sr, "img2": gt_img, "device": model.device},
                                           m_opt)
            metric_s[name] += time.time() - t0
        imwrite(sr, f"{vis}/check.jpg")
        with open(f"{vis}/check.jpg", "rb") as f1, open(f"{vis}/{i}/{i}_0.jpg", "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{what}: dump {i}/{i}_0.jpg is not the scored image")
    got = results
    for name in metrics:
        direct = sums[name] / TEST_IMAGES
        err = abs(got[name] - direct) / max(abs(direct), 1e-12)
        if not (np.isfinite(got[name]) and err <= TEST_METRIC_RTOL):
            raise AssertionError(f"{what} {name}: {got[name]} against a direct call's {direct}")
    return outs, fwd_ms, {k: 1e3 * v / TEST_IMAGES for k, v in metric_s.items()}


def time_restyle_avg_image(net, batches=(1, 4), iters=5):
    """ReStyle's average-image decode (the 1024px generator decode of
    avg_latent, pooled to 256px) at each batch, ms by CUDA events, median
    of `iters` after one warm-up: the port decodes it per sample, where
    JAX decodes it once at batch 1 and tiles it."""
    from ood_gan_inversion_tpu_torch.ops.resize import adaptive_avg_pool
    ms = {}
    with torch.no_grad():
        for b in batches:
            lats = net.avg_latent[None].expand(b, -1, -1)
            noise = net.generator.make_noise(b, torch.Generator("cuda").manual_seed(0),
                                             torch.device("cuda"))
            times = []
            for _ in range(iters + 1):
                a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                adaptive_avg_pool(net.generator(lats, noise), (256, 256))
                e.record()
                e.synchronize()
                times.append(a.elapsed_time(e))
            ms[b] = float(np.median(times[1:]))
    return ms


def phase_test_pipeline():
    """This slice's main path: `test.test_pipeline`, the entry point of
    `python -m ood_gan_inversion_tpu_torch.run_test`, on each shipped
    options/test/*.yml (E4E, ReStyle at enc_cycle 5, FeatureStyle at
    cycle_align 3; 1024px, float32, TF32 off, seeded weights) over
    TEST_IMAGES synthetic 1024px PNGs. The only overrides: the dataroot,
    the absent pretrained G and identity model_path, the results root.
    Each run with the counts set to 0 just before it and read just after.
    Checks B1's launches, finite metrics equal to direct calculate_* calls,
    the dumps; prints ms per image of the forward and of each metric; then
    InceptionV3FID features of the outputs and inputs on the card against
    the CPU, and their FID. Returns B1's launches."""
    import shutil
    import tempfile
    from ood_gan_inversion_tpu_torch import test as test_mod
    from ood_gan_inversion_tpu_torch.metrics import calculate_fid
    from ood_gan_inversion_tpu_torch.nn.inception import BasicConv2d, InceptionV3FID
    from ood_gan_inversion_tpu_torch.nn.layers import init_weights
    from ood_gan_inversion_tpu_torch.utils.img_util import imread
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="ogi_test_")
    try:
        write_face_pngs(f"{root}/data", TEST_IMAGES, SEED + 30)
        launches, outputs = 0, []
        for family, b1 in TEST_FAMILIES:
            args = ["--opt", f"options/test/{family}_Face_test.yml", "--device", "cuda",
                    "--force_yml", f"datasets:test_1:dataroot_gt={root}/data",
                    "path:pretrain_network_g=~", f"path:results_root={root}/{family}",
                    f"val:metrics:identity:model_path={root}/absent/model_ir_se50.pth"]
            with ValidationRecorder() as rec:
                reset_counts()
                t0 = time.time()
                results = test_mod.test_pipeline(".", args=args)
                torch.cuda.synchronize()
                wall = time.time() - t0
                counts = read_counts()
            want = expected_counts(warp_blend=b1 * TEST_IMAGES)
            if counts != want:
                raise AssertionError(f"test {family}: launched {counts}, expected {want}")
            launches += counts["warp_blend"]
            (model, opt, res), = rec.calls
            if set(results) != {"CelebAHQ"} or set(res) != {"psnr", "ssim", "lpips", "identity"}:
                raise AssertionError(f"test {family}: results {results}")
            net = model.net_g
            shape = {"ModSize": opt["network_g"]["ModSize"], "out_size": net.out_size,
                     "cycle_align": next(iter(net.modulation.values())).alignment.cycle_align,
                     "enc_cycle": getattr(net, "enc_cycle", None)}
            outs, fwd_ms, metric_ms = recheck_test_run(f"test {family}", model, opt, res,
                                                       f"{root}/data")
            outputs += outs
            log(f"[test] {family}_Face_test.yml ({type(net).__name__}, {shape}, "
                f"{sum(p.numel() for p in net.parameters())} parameters): {results['CelebAHQ']}; "
                f"B1 launched {counts['warp_blend']} ({b1}/image); test_pipeline {wall:.1f} s "
                f"for {TEST_IMAGES} images, model build included; metrics equal direct calls "
                f"(<= {TEST_METRIC_RTOL} relative), dumps are the scored images")
            log(f"[test] {family} ms/img (CUDA events, float32, TF32 off): forward "
                f"{[round(v, 2) for v in fwd_ms]}; metrics (host clock, ms/img): "
                f"{ {k: round(v, 1) for k, v in metric_ms.items()} }")
            if family == "ReStyle":
                avg_ms = time_restyle_avg_image(net)
                log(f"[test] ReStyle average-image decode ({net.out_size}px, float32, CUDA "
                    f"events, median "
                    f"of 5): {avg_ms} ms by batch; a per-seed batch of b pays b of them, "
                    f"JAX's tiled batch-1 decode one")
            del model, rec, net
            torch.cuda.empty_cache()
        inputs = [imread(f"{root}/data/{i}.png") for i in range(TEST_IMAGES)]
        # InceptionV3FID on the card against the CPU, on the outputs and inputs,
        # seeded with He-scaled kernels (JAX's N(0, 0.02) init shrinks the
        # activations towards 0 through ~95 ReLU convs) the same on both
        cpu_net = init_weights(InceptionV3FID(), SEED + 31).eval()
        g = torch.Generator().manual_seed(SEED + 32)
        with torch.no_grad():
            for m in cpu_net.modules():
                if isinstance(m, BasicConv2d):
                    m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                                   * math.sqrt(2.0 / m.weight[0].numel()))
        with torch.device("cuda"):
            gpu_net = InceptionV3FID().eval()
        gpu_net.load_state_dict(cpu_net.state_dict())
        x = torch.from_numpy(np.stack(outputs + inputs).astype(np.float32))
        feats = {}
        with torch.no_grad():
            gpu_net(x[:1].cuda())
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            feats["cuda"] = gpu_net(x.cuda())
            b.record()
            b.synchronize()
            inc_ms = a.elapsed_time(b) / len(x)
            feats["cuda"] = feats["cuda"].cpu().numpy().astype(np.float64)
            feats["cpu"] = cpu_net(x).numpy().astype(np.float64)
        err = float(np.abs(feats["cuda"] - feats["cpu"]).max() / np.abs(feats["cpu"]).max())
        if not err <= FID_FEATURE_RTOL:
            raise AssertionError(f"Inception features: card vs CPU rel err {err}")
        t0 = time.time()
        fid = calculate_fid(feats1=feats["cuda"][:len(outputs)], feats2=feats["cuda"][len(outputs):])
        if not np.isfinite(fid):
            raise AssertionError(f"FID {fid}")
        log(f"[test] InceptionV3FID (seeded) on {len(outputs)} outputs and {len(inputs)} inputs: "
            f"card vs CPU features max rel err {err:.2e} (<= {FID_FEATURE_RTOL}); "
            f"{inc_ms:.2f} ms/img on the card (1024px resized to 299 inside); FID(outputs, "
            f"inputs) {fid!r} ({time.time() - t0:.1f} s on the host, scipy sqrtm)")
        log(f"[test] phase took {time.time() - t_phase:.1f} s")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_family_small_reference():
    """Each new family's forward at a small width on the card (kernels)
    against the same weights on the CPU (plain versions), as
    phase_small_reference holds E4E: ReStyle (enc_cycle 2, a 4-layer
    trunk) and FeatureStyle (iresnet50, cycle_align 3), 512px,
    channel_multiplier 1, narrow 0.25, noise 0.1."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    cases = [("ReStyle", e4e_opt(type="ood_faceGAN_restyle", encoder="ReStyle", enc_cycle=2,
                                 out_size=512, channel_multiplier=1, narrow=0.25,
                                 encoder_num_layers=4), 8),
             ("FeatureStyle", e4e_opt(type="ood_faceGAN_FeatureStyle", encoder="FeatureStyle",
                                      cycle_align=3, out_size=512, channel_multiplier=1,
                                      narrow=0.25), 12)]
    img = np.random.RandomState(SEED + 2).rand(512, 512, 3).astype(np.float32)
    x = torch.from_numpy(img[None] * 2.0 - 1.0)
    for what, opt, b1 in cases:
        params = noisy(InversionEngine(opt, seed=SEED + 3, device="cuda")).net.state_dict()
        gpu = InversionEngine(opt, params=params, device="cuda")
        cpu = cpu_twin(gpu, opt, params)
        noise = cpu.net.make_noise(1, torch.Generator().manual_seed(4), torch.device("cpu"))
        with torch.inference_mode():
            ref = cpu.net(x, mod_size=256, noise=noise)
            reset_counts()
            out = gpu.net(x.cuda(), mod_size=256, noise=[n.cuda() for n in noise])
            torch.cuda.synchronize()
            counts = read_counts()
        if counts != expected_counts(warp_blend=b1, **fused_body0(gpu)):
            raise AssertionError(f"small {what}: launched {counts}, expected B1 {b1}")
        errs = {}
        for k in ("image", "mask", "gen_image", "lats"):
            r = ref[k].numpy()
            errs[k] = float(np.abs(out[k].cpu().numpy() - r).max() / np.abs(r).max())
            if not errs[k] <= 1e-3:
                raise AssertionError(f"small {what} {k}: card vs CPU rel err {errs[k]}")
        log(f"[check] small {what} (512px, narrow 0.25, {len(noise)} noise tensors): card vs "
            f"CPU max rel err {errs} (<= 1e-3); B1 launched {b1}, body0 "
            f"{gpu.samm_body0} ({counts['alignnet_conv1']} B2a and B2b launches)")


# --- the rest of the model inventory: SAMM options, generator families, nets --------------
BTN = "style_bottleneck_IR"
# the four inversion configurations of phase_inventory: (what, network_g
# overrides, engine options)
INVENTORY_ENGINES = (
    ("(a) mod_btn, float32", {"mod_btn": BTN}, {}),
    ("(b) mod_btn + ADD, float32", {"mod_btn": BTN, "modulation_type": "ADD"}, {}),
    ("(c) mod_btn + ADD, bfloat16", {"mod_btn": BTN, "modulation_type": "ADD",
                                     "dtype": "bfloat16"}, {}),
    ("(d) bfloat16, float32 SAMM island", {"dtype": "bfloat16"}, {"samm_fp32_infer": True}))
# in bfloat16 the card's forward is held against the CPU's by bf16_compare
# on image, gen_image and mask. With ADD and the bottleneck at 256px,
# gen_image read 2.2% of the range before B1's bfloat16 sampling matched its
# plain version, and 1.87% after (PERF.md); the log prints beside it how far
# each device's own output moves under a NUDGE of its input, which reaches
# that size there
INVENTORY_BF16_HELD = ("image", "gen_image", "mask")
# the card's call against the CPU's on the same weights and inputs, float32
# without TF32: a deep net (generators, encoders, the ArcFace trunk)
# within the slice's 1e-3 of max|ref|, as phase_small_reference holds the
# 512px slice; deform_conv2d and LPIPS_Loss within 1e-4
INVENTORY_NET_RTOL, INVENTORY_OP_RTOL = 1e-3, 1e-4


def forward_ms(engine, x, seed, reps=5):
    """Median ms of one forward of the preprocessed batch x (CUDA events,
    after a warm-up), and the reply."""
    out = engine._dispatch_perkey(x, [seed])
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = engine._dispatch_perkey(x, [seed])
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), out


def inventory_engine_checks():
    """(a)-(d) at 1024px (E4E_Face_test.yml's network_g, IR-SE-50, noise
    0.1, b = 1): ms/img, B1's launches in one forward (8: 4 SAMM blocks x
    cycle_align 2, counted from 0 just before it) and finite outputs; then
    each configuration at 256px (narrow 0.25, a 4-unit trunk) on the card
    against the CPU on the same weights and noise. Returns B1's launches."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    img = np.random.RandomState(SEED + 5).rand(1024, 1024, 3).astype(np.float32)
    launches = 0
    for what, g, kw in INVENTORY_ENGINES:
        engine = noisy(InversionEngine(e4e_opt(**g), seed=SEED, device="cuda", **kw))
        x = engine.input_batch([img])
        ms, _ = forward_ms(engine, x, 7)
        reset_counts()
        out = engine._dispatch_perkey(x, [7])
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != expected_counts(warp_blend=8, **fused_body0(engine, kw)):
            raise AssertionError(f"inventory {what}: launched {counts}, expected B1 8")
        launches += counts["warp_blend"]
        for k in ("image", "gen_image", "mask", "lats"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"inventory {what}: non-finite {k}")
        if tuple(out["image"].shape) != (1, 1024, 1024, 3):
            raise AssertionError(f"inventory {what}: image shape {tuple(out['image'].shape)}")
        del engine
        torch.cuda.empty_cache()
        text = inventory_small_reference(what, g, kw, img)
        log(f"[inventory] {what}: {ms:.2f} ms/img (1024px, b = 1, CUDA events, median of 5); "
            f"B1 {counts['warp_blend']} launches per forward; image {out['image'].dtype}; {text}")
    return launches


def inventory_small_reference(what, g, kw, img):
    """One of INVENTORY_ENGINES at 256px (narrow 0.25, a 4-unit trunk) on
    the card against the CPU on the same weights and noise, B1's 8 launches
    counted. float32: within INVENTORY_NET_RTOL of max|ref|. bfloat16:
    bf16_compare, held on INVENTORY_BF16_HELD; beside it each device's own
    move under a NUDGE of the input (the worst of NUDGE_SEEDS), read as
    bf16_compare reads the difference (a share of the range, the mask's
    max|diff|). Returns the log text."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    keys = ("image", "gen_image", "mask", "lats")
    small = e4e_opt(out_size=256, channel_multiplier=1, narrow=0.25, encoder_num_layers=4, **g)
    params = noisy(InversionEngine(small, seed=SEED + 6, device="cuda", **kw)).net.state_dict()
    engines = {"cuda": InversionEngine(small, params=params, device="cuda", **kw)}
    engines["cpu"] = cpu_twin(engines["cuda"], small, params, **kw)
    noise = engines["cpu"].net.make_noise(1, torch.Generator().manual_seed(8), torch.device("cpu"))
    xs = torch.from_numpy(img[None, ::4, ::4] * 2.0 - 1.0)

    def run(dev, x):
        with torch.inference_mode():
            out = engines[dev].net(x.to(dev), mod_size=256, noise=[n.to(dev) for n in noise])
        return {k: out[k].float().cpu() for k in keys}

    ref = run("cpu", xs)
    reset_counts()
    got = run("cuda", xs)
    torch.cuda.synchronize()
    if read_counts() != expected_counts(warp_blend=8, **fused_body0(engines["cuda"], kw)):
        raise AssertionError(f"inventory {what} at 256px: launched {read_counts()}")
    if engines["cuda"].dtype != torch.bfloat16:
        errs = {k: rel_err(got[k], ref[k]) for k in ("image", "gen_image", "mask")}
        bad = {k: v for k, v in errs.items() if not v <= INVENTORY_NET_RTOL}
        if bad:
            raise AssertionError(f"inventory {what} 256px: card vs CPU rel err {bad}")
        return (f"card vs CPU at 256px ({len(noise)} noise tensors): "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (max rel err, <= {INVENTORY_NET_RTOL})")
    text = bf16_compare(f"inventory {what} 256px, card vs CPU", got, ref,
                        held=INVENTORY_BF16_HELD)[1]
    moves = {}
    for dev in ("cuda", "cpu"):
        base = got if dev == "cuda" else ref
        readings = []
        for seed in NUDGE_SEEDS:
            gen = torch.Generator().manual_seed(seed)
            readings.append(span_errs(run(dev, xs * (1.0 + NUDGE * torch.randn(
                xs.shape, generator=gen))), base))
        moves[dev] = {k: max(r[k] for r in readings) for k in readings[0]}
    return (f"card vs CPU at 256px ({len(noise)} noise tensors): {text}; each device's own "
            f"output under a {NUDGE:g} nudge of the input (worst of {len(NUDGE_SEEDS)} seeds, "
            "the same reading): " + "; ".join(
                f"{dev} " + ", ".join(f"{k} {v:.4f}" for k, v in m.items())
                for dev, m in moves.items()))


def hold_on_card(what, fn_cpu, fn_gpu, rtol):
    """fn_gpu() against fn_cpu() (each returning a tensor): rel err within
    rtol, or it raises; and fn_gpu's ms (time_ms, median of 5)."""
    ref = fn_cpu()
    got = fn_gpu()
    err = rel_err(got.cpu(), ref)
    if not err <= rtol:
        raise AssertionError(f"inventory {what}: card vs CPU rel err {err} > {rtol}")
    ms = time_ms(fn_gpu, iters=5, warmup=1)
    log(f"[inventory] {what}: {ms:.3f} ms on the card (CUDA events, median of 5); card vs CPU "
        f"max rel err {err:.2e} (<= {rtol}); shape {tuple(got.shape)}")


def inventory_module_checks():
    """One call each of the generator families at 1024px (channel_multiplier
    2, seeded weights, noise 0.1, b = 1), pSp's and the single-W encoder
    (IR-SE-50, 256px input, 18 styles), ResNetArcFace (128px gray),
    deform_conv2d at an IR-SE 128-channel 64px shape and LPIPS_Loss at
    256px, on the card against the CPU."""
    from ood_gan_inversion_tpu_torch.losses import LPIPS_Loss
    from ood_gan_inversion_tpu_torch.nn.arcface_resnet import ResNetArcFace
    from ood_gan_inversion_tpu_torch.nn.encoders.e4e import (
        BackboneEncoderUsingLastLayerIntoW, GradualStyleEncoder)
    from ood_gan_inversion_tpu_torch.nn.gcfsr import GCFSRGenerator
    from ood_gan_inversion_tpu_torch.nn.layers import init_weights
    from ood_gan_inversion_tpu_torch.nn.stylegan2_gpen import GPENGenerator, NoiseConcat
    from ood_gan_inversion_tpu_torch.ops.deform_conv import deform_conv2d
    g = torch.Generator().manual_seed(SEED + 7)

    def pair(make):
        cpu = init_weights(make(), SEED + 8).eval().requires_grad_(False)
        return cpu, copy.deepcopy(cpu).cuda()

    for name, make in (("GPENGenerator", lambda: GPENGenerator(1024)),
                       ("GCFSRGenerator", lambda: GCFSRGenerator(1024))):
        cpu, gpu = pair(make)
        for net in (cpu, gpu):
            for m in net.modules():
                if isinstance(m, NoiseConcat) or hasattr(m, "noise_weight"):
                    (m.weight if isinstance(m, NoiseConcat) else m.noise_weight).data.fill_(0.1)
        lats = torch.randn(1, cpu.n_latent, 512, generator=g)
        noise = cpu.make_noise(1, g)
        gn, gl = [n.cuda() for n in noise], lats.cuda()
        with torch.no_grad():
            hold_on_card(f"{name} (1024px)", lambda: cpu(lats, noise), lambda: gpu(gl, gn),
                         INVENTORY_NET_RTOL)
        del cpu, gpu
    x = torch.rand(1, 3, 256, 256, generator=g) * 2 - 1
    for name, make in (("GradualStyleEncoder", lambda: GradualStyleEncoder(50, "ir_se", 1024)),
                       ("BackboneEncoderUsingLastLayerIntoW",
                        lambda: BackboneEncoderUsingLastLayerIntoW(50, "ir_se", 1024)),
                       ("ResNetArcFace", lambda: ResNetArcFace())):
        cpu, gpu = pair(make)
        xi = x[:, :1, ::2, ::2].contiguous() if name == "ResNetArcFace" else x
        xg = xi.cuda()
        with torch.no_grad():
            hold_on_card(f"{name} ({tuple(xi.shape)} input)", lambda: cpu(xi),
                         lambda: gpu(xg), INVENTORY_NET_RTOL)
    ops = [torch.randn(2, 128, 64, 64, generator=g), torch.randn(2, 18, 64, 64, generator=g) * 0.7,
           torch.randn(128, 128, 3, 3, generator=g) / 34.0, torch.rand(2, 9, 64, 64, generator=g),
           torch.randn(128, generator=g)]
    gops = [o.cuda() for o in ops]
    hold_on_card("deform_conv2d (2, 128, 64, 64), 3x3, mask + bias",
                 lambda: deform_conv2d(*ops), lambda: deform_conv2d(*gops), INVENTORY_OP_RTOL)
    cpu, gpu = pair(LPIPS_Loss)
    a, b = (torch.rand(2, 256, 256, 3, generator=g) * 2 - 1 for _ in range(2))
    ga, gb = a.cuda(), b.cuda()
    with torch.no_grad():
        hold_on_card("LPIPS_Loss (2, 256, 256, 3)", lambda: cpu(a, b)[0][None],
                     lambda: gpu(ga, gb)[0][None], INVENTORY_OP_RTOL)


def phase_inventory():
    """The options and modules no shipped config uses, on the card: the
    inversion engine with the SAMM bottleneck, ADD and the float32 SAMM
    island (inventory_engine_checks), E4E_Face.yml's train step with the
    bottleneck (phase_training: step 0 and a fused step, B1 4 and 8), and
    the other nets (inventory_module_checks). Returns B1's launches of its
    inversion forwards and train steps."""
    t0 = time.time()
    launches = inventory_engine_checks()
    n, _ = phase_training("E4E_Face.yml", 2, fused_steps=1, reps=2, mod_btn=BTN)
    inventory_module_checks()
    log(f"[inventory] phase took {time.time() - t0:.1f} s")
    return launches + n


# --- several devices: data-parallel training, sharded and banded inversion -----------------
# the 2-rank gloo step on one card against the one-process step on the same
# global batch and draws: the card-against-CPU train bounds (losses within
# TRAIN_LOSS_RTOL relative, gradients within TRAIN_GRAD_RTOL of their
# leaf's scale with TRAIN_NOISE_FLOOR). The D scores are means of
# unit-scale terms that cancel, and l_area is a hinge on a mask mean near
# its target: they are held relative to 1 and to loss_weight x the largest
# area target (5 x 0.3), the size of the terms they subtract
DP_LOG_FLOOR = {"real_score": 1.0, "fake_score": 1.0, "l_area": 1.5}
CHILD_TIMEOUT_S = 420
# invert_spatial against invert at 1024px float32: the slice's bound (the
# banded convolutions see other shapes, so cuDNN may sum in another order)
SPATIAL_RTOL = 1e-3


def run_child(what, cmd, timeout=CHILD_TIMEOUT_S):
    """cmd in a session of its own (killed whole on timeout); raises unless
    it exits 0 and its last line of output is a JSON object with "ok": true.
    Returns that object."""
    import os
    import signal
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{what}: still running after {timeout} s; killed")
    lines = [x for x in out.strip().splitlines() if x.strip()]
    try:
        last = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        last = {}
    if proc.returncode != 0 or last.get("ok") is not True:
        raise AssertionError(f"{what}: exit code {proc.returncode}, last line "
                             f"{lines[-1] if lines else None!r}\n{err[-4000:]}")
    log(f"[dp] {what}: exit 0 in {time.time() - t0:.1f} s")
    return last


def torchrun(n, *args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n), __file__, *args]


def dp_run():
    """E4E_Face.yml's train step at full width (1024px, float32, TF32 off,
    seeded weights, cuDNN's deterministic algorithms) on this process: a
    rank of a process group, or alone. The global batch of 2 (train_batch)
    and one explicit global draw of noise, path cotangent and z; this rank
    takes its rows. Step 0 (R1, path regularization) then a fused step at
    ModSize 256, each with the counts set to 0 just before and read just
    after, and its gradients kept; then one more fused step, timed warm.
    Returns (the logs, B1 launches, ms and gradients of the two steps, the
    warm step's ms, peak memory, every rank's state checksum) and the
    state after the two steps (trainable G, D, the EMA, the path mean), on
    the CPU."""
    from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
    from ood_gan_inversion_tpu_torch.parallel import dist
    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    model = OODFaceGANModel(shipped_train_opt("E4E_Face.yml"), device=device, seed=SEED)
    batch = train_batch(model, 1024, SEED + 2)
    g = torch.Generator().manual_seed(SEED + 6)
    noise = [n.to(device) for n in model.net_g.make_noise(2, g, torch.device("cpu"))]
    cot = (torch.randn(2, 1024, 1024, 3, generator=g) / 1024.0).to(device)
    z = torch.randn(2, 512, generator=g).to(device)
    local = {k: dist.local_rows(v) for k, v in batch.items()}
    grads = recorded_grads(model)
    res = {"logs": [], "b1": [], "ms": [], "grads": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for step in (0, FUSED_STEP):
        reset_counts()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        logs = model.train_step(local, step, noise=noise, path_cot=cot, z=z)
        b.record()
        b.synchronize()
        counts = read_counts()
        if counts != expected_counts(warp_blend=counts["warp_blend"]):
            raise AssertionError(f"data-parallel step {step}: launched {counts}")
        check_train_logs(f"data-parallel step {step}", logs,
                         STEP0_KEYS if step == 0 else FUSED_KEYS)
        res["logs"].append({k: float(v) for k, v in logs.items()})
        res["b1"].append(counts["warp_blend"])
        res["ms"].append(a.elapsed_time(b))
        res["grads"].append(dict(grads))
        grads.clear()
    state = {"g": {k: p.detach().cpu() for k, p in model.train_g.items()},
             "d": {k: p.detach().cpu() for k, p in model.net_d.named_parameters()},
             "ema": {k: v.cpu() for k, v in model.ema.items()},
             "mpl": model.mean_path_length.cpu()}
    res["sums"] = dist.check_replicas(model, device)
    del model._grads                                  # the class's own again
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    model.train_step(local, FUSED_STEP, noise=noise, path_cot=cot, z=z)
    b.record()
    b.synchronize()
    res["warm_ms"] = a.elapsed_time(b)
    res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return res, state


def dp_save(out, res, state, device):
    """dp_run's results: rank 0's into out/rank0.pt and this rank's summary
    (its "ok" line) into out/rank{r}.json; returns the summary."""
    import os
    from ood_gan_inversion_tpu_torch.parallel import dist
    os.makedirs(out, exist_ok=True)
    if dist.is_main():
        torch.save({"res": res, "state": state}, f"{out}/rank0.pt")
    summary = {"ok": True, "rank": dist.rank(), "world": dist.world_size(),
               "backend": torch.distributed.get_backend() if dist.active() else "none",
               "device": str(device),
               **{k: res[k] for k in ("b1", "ms", "warm_ms", "peak_gib", "sums")}}
    with open(f"{out}/rank{dist.rank()}.json", "w") as f:
        json.dump(summary, f)
    return summary


DP_RUNS = {"none": "a", "nccl": "b", "gloo": "c"}


def dp_worker(out, backend, pipeline_root=None):
    """A process of phase_data_parallel (started by torchrun): dp_run alone
    with no group (backend "none", run (a)), or as a rank of a group on
    `backend` ("nccl", (b); "gloo", (c)); dp_save writes it into
    out/<run>. Given pipeline_root, the group's ranks then run
    pipeline_dp_rank there."""
    import gc
    from ood_gan_inversion_tpu_torch.parallel import dist
    device = (torch.device("cuda", torch.cuda.current_device()) if backend == "none"
              else dist.init_from_env("cuda", backend=backend))
    summary = dp_save(f"{out}/{DP_RUNS[backend]}", *dp_run(), device)
    if pipeline_root is not None:
        gc.collect()
        torch.cuda.empty_cache()
        pipeline_dp_rank(pipeline_root)
    if dist.active():
        dist.barrier()
        torch.distributed.destroy_process_group()
    if summary["rank"] == 0:        # one line: the ranks share torchrun's stdout
        print(json.dumps(summary), flush=True)
    return 0


def dp_compare(ref, got):
    """(max relative log error, max gradient error over its scale, the
    leaf at it, whether logs, gradients and state are bit for bit) of
    run `got` against the reference run `ref` (dp_run's results)."""
    (rres, rstate), (gres, gstate) = ref, got
    log_err, grad_err, worst, same = 0.0, 0.0, None, True
    for rl, gl in zip(rres["logs"], gres["logs"]):
        if set(rl) != set(gl):
            raise AssertionError(f"logged {sorted(gl)}, the reference {sorted(rl)}")
        for k, v in rl.items():
            same &= gl[k] == v
            log_err = max(log_err, abs(gl[k] - v) / max(abs(v), DP_LOG_FLOOR.get(k, 0.0), 1e-12))
    for rg, gg in zip(rres["grads"], gres["grads"]):
        top = max(float(v.abs().max()) for v in rg.values())
        for k, r in rg.items():
            same &= torch.equal(gg[k], r)
            scale = max(float(r.abs().max()), TRAIN_NOISE_FLOOR * top)
            e = float((gg[k] - r).abs().max()) / scale if scale > 0 else 0.0
            if e > grad_err:
                grad_err, worst = e, k
    for part in ("g", "d", "ema"):
        same &= all(torch.equal(gstate[part][k], v) for k, v in rstate[part].items())
    same &= torch.equal(gstate["mpl"], rstate["mpl"])
    return log_err, grad_err, worst, bool(same)


def dp_ranks(out, n):
    """The rank summaries (dp_save) in out, in rank order, and rank 0's
    results and state."""
    ranks = [json.load(open(f"{out}/rank{r}.json")) for r in range(n)]
    got = torch.load(f"{out}/rank0.pt", weights_only=False)
    return (got["res"], got["state"]), ranks


def phase_data_parallel():
    """E4E_Face.yml's train step at full width (dp_run: global b = 2, step 0
    and a fused step) three ways, each in fresh processes started by
    torchrun (dp_worker; so (a) and (b) run in the same environment), one
    after another: (a) one process, no group (the reference); (b) torchrun
    --nproc_per_node 1 on NCCL, which must equal (a) bit for bit; (c) two
    gloo ranks sharing this card, 1 sample each, within the
    card-against-CPU train bounds of (a), the replicas bit for bit. B1's
    launches per process and step must be the one-process counts
    (train_b1: every rank runs every phase). The ranks of (c) then run
    train_pipeline (pipeline_dp_rank, checked by check_pipeline_dp).
    Returns B1's launches in (a), (b) and (c), and in the pipeline run."""
    import os
    import shutil
    import tempfile
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="ogi_dp_")
    try:
        pipe = f"{root}/pipeline"
        write_face_pngs(f"{pipe}/train", 4, SEED + 24)
        write_face_pngs(f"{pipe}/val", 1, SEED + 25)
        run_child("(a) one process, no group", torchrun(1, "--dp-worker", root, "none"))
        run_child("(b) torchrun, 1 rank, NCCL", torchrun(1, "--dp-worker", root, "nccl"))
        run_child("(c) torchrun, 2 gloo ranks on one card, then train_pipeline on them",
                  torchrun(2, "--dp-worker", root, "gloo", pipe))
        want = [train_b1(2)[0], train_b1(2)[FUSED_STEP]]
        launches, runs = 0, {}
        for key, name, n, backend in (
                ("a", "(a) one process, no group", 1, "none"),
                ("b", "(b) torchrun, 1 rank, NCCL", 1, "nccl"),
                ("c", "(c) torchrun, 2 gloo ranks on one card", 2, "gloo")):
            runs[key] = dp_ranks(f"{root}/{key}", n)
            for s in runs[key][1]:
                if s["world"] != n or s["backend"] != backend or s["b1"] != want:
                    raise AssertionError(f"{name} rank {s['rank']}: world {s['world']}, backend "
                                         f"{s['backend']}, B1 {s['b1']} (expected {want})")
                launches += sum(s["b1"])
                log(f"[dp] {name}, rank {s['rank']} on {s['device']}: step 0 {s['ms'][0]:.2f} "
                    f"ms (the process's first), fused {s['ms'][1]:.2f} ms (both recording "
                    f"gradients), warm fused step {s['warm_ms']:.2f} ms; peak memory "
                    f"{s['peak_gib']:.2f} GiB; B1 {s['b1']} per step")
        ref = runs["a"][0]
        log(f"[dp] (a) logs {ref[0]['logs'][1]}")
        errs = dp_compare(ref, runs["b"][0])
        if not errs[3]:
            raise AssertionError(f"(b) NCCL world size 1 is not (a) bit for bit: {errs}")
        log(f"[dp] (b) against (a): losses, {len(ref[0]['grads'][0])} + "
            f"{len(ref[0]['grads'][1])} gradients, trainable G, D, EMA and path mean bit for bit")
        log_err, grad_err, worst, _ = dp_compare(ref, runs["c"][0])
        if not (log_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"(c) against (a): logs {log_err}, gradient {worst} {grad_err}")
        ranks = runs["c"][1]
        sums = {tuple(s["sums"]) for s in ranks}
        if len(sums) != 1 or len(set(next(iter(sums)))) != 1:
            raise AssertionError(f"(c) the replicas' checksums differ: {sums}")
        log(f"[dp] (c) against (a): logs within {log_err:.2e} relative (<= {TRAIN_LOSS_RTOL}), "
            f"gradients within {grad_err:.2e} of their scale (<= {TRAIN_GRAD_RTOL}, largest at "
            f"{worst}); both replicas' states bit for bit (checksum {ranks[0]['sums'][0]}). "
            f"Gloo stages every collective through the host, so (c)'s times are not a "
            f"multi-card figure")
        pipeline_launches = check_pipeline_dp(pipe)
        log(f"[dp] phase took {time.time() - t_phase:.1f} s")
        return launches, pipeline_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def pipeline_dp_rank(root):
    """This rank of a gloo group (dp_worker's (c)) runs
    `train.train_pipeline` (what `python -m torch.distributed.run
    --nproc_per_node N -m ood_gan_inversion_tpu_torch.run_train` runs) on
    E4E_Face.yml at ModSize 256 over root's PNGs into root/exp, 2
    iterations, a validation of 1 image and a save at the end; the
    checkpoint files this rank wrote, its B1 launches and the replicas'
    checksums into root/rank{r}.json."""
    from ood_gan_inversion_tpu_torch.parallel import dist
    from ood_gan_inversion_tpu_torch.train import train_pipeline
    from ood_gan_inversion_tpu_torch.utils import checkpoint as ckpt
    writes, save_file = [], ckpt.save_file

    def spy(tree, path, retry=3):
        writes.append(path)
        return save_file(tree, path, retry)

    ckpt.save_file = spy
    argv = ["--opt", "options/train/E4E_Face.yml", "--device", "cuda", "--force_yml",
            f"datasets:train:dataroot_gt_list=[{root}/train]",
            f"datasets:val:dataroot_gt={root}/val",
            "path:pretrain_network_g=~", "path:pretrain_network_d=~",
            f"path:experiments_root={root}/exp", "train:total_iter=2", "val:val_freq=1000",
            "logger:print_freq=1", "logger:save_checkpoint_freq=1000", "network_g:ModSize=256"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_pipeline(".", args=argv)
    torch.cuda.synchronize()
    summary = {"rank": dist.rank(), "world": dist.world_size(),
               "backend": torch.distributed.get_backend(), "writes": writes,
               "iters": [run.start_iter, run.current_iter],
               "b1": read_counts()["warp_blend"], "iter_ms": 1e3 * run.iter_time,
               "save_s": run.save_seconds, "val_s": run.val_seconds,
               "val": {k: float(v) for k, v in run.val_results.items()},
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "sums": dist.check_replicas(run.model, run.model.device)}
    with open(f"{root}/rank{dist.rank()}.json", "w") as f:
        json.dump(summary, f)


def check_pipeline_dp(root):
    """pipeline_dp_rank's runs on 2 gloo ranks sharing this card (E4E_Face.yml
    at full width, 2 samples per rank, over 4 train PNGs): only rank 0
    wrote checkpoints; the replicas' checksums agree; B1 launched per rank
    as the curriculum gives (rank 0 also validates). Returns B1's
    launches."""
    import os
    ranks = [json.load(open(f"{root}/rank{r}.json")) for r in range(2)]
    # 2 fused steps per rank; rank 0 also validates 1 image (one forward
    # at ModSize 256, as many launches as a fused step)
    per = train_b1(2)[FUSED_STEP]
    want = [3 * per, 2 * per]
    for s, b1 in zip(ranks, want):
        if s["world"] != 2 or s["backend"] != "gloo" or s["iters"] != [0, 2]:
            raise AssertionError(f"pipeline rank {s['rank']}: {s}")
        if s["b1"] != b1:
            raise AssertionError(f"pipeline rank {s['rank']}: B1 {s['b1']}, expected {b1}")
    names = sorted(os.path.basename(w) for w in ranks[0]["writes"])
    if names != ["net_2.pth", "state_2.pth"] or ranks[1]["writes"]:
        raise AssertionError(f"pipeline writes: rank 0 {ranks[0]['writes']}, rank 1 "
                             f"{ranks[1]['writes']}")
    for f in ("models/net_2.pth", "training_states/state_2.pth"):
        if not os.path.isfile(f"{root}/exp/{f}"):
            raise AssertionError(f"pipeline: checkpoint {f} missing")
    if ranks[0]["sums"] != ranks[1]["sums"] or len(set(ranks[0]["sums"])) != 1:
        raise AssertionError(f"pipeline: the replicas differ: {ranks[0]['sums']}")
    for s in ranks:
        log(f"[dp] train_pipeline rank {s['rank']} of 2 (gloo, one card, 2 samples each): "
            f"iterations 1..2, B1 launched {s['b1']}, host clock {s['iter_ms']:.1f} "
            f"ms/iteration, checkpoint saves {[round(x, 2) for x in s['save_s']]} s, "
            f"validation {[round(x, 2) for x in s['val_s']]} s, peak memory "
            f"{s['peak_gib']:.2f} GiB, metrics {s['val']}")
    log(f"[dp] train_pipeline on 2 ranks: only rank 0 wrote ({names}); the replicas' "
        f"checksums agree ({ranks[0]['sums'][0]}); gloo stages through the host, so these "
        f"times are not a multi-card figure")
    return sum(s["b1"] for s in ranks)


def differing_outputs(a, b):
    """The keys of output dicts a and b whose tensors (aligns key by key)
    are not bit for bit equal."""
    bad = [k for k in ("image", "gen_image", "mask", "lats") if not torch.equal(a[k], b[k])]
    return bad + [f"aligns[{k}]" for k in a["aligns"]
                  if not torch.equal(a["aligns"][k], b["aligns"][k])]


def phase_sharded(engines, imgs):
    """The data-sharded entries on meshes of 2 and 4 slots on this card, on
    the float32 and bfloat16 engines of the main path:
    invert_batch_perkey_sharded at b = 4 and 8 and invert_batch_sharded at
    b = 4, each bit for bit against the unsharded call (on a difference,
    tests/torch_slots.py names the ops behind it), with the counts set to 0
    just before and read just after (B1: 8 per slot's forward); ms/img
    beside the unsharded call's. Then the bfloat16 BatchingServer(mesh=)
    with 4 clients: every reply the direct per-seed inversion's, the
    padded count what the mesh's rounding gives. Returns B1's launches."""
    import asyncio
    from ood_gan_inversion_tpu_torch.parallel import make_mesh
    from ood_gan_inversion_tpu_torch.serve import BatchingServer
    t_phase = time.time()
    launches = 0

    def timed(fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    for dt, eng in engines.items():
        for n in (2, 4):
            mesh = make_mesh(["cuda:0"] * n)
            for b in (4, 8):
                ims, seeds = [imgs[i % len(imgs)] for i in range(b)], list(range(b))
                ref, ms_ref = timed(lambda: eng.invert_batch_perkey(ims, seeds))
                reset_counts()
                got, ms = timed(lambda: eng.invert_batch_perkey_sharded(ims, seeds, mesh))
                counts = read_counts()
                if counts != expected_counts(warp_blend=8 * n, **fused_body0(eng, forwards=n)):
                    raise AssertionError(f"sharded {dt} n={n} b={b}: launched {counts}")
                launches += counts["warp_blend"]
                bad = differing_outputs(got, ref)
                if bad:
                    sys.path.insert(0, "tests")
                    from torch_slots import batch_dependent_ops
                    raise AssertionError(f"sharded {dt} n={n} b={b}: {bad} differ from the "
                                         f"unsharded call; batch-dependent ops: "
                                         f"{batch_dependent_ops(eng)}")
                log(f"[sharded] {dt} invert_batch_perkey_sharded, {n} slots on cuda:0, b = {b}: "
                    f"bit for bit the unsharded call; B1 {counts['warp_blend']}; "
                    f"{ms / b:.2f} ms/img against {ms_ref / b:.2f} unsharded (CUDA events, one "
                    f"call each; the slots share one card, so they run one after another)")
            ims = [imgs[i % len(imgs)] for i in range(4)]
            ref = eng.invert_batch(ims, seed=5)
            reset_counts()
            got = eng.invert_batch_sharded(ims, seed=5, mesh=mesh)
            torch.cuda.synchronize()
            launches += read_counts()["warp_blend"]
            bad = differing_outputs(got, ref)
            if bad:
                raise AssertionError(f"invert_batch_sharded {dt} n={n}: {bad} differ")
            log(f"[sharded] {dt} invert_batch_sharded, {n} slots, b = 4: bit for bit "
                f"invert_batch")
    eng = engines["bfloat16"]
    srv = BatchingServer(eng, max_batch=8, max_wait_ms=50.0, mesh=make_mesh(["cuda:0"] * 4))
    reqs = [imgs[i % len(imgs)] for i in range(4)]

    async def clients():
        await srv.start()
        outs = await asyncio.gather(*[srv.invert(im) for im in reqs])
        await srv.stop()
        return outs

    reset_counts()
    outs = asyncio.run(clients())
    launches += read_counts()["warp_blend"]
    st = srv.stats
    if st["requests"] != 4 or st["split"] or st["padded"] != 4 * st["batches"] - 4:
        raise AssertionError(f"sharded server stats {st}")
    for i, (im, (image, mask)) in enumerate(zip(reqs, outs)):
        ref = eng.invert(im, seed=0)
        if not (np.array_equal(image, ref["image"][0].float().cpu().numpy())
                and np.array_equal(mask, ref["mask"][0].float().cpu().numpy())):
            raise AssertionError(f"sharded server reply {i} is not the direct inversion")
    log(f"[sharded] bfloat16 BatchingServer(mesh of 4 slots on cuda:0), 4 clients: every reply "
        f"bit for bit the direct per-seed inversion; stats {st}")
    log(f"[sharded] phase took {time.time() - t_phase:.1f} s")
    return launches


def spatial_timed(fn, reps=3):
    """(fn()'s result, median ms of `reps` more calls), CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return out, float(np.median(times))


def phase_spatial(engine, imgs, tails, bf16s):
    """invert_spatial at 1024px on 2 and 4 slots on this card against
    invert of the same engine (the same seed's noise), within SPATIAL_RTOL
    of max|ref|, float32 and bfloat16 alike; ms/img beside invert's (the bands share one
    card and run one after another); B1 launched 8 per image (SAMM is not
    banded). The engines: the default at min_h 512 (the 512 and 1024px
    stages banded), at min_h 256 (the 256px SAMM stage whole, its output
    banded) and at min_h 128 (the 128px SAMM stage's output banded, then
    gathered into the 256px SAMM stage); the packed tail through B3
    ("pair": 2 launches per packed stage per band) and B4 ("stage": 1) in
    float32 and bfloat16 at min_h 512, each band on its window of coarse
    rows. Returns the launches of B1, B3 and B4."""
    from ood_gan_inversion_tpu_torch.parallel import make_mesh
    t_phase = time.time()
    launches = dict.fromkeys(("warp_blend", "fused_conv3x3_act", "fused_packed_stage"), 0)
    runs = [("default", engine, 512, {}), ("default", engine, 256, {}),
            ("default", engine, 128, {}),
            ("packed tail pair", tails["packed tail pair"], 512, {"fused_conv3x3_act": 4}),
            ("packed tail stage", tails["packed tail stage"], 512, {"fused_packed_stage": 2}),
            ("bf16 packed tail pair", bf16s["bf16 packed tail pair"], 512,
             {"fused_conv3x3_act": 4}),
            ("bf16 packed tail stage", bf16s["bf16 packed tail stage"], 512,
             {"fused_packed_stage": 2})]
    for label, eng, min_h, per_band in runs:
        ref, ms_ref = spatial_timed(lambda: eng.invert(imgs[0], seed=7))
        for n in (2, 4):
            mesh = make_mesh(["cuda:0"] * n, axes=("sp",))
            reset_counts()
            out = eng.invert_spatial(imgs[0], seed=7, mesh=mesh, min_h=min_h)
            torch.cuda.synchronize()
            counts = read_counts()
            want = expected_counts(warp_blend=8, **fused_body0(eng),
                                   **{k: v * n for k, v in per_band.items()})
            if counts != want:
                raise AssertionError(f"invert_spatial {label} n={n} min_h {min_h}: launched "
                                     f"{counts}, expected {want}")
            for k in launches:
                launches[k] += counts[k]
            errs = {k: rel_err(out[k], ref[k]) for k in ("image", "gen_image", "mask")}
            if not max(errs.values()) <= SPATIAL_RTOL:
                raise AssertionError(f"invert_spatial {label} n={n} min_h {min_h} against "
                                     f"invert: {errs}")
            text = (f"rel err {errs} (<= {SPATIAL_RTOL}; bit for bit: "
                    f"{differing_outputs(out, ref) == []})")
            _, ms = spatial_timed(lambda: eng.invert_spatial(imgs[0], seed=7, mesh=mesh,
                                                             min_h=min_h))
            log(f"[spatial] invert_spatial {label}, {n} bands on cuda:0, min_h {min_h}, 1024px: "
                f"against invert {text}; launches {{{', '.join(f'{k}: {v}' for k, v in counts.items() if v)}}}; "
                f"{ms:.2f} ms/img against invert's {ms_ref:.2f} (CUDA events, median of 3; "
                f"bands on one card run one after another)")
    log(f"[spatial] phase took {time.time() - t_phase:.1f} s")
    return launches


# the banded train step against the unbanded one on the same state and
# draws: the bands' sums run in another order, as the data-parallel ranks'
# do, so the logs within 1e-4 relative (over DP_LOG_FLOOR for the scores and
# the area hinge, which cancel) and every gradient within 1e-3 of
# max(its leaf's max|ref|, TRAIN_NOISE_FLOOR of its net's largest)
BANDED_LOSS_RTOL, BANDED_GRAD_RTOL = 1e-4, 1e-3


def phase_banded_training(reps=2):
    """options/train/E4E_Face.yml's train step at full width (b = 2,
    float32, step 0: R1 and the path regularizer's double backward through
    the bands) inside spatial.banding over 2 slots of this card at min_h
    512 (the 512 and 1024px stages banded), against the same step
    unbanded from the same state with the same draws; then each timed
    (median of `reps` further steps) with its peak memory."""
    from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
    from ood_gan_inversion_tpu_torch.parallel import Replicas, make_mesh, spatial
    t_phase = time.time()
    models = [OODFaceGANModel(e4e_train_opt(), device="cuda", seed=SEED) for _ in range(2)]
    batch = train_batch(models[0], 1024, SEED + 2)
    train_batch(models[1], 1024, SEED + 2)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    draws = {"noise": models[0].net_g.make_noise(2, g, torch.device("cuda")),
             "path_cot": torch.randn((2, 1024, 1024, 3), generator=g, device="cuda") / 1024.0,
             "z": torch.randn((2, 512), generator=g, device="cuda")}
    mesh = make_mesh(["cuda:0"] * 2, axes=("sp",))
    results = {}
    for label, model in (("unbanded", models[0]), ("banded", models[1])):
        grads = recorded_grads(model)
        ctx = (spatial.banding(mesh, Replicas(model.net_g, model.device), 512)
               if label == "banded" else contextlib.nullcontext())
        with ctx:
            logs = model.train_step(batch, 0, **draws)
            torch.cuda.synchronize()
            check_train_logs(f"{label} train step 0", logs, STEP0_KEYS)
            results[label] = ({k: float(v) for k, v in logs.items()}, dict(grads))
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(reps):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                model.train_step(batch, 0, **draws)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
        log(f"[spatial] E4E_Face.yml train step 0 {label}"
            f"{' (2 bands, min_h 512)' if label == 'banded' else ''}: "
            f"median {float(np.median(times)):.2f} ms/step, all {[round(t, 2) for t in times]} "
            f"(CUDA events, b = 2, 1024px, float32); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    (rl, rg), (gl, gg) = results["unbanded"], results["banded"]
    log_err = max(abs(gl[k] - v) / max(abs(v), DP_LOG_FLOOR.get(k, 0.0), 1e-12)
                  for k, v in rl.items())
    grad_err, worst = 0.0, None
    for net in ("net_g", "net_d", "net_d2"):
        leaves = {k: v for k, v in rg.items() if k.startswith(net)}
        if not leaves:
            continue
        top = max(float(v.abs().max()) for v in leaves.values())
        for k, r in leaves.items():
            scale = max(float(r.abs().max()), TRAIN_NOISE_FLOOR * top)
            e = float((gg[k] - r).abs().max()) / scale if scale > 0 else 0.0
            if e > grad_err:
                grad_err, worst = e, k
    if set(gg) != set(rg) or not (log_err <= BANDED_LOSS_RTOL and grad_err <= BANDED_GRAD_RTOL):
        raise AssertionError(f"banded train step against unbanded: logs {log_err}, gradients "
                             f"{grad_err} at {worst}")
    log(f"[spatial] banded train step 0 against unbanded: logs within {log_err:.2e} "
        f"(<= {BANDED_LOSS_RTOL}), {len(rg)} gradients within {grad_err:.2e} of their scale "
        f"(<= {BANDED_GRAD_RTOL}; worst {worst}); phase took {time.time() - t_phase:.1f} s")
    del models
    torch.cuda.empty_cache()


def phase_band_gradients():
    """A band on another device sends its gradients to the trained
    parameters: a micro E4E arch (64px, a quarter of the widths) on the
    card decodes inside spatial.banding over the slots ["cuda:0", "cpu"]
    at min_h 32 (the 64px stage's second band on the CPU); the gradients
    of a loss of its image, with a gradient of the latents' gradient, w.r.t.
    the generator's parameters on the card against the unbanded decode's,
    within 1e-4 of max|ref|; and the same bands on the CPU replica (a deep
    copy) miss them."""
    from ood_gan_inversion_tpu_torch.archs import build_network
    from ood_gan_inversion_tpu_torch.nn.layers import init_weights
    from ood_gan_inversion_tpu_torch.parallel import Replicas, make_mesh, spatial
    t_phase = time.time()
    with torch.device("cuda"):
        arch = build_network({"type": "ood_faceGAN_e4e", "out_size": 64, "channel_multiplier": 1,
                              "narrow": 0.25, "encoder_num_layers": 4, "cycle_align": 2,
                              "warp_scale": 0.08})
    init_weights(arch, SEED).eval()
    gen = torch.Generator().manual_seed(SEED)
    x = (torch.rand(1, 3, 64, 64, generator=gen) * 2 - 1).cuda()
    noise = [n.cuda() for n in arch.make_noise(1, gen, torch.device("cpu"))]
    cot = torch.randn(1, 3, 64, 64, generator=gen).cuda()
    with torch.no_grad():
        lats0, feats = arch.encode(x, noise=arch.split_noise(noise)[0])
    params = list(arch.generator.parameters())
    mesh = make_mesh(["cuda:0", "cpu"], axes=("sp",))

    def grads(banded):
        lats = lats0.clone().requires_grad_()
        ctx = spatial.banding(mesh, Replicas(arch, "cuda"), 32) if banded else \
            contextlib.nullcontext()
        with ctx:
            img = arch.decode_samm(lats, feats, x, 32, arch.split_noise(noise)[1])["image"]
        (gl,) = torch.autograd.grad(img, lats, cot, create_graph=True)
        loss = (img * cot).sum() + gl.square().sum()
        return torch.autograd.grad(loss, params, allow_unused=True)

    ref = grads(False)
    got = grads(True)
    if any(g is not None and g.device.type != "cuda" for g in got):
        raise AssertionError("band gradients: a gradient left the card")
    err = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)
              if r is not None and r.abs().max() > 0)
    if not err <= 1e-4:
        raise AssertionError(f"band gradients on ['cuda:0', 'cpu'] against unbanded: {err}")
    twin = spatial._State.twin
    spatial._State.twin = lambda st, m, dev: (m if dev == st.slots[0] else st.replicas.get(dev)
                                              .get_submodule(st._names[id(m)]))
    try:
        copies = grads(True)
    finally:
        spatial._State.twin = twin
    miss = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(copies, ref)
               if r is not None and r.abs().max() > 0)
    if not miss > 0.1:
        raise AssertionError(f"band gradients through the CPU replica should miss: {miss}")
    log(f"[spatial] bands on ['cuda:0', 'cpu'] (micro E4E, min_h 32): generator gradients, "
        f"grad-of-grad included, within {err:.2e} of the unbanded decode's (<= 1e-4); through "
        f"the CPU replica instead they miss by {miss:.2f}; took {time.time() - t_phase:.1f} s")


# the bfloat16-operand SAMM options (nn/samm.py) on the float32 engine: per
# forward, B1 through warp_blend (some targets cast to bfloat16) or, with
# samm_gather_bf16, through warp_blend_taps_bf16
SAMM_BF16_OPTIONS = (
    ("samm_conv_bf16", {"samm_conv_bf16": True}, {"warp_blend": 8}, 0),
    ("samm_warp_bf16 fit", {"samm_warp_bf16": "fit"}, {"warp_blend": 8}, 2),
    ("samm_warp_bf16 all", {"samm_warp_bf16": "all"}, {"warp_blend": 8}, 4),
    ("samm_gather_bf16", {"samm_gather_bf16": True}, {"warp_blend_taps_bf16": 8}, 0))


def phase_samm_bf16(engine, imgs):
    """Each bfloat16-operand SAMM option on the 1024px float32 engine's
    weights: launches (B1 8 per forward, and how many of its targets are
    bfloat16: the 128px scale's two with "fit", the 128 and 256px ones'
    four with "all"), the reply against the default engine's within JAX's
    island bound (bf16_compare on image and mask; the options are small
    bfloat16 islands) and not equal to it, ms/img; then, at the small
    config of phase_small_reference, the card against the CPU with the
    same option (within the same bound: the options round values to
    bfloat16, and a float32 difference that crosses a rounding boundary
    moves a value by a whole step, which the align cycles carry on), the
    warp cast's floor lowered to 32px so that the 32px block (C 128) casts,
    "fit" at the full width of the 1024px model's 32px scale (narrow 1.0:
    C 512, whose float32 window does not fit), the others at a quarter of
    it (C 128). Returns warp_blend_taps_bf16's launches on the 1024px
    engine."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.nn import samm
    t_phase = time.time()
    params = engine.net.state_dict()
    ref, ms_ref = spatial_timed(lambda: engine.invert(imgs[0], seed=7))
    taps_launches = 0
    for label, kwargs, per_fwd, n_bf16 in SAMM_BF16_OPTIONS:
        eng = InversionEngine(e4e_opt(), params=params, device="cuda", **kwargs)
        eng.invert(imgs[0], seed=7)
        torch.cuda.synchronize()
        seen, restore = record_b1_dtypes()
        try:
            reset_counts()
            out = eng.invert(imgs[0], seed=7)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            restore()
        if (counts != expected_counts(**per_fwd, **fused_body0(eng, kwargs))
                or seen.count(torch.bfloat16) != n_bf16):
            raise AssertionError(f"{label}: launched {counts}, B1 targets {seen}")
        taps_launches += counts["warp_blend_taps_bf16"]
        if differing_outputs(out, ref) == []:
            raise AssertionError(f"{label}: the reply equals the default engine's")
        text = bf16_compare(f"{label} vs default", out, ref, ("image", "mask"))[1]
        _, ms = spatial_timed(lambda: eng.invert(imgs[0], seed=7))
        log(f"[samm bf16] {label}, 1024px float32: launches {{{', '.join(f'{k}: {v}' for k, v in counts.items() if v)}}} "
            f"({n_bf16} bfloat16 B1 targets); against the default engine {text}; {ms:.2f} ms/img "
            f"against the default's {ms_ref:.2f} (CUDA events, median of 3)")
        del eng
    x = torch.from_numpy(np.random.RandomState(SEED + 1).rand(1, 512, 512, 3)
                         .astype(np.float32) * 2.0 - 1.0)
    floor, samm.WARP_BF16_MIN = samm.WARP_BF16_MIN, 32
    try:
        for label, kwargs, per_fwd, _ in SAMM_BF16_OPTIONS:
            case = e4e_opt(out_size=512, channel_multiplier=1, encoder_num_layers=4,
                           narrow=1.0 if "fit" in label else 0.25)
            small = noisy(InversionEngine(case, seed=SEED + 1, device="cuda")).net.state_dict()
            gpu = InversionEngine(case, params=small, device="cuda", **kwargs)
            cpu = cpu_twin(gpu, case, small, **kwargs)
            noise = cpu.net.generator.make_noise(
                1, torch.Generator().manual_seed(3), torch.device("cpu"))
            with torch.inference_mode():
                cref = cpu.net(x, mod_size=256, noise=noise)
                reset_counts()
                out = gpu.net(x.cuda(), mod_size=256, noise=[n.cuda() for n in noise])
                torch.cuda.synchronize()
                counts = read_counts()
            if counts != expected_counts(**per_fwd, **fused_body0(gpu, kwargs)):
                raise AssertionError(f"small slice {label}: launched {counts}")
            text = bf16_compare(f"small slice {label}, card vs CPU", out,
                                {k: cref[k].cuda() for k in ("image", "gen_image", "mask",
                                                             "lats")})[1]
            errs = {k: rel_err(out[k], cref[k].cuda()) for k in ("image", "gen_image", "mask")}
            log(f"[samm bf16] small slice (512px, {label}): card vs CPU max rel err "
                f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())}; {text}")
        fit_conditioning()
    finally:
        samm.WARP_BF16_MIN = floor
    log(f"[samm bf16] phase took {time.time() - t_phase:.1f} s")
    return taps_launches


# fit_conditioning's nudge of the input: NUDGE of itself, from these seeds
NUDGE, NUDGE_SEEDS = 1e-6, (100, 101, 102)


def fit_conditioning():
    """The readings behind the small slice's configuration of
    samm_warp_bf16="fit": "fit" at warp_scale 0.75, where the quarter-width
    32px block casts (C 128, a flow bound of 14 px), at the CPU test's
    configuration (tests/test_torch_samm_bf16.py: 64px, ModSize 64) and at
    the small slice's (512px, ModSize 256, where the 64px block casts too).
    Each reading is max|diff| / max|ref| of image, gen_image and mask: the
    card against the CPU; the card against a CPU whose B1 computes the
    bilinear sample of a bfloat16 target in float32 on the bfloat16 taps,
    as JAX's TPU kernel does (the card's kernel and its plain version round
    the weights, products and sums to bfloat16, as JAX's reference does);
    and how far each device's own
    output moves when its input moves by NUDGE of itself, the most over
    NUDGE_SEEDS. Holds the outputs finite; the caller lowers the cast's
    floor to 32px."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.nn import samm
    from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend_reference
    keys = ("image", "gen_image", "mask")
    real = samm.warp_blend

    def tpu_arithmetic(target, grid, alpha):
        if target.dtype == torch.bfloat16:
            return warp_blend_reference(target.float(), grid, alpha).to(target.dtype)
        return real(target, grid, alpha)

    def rel(a, b):
        return {k: rel_err(a[k], b[k]) for k in keys}

    def worst(errs):
        return {k: max(e[k] for e in errs) for k in keys}

    def text(errs):
        return ", ".join(f"{k} {v:.2e}" for k, v in errs.items())

    for size, mod_size in ((64, 64), (512, 256)):
        t0 = time.time()
        case = e4e_opt(out_size=size, channel_multiplier=1, encoder_num_layers=4,
                       narrow=0.25, warp_scale=0.75, ModSize=mod_size)
        params = noisy(InversionEngine(case, seed=SEED + 1, device="cuda")).net.state_dict()
        engines = {"cuda": InversionEngine(case, params=params, device="cuda",
                                           samm_warp_bf16="fit")}
        engines["cpu"] = cpu_twin(engines["cuda"], case, params, samm_warp_bf16="fit")
        noise = engines["cpu"].net.generator.make_noise(
            1, torch.Generator().manual_seed(3), torch.device("cpu"))
        x = torch.from_numpy(np.random.RandomState(SEED + 1).rand(1, size, size, 3)
                             .astype(np.float32) * 2.0 - 1.0)

        def run(dev, xx):
            with torch.inference_mode():
                out = engines[dev].net(xx.to(dev), mod_size=mod_size,
                                       noise=[n.to(dev) for n in noise])
            out = {k: out[k].float().cpu() for k in keys}
            if not all(bool(torch.isfinite(v).all()) for v in out.values()):
                raise AssertionError(f"fit conditioning {size}px on {dev}: non-finite output")
            return out

        base = {d: run(d, x) for d in ("cuda", "cpu")}
        samm.warp_blend = tpu_arithmetic
        try:
            cpu_tpu = run("cpu", x)
        finally:
            samm.warp_blend = real
        spread = {}
        for d in ("cuda", "cpu"):
            nudged = []
            for seed in NUDGE_SEEDS:
                g = torch.Generator().manual_seed(seed)
                nudged.append(rel(run(d, x * (1.0 + NUDGE * torch.randn(x.shape, generator=g))),
                                  base[d]))
            spread[d] = worst(nudged)
        log(f"[samm bf16] fit conditioning ({size}px, ModSize {mod_size}, narrow 0.25, "
            f"warp_scale 0.75), max|diff| / max|ref|: card vs CPU {text(rel(base['cuda'], base['cpu']))}; "
            f"card vs CPU with B1's bfloat16 sample in float32 (JAX's TPU kernel's "
            f"arithmetic) {text(rel(base['cuda'], cpu_tpu))}; card's own output under a {NUDGE:g} nudge "
            f"of the input (worst of {len(NUDGE_SEEDS)} seeds) {text(spread['cuda'])}; the "
            f"CPU's {text(spread['cpu'])}; took {time.time() - t0:.1f} s")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; every time below "
        f"is on this card: {smi}")
    import importlib
    import importlib.util
    installed = "[env] installed: " + ", ".join(
        f"{m} {importlib.import_module(m).__version__ if importlib.util.find_spec(m) else 'no'}"
        for m in ("cv2", "PIL", "yaml", "tensorboard")) + f" ({smi})"
    log(installed)
    # plain versions and yardsticks in full float32 (cuDNN defaults to
    # TF32), as InversionEngine sets it for the main path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    dp_launches, pipeline_dp_launches = phase_data_parallel()
    entries = [*phase_kernels(), *phase_packed_kernels(), *phase_samm_kernels()]
    phase_gradients()
    train_launches, train_ms = 0, {}
    for yml, cycle_align in TRAIN_FAMILIES:
        n, train_ms[yml] = phase_training(yml, cycle_align)
        train_launches += n
    phase_train_small_reference()
    phase_banded_training()
    phase_band_gradients()
    pipeline_launches = phase_train_pipeline()
    pipeline_launches += phase_restyle_pipeline(train_ms["ReStyle_Face.yml"][FUSED_STEP])
    test_launches = phase_test_pipeline()
    main_launches, engine, imgs, replies = phase_main_path()
    launches, tails = phase_packed_tail(engine, imgs, replies)
    # B2a and B2b run on the main path: their counts are its own
    launches.update({k: main_launches[k] for k in ("alignnet_conv1", "alignnet_conv2")})
    body0_launches, body0s = phase_samm_body0(engine, imgs, replies)
    launches.update(body0_launches)
    bf16s = phase_bf16(engine, imgs, replies)
    phase_batched({"float32": engine, "bfloat16": bf16s["bf16 default"]}, imgs)
    serving_launches = phase_serving(bf16s["bf16 default"], imgs)
    log(f"[serve] B1 launches behind the server: {serving_launches}")
    sharded_launches = phase_sharded({"float32": engine, "bfloat16": bf16s["bf16 default"]},
                                     imgs)
    spatial_launches = phase_spatial(engine, imgs, tails, bf16s)
    taps_launches = phase_samm_bf16(engine, imgs)
    # B1's launches: this slice's main path, the test_pipeline runs; the
    # E4E_Face.yml train steps and the train_pipeline runs under their own
    # keys. Each path is counted from 0 just before it
    entries[0]["launches"] = test_launches
    entries[0]["test_launches"] = test_launches
    entries[0]["train_launches"] = train_launches
    entries[0]["pipeline_launches"] = pipeline_launches
    entries[0]["dp_launches"] = dp_launches
    entries[0]["pipeline_dp_launches"] = pipeline_dp_launches
    entries[0]["sharded_launches"] = sharded_launches
    entries[0]["spatial_launches"] = spatial_launches["warp_blend"]
    entries[0]["train_launches_per_step"] = {
        yml.split("_")[0]: {"step0": train_b1(c)[0], "fused": train_b1(c)[FUSED_STEP]}
        for yml, c in TRAIN_FAMILIES}
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    conv_bf16 = InversionEngine(e4e_opt(), params=engine.net.state_dict(), device="cuda",
                                samm_conv_bf16=True)
    reps = phase_end_to_end({"default (unpacked tail, body0 fused)": engine, **tails,
                             **body0s, **bf16s,
                             "samm_conv_bf16 (body0 convs on cuDNN in bf16)": conv_bf16}, imgs)
    # the packed-tail engines whose kernels run the TMA core: "pair" (B3)
    # and "stage" (B4) in both dtypes, beside their dtype's default
    log("[main] packed tail on the TMA core, invert ms/img median (spread) of the same rounds: "
        + "; ".join(f"{name} {float(np.median(reps[name])):.2f} ({min(reps[name]):.2f}-"
                    f"{max(reps[name]):.2f})"
                    for name in ("packed tail pair", "packed tail stage",
                                 "default (unpacked tail, body0 fused)",
                                 "bf16 packed tail pair", "bf16 packed tail stage",
                                 "bf16 default")))
    log("[main] body0 routes, invert ms/img median (spread) of the same rounds: "
        + "; ".join(f"{name} {float(np.median(reps[name])):.2f} ({min(reps[name]):.2f}-"
                    f"{max(reps[name]):.2f})"
                    for name in ("default (unpacked tail, body0 fused)", "body0 algebraic",
                                 "body0 literal + B5")))
    del conv_bf16
    launches["warp_blend_taps_bf16"] = taps_launches
    for e in entries[1:]:
        e["launches"] = launches[e["name"]]
    for e in entries:
        if e["name"] in ("fused_conv3x3_act", "fused_packed_stage"):
            e["spatial_launches"] = spatial_launches[e["name"]]
    phase_small_reference()
    phase_family_small_reference()
    entries[0]["inventory_launches"] = phase_inventory()
    entries.append(phase_probe())
    log(installed)
    log(smi)
    # bound_ms is the tensor-core bound of a conv kernel; cc_bound_ms the
    # CUDA-core one (for B1 and the probe, which use no tensor cores, the same)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "cc_bound_ms")
    for e in entries:
        e.setdefault("cc_bound_ms", e["bound_ms"])
    extra = ("bf16_ms", "bf16_bound_ms", "bf16_library_ms", "bf16_source", "serves",
             "f32_core", "bf16_core", "repack_ms", "bf16_repack_ms",
             "test_launches",
             "train_launches", "pipeline_launches", "train_launches_per_step", "dp_launches",
             "pipeline_dp_launches", "sharded_launches", "spatial_launches",
             "inventory_launches")
    log(json.dumps({"kernels": [{k: e[k] for k in keys + tuple(x for x in extra if x in e)}
                                for e in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:             # a process of phase_data_parallel
        sys.exit(dp_worker(*sys.argv[2:5]))
    sys.exit(main())
