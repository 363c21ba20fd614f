#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

1. Builds every hand-written kernel of the port from `csrc/` with nvcc.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (plus border-pinned flows and bfloat16),
   and times the kernel, the plain version and the closest PyTorch library
   call with CUDA events.
3. Drives the main path -- E4E inversion at 1024px with the IR-SE-50
   encoder, cycle_align 2, warp_scale 0.08, ModSize 256, float32, seeded
   random weights -- through `InversionEngine.invert` and
   `invert_batch_perkey`, checks the outputs, the kernel launch counts and
   per-seed determinism across batch slots, and times it; then holds the
   slice on the card against the same slice on the CPU at a small width.
4. Prints the card's name and power limit, one JSON line describing the
   kernels, and as the last line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no last
line. It needs CUDA and refuses to run on the CPU.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# (non-tensor-core) rate. A card run below its 700 W limit is slower.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SEED = 0
WARP_SHAPES = [(256, 128), (128, 256), (64, 512), (32, 512)]   # (H = W, C)
WARP_SCALE = 0.08


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
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_build():
    from ood_gan_inversion_tpu_torch import build
    t0 = time.time()
    logs = build.build_all(["warp_blend"])
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


def phase_main_path():
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend
    t0 = time.time()
    engine = noisy(InversionEngine(e4e_opt(), seed=SEED, device="cuda"))
    n_params = sum(p.numel() for p in engine.net.parameters())
    log(f"[main] engine: 1024px, IR-SE-50, {n_params} parameters, "
        f"built in {time.time() - t0:.1f} s")
    rs = np.random.RandomState(SEED)
    imgs = [rs.rand(1024, 1024, 3).astype(np.float32) for _ in range(3)]
    engine.invert(imgs[0], seed=7)           # warm-up: cuDNN plans, libraries
    torch.cuda.synchronize()

    warp_blend.launches = 0
    t_single = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t_single[0].record()
    alone = engine.invert(imgs[0], seed=7)
    t_single[1].record()
    batch = engine.invert_batch_perkey([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    t_single[2].record()
    torch.cuda.synchronize()
    launches = warp_blend.launches

    if launches != 8 * 4:
        raise AssertionError(f"warp_blend launched {launches} times for 4 "
                             "images, expected 8 per image")
    for name, out, n in (("invert", alone, 1), ("invert_batch_perkey", batch, 3)):
        if tuple(out["image"].shape) != (n, 1024, 1024, 3):
            raise AssertionError(f"{name} image shape {tuple(out['image'].shape)}")
        if tuple(out["mask"].shape) != (n, 1024, 1024, 1):
            raise AssertionError(f"{name} mask shape {tuple(out['mask'].shape)}")
        for k in ("image", "gen_image", "mask", "lats"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"{name} {k} has non-finite values")
        m = out["mask"]
        if not (float(m.min()) >= 0.0 and float(m.max()) <= 1.0):
            raise AssertionError(f"{name} mask outside [0, 1]")
        for k, s in ((1, 32), (2, 64), (3, 128), (4, 256)):
            if tuple(out["aligns"][k].shape) != (n, s, s, 3):
                raise AssertionError(f"{name} align {k} shape")
    if not torch.equal(alone["image"][0], batch["image"][2]):
        raise AssertionError("seed 7 gave a different image in batch slot 2")
    if torch.equal(batch["image"][0], batch["image"][1]):
        raise AssertionError("different seeds and images gave one image")
    ms_single = t_single[0].elapsed_time(t_single[1])
    ms_batch = t_single[1].elapsed_time(t_single[2]) / 3
    log(f"[main] 4 requests answered; warp_blend launches {launches} "
        f"(8 per image); slot 2 of the batch == the lone request: True")
    log(f"[main] ms/img: invert {ms_single:.2f}, invert_batch_perkey "
        f"{ms_batch:.2f} (CUDA events, 1024px, float32)")
    reps = []
    for i in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        engine.invert(imgs[i % 3], seed=i)
        b.record()
        b.synchronize()
        reps.append(a.elapsed_time(b))
    log(f"[main] invert ms/img over 5 more requests: median "
        f"{float(np.median(reps)):.2f}, all {[round(r, 2) for r in reps]}")
    return launches


def phase_small_reference():
    """The slice at a small width on the card (kernel) against the same
    weights on the CPU (plain warp-blend), the port's CPU path being the
    one the tests hold against the JAX package."""
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    opt = e4e_opt(out_size=256, channel_multiplier=1, narrow=0.25,
                  encoder_num_layers=4)
    gpu = noisy(InversionEngine(opt, seed=SEED + 1, device="cuda"))
    cpu = InversionEngine(opt, params=gpu.net.state_dict(), device="cpu")
    img = np.random.RandomState(SEED + 1).rand(256, 256, 3).astype(np.float32)
    # the same noise on both devices: draw it on the CPU, copy to the card
    noise = cpu.net.generator.make_noise(
        1, torch.Generator().manual_seed(3), torch.device("cpu"))
    x = torch.from_numpy(img[None] * 2.0 - 1.0)
    with torch.inference_mode():
        ref = cpu.net(x, mod_size=256, noise=noise)
        out = gpu.net(x.cuda(), mod_size=256, noise=[n.cuda() for n in noise])
    for k in ("image", "mask", "gen_image"):
        r = ref[k].numpy()
        err = float(np.abs(out[k].cpu().numpy() - r).max() / np.abs(r).max())
        if not err <= 1e-3:
            raise AssertionError(f"small slice {k}: card vs CPU rel err {err}")
        log(f"[check] small slice (256px) {k}: card vs CPU max rel err {err:.2e}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    entry = phase_kernels()
    entry["launches"] = phase_main_path()
    phase_small_reference()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: entry[k] for k in keys}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
