#!/usr/bin/env python3
"""Where the time of one E4E_Face.yml train step goes on a CUDA card, for
the PyTorch port:
python3 tools/prof_torch_train.py [--reps 3] [--top 25] [--step 16001]

Builds OODFaceGANModel at options/train/E4E_Face.yml's width (1024px, b =
2, float32, TF32 off, seeded weights and batch; chip_smoke.e4e_train_opt),
warms `--step` up (16001: a fused step at ModSize 256; 0: step 0, the
split phases with R1 and the path regularizer), then profiles `--reps`
steps with torch.profiler. Prints the card, the wall time per step, the
device-busy share of that wall time, the kernels launched per step, the
device time of B1 (the port's warp-blend kernel) per step, the peak
memory, and the operators with the most device time. Writes the chrome
trace to --trace (default results/prof_torch_train.json).
"""

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import SEED, e4e_train_opt, train_batch  # noqa: E402
from ood_gan_inversion_tpu_torch.models import OODFaceGANModel  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--step", type=int, default=16001)
    ap.add_argument("--trace", default="results/prof_torch_train.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    model = OODFaceGANModel(e4e_train_opt(), device="cuda", seed=SEED)
    batch = train_batch(model, 1024, SEED + 2)
    for _ in range(2):
        model.train_step(batch, args.step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            model.train_step(batch, args.step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    events = prof.key_averages()
    # kernel rows only: an operator row repeats the time of its kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    stage, mod_size = model.schedule_at(args.step)
    print(f"step {args.step} (ModSize {mod_size}), b = 2, 1024px, float32: wall "
          f"{1e3 * wall / args.reps:.2f} ms/step over {args.reps} (under the profiler); "
          f"device busy {1e-3 * dev_us / args.reps:.2f} ms/step "
          f"({100 * dev_us / (1e6 * wall):.1f}% of wall); "
          f"{sum(e.count for e in kernels) / args.reps:.0f} kernels/step; peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    for e in kernels:
        if "warp_blend_kernel" in e.key:
            print(f"  {e.key[:70]}: {1e-3 * e.self_device_time_total / args.reps:.4f} "
                  f"ms/step in {e.count / args.reps:.0f} launches")
    print(events.table(sort_by="self_device_time_total", row_limit=args.top,
                       max_name_column_width=90))
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
