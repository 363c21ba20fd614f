#!/usr/bin/env python3
"""Where the time of one 1024px E4E inversion goes on a CUDA card, for the
PyTorch port: python3 tools/prof_torch_inversion.py [--top 20]

Builds InversionEngine at the options/test/E4E_Face_test.yml network_g
(IR-SE-50, cycle_align 2, ModSize 256, float32, seeded weights), warms it
up, then profiles `--reps` requests with torch.profiler. Prints the card,
the wall time per request, the device-busy share of that wall time, and
the operators with the most device time. Writes the chrome trace to
--trace (default results/prof_torch_inversion.json).
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import e4e_opt, noisy  # noqa: E402
from ood_gan_inversion_tpu_torch.infer import InversionEngine  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", default="results/prof_torch_inversion.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    engine = noisy(InversionEngine(e4e_opt(), seed=0, device="cuda"))
    img = np.random.RandomState(0).rand(1024, 1024, 3).astype(np.float32)
    for _ in range(2):
        engine.invert(img, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.reps):
            engine.invert(img, seed=i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: an operator row repeats the time of its kernels
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"wall {1e3 * wall / args.reps:.2f} ms/request over {args.reps}; "
          f"device busy {1e-3 * dev_us / args.reps:.2f} ms/request "
          f"({100 * dev_us / (1e6 * wall):.1f}% of wall)")
    print(events.table(sort_by="self_device_time_total", row_limit=args.top,
                       max_name_column_width=90))
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
