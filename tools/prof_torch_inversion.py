#!/usr/bin/env python3
"""Where the time of one 1024px E4E inversion goes on a CUDA card, for the
PyTorch port:
python3 tools/prof_torch_inversion.py [--top 20] [--dtype bfloat16] [--batch 4]

Builds InversionEngine at the options/test/E4E_Face_test.yml network_g
(IR-SE-50, cycle_align 2, ModSize 256, seeded weights) in --dtype (float32
by default), warms it up, then profiles `--reps` forwards with
torch.profiler: `invert` at --batch 1, else one batched per-seed
`invert_batch_perkey` of --batch images. Prints the card, the kernels
launched per forward, the port's spans (utils/trace.py: the call's prelude,
the encoder, each generator stage and SAMM block, the blend), each with its
count per forward and its host and device self time per image, the device
time of the port's own kernels (csrc/) per forward, and the operators with
the most device time. Writes the chrome trace, which shows the spans, to
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
from ood_gan_inversion_tpu_torch.utils import trace  # noqa: E402


OWN_KERNELS = ("warp_blend_kernel", "tma_conv_kernel", "repack_kernel", "repack_tf32_kernel",
               "stage_repack_kernel", "rgb_kernel", "sum_tiles_kernel", "box3x3_kernel")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", default="results/prof_torch_inversion.json")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    engine = noisy(InversionEngine(e4e_opt(dtype=args.dtype), seed=0, device="cuda"))
    img = np.random.RandomState(0).rand(1024, 1024, 3).astype(np.float32)

    def forward(i):
        if args.batch == 1:
            return engine.invert(img, seed=i)
        return engine.invert_batch_perkey([img] * args.batch,
                                          list(range(i, i + args.batch)))

    for i in range(2):
        forward(i)
    torch.cuda.synchronize()
    t_start = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.reps):
            forward(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernel rows only: an operator row repeats the time of its kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    n = args.reps * args.batch
    print(f"{args.dtype}, batch {args.batch}, {args.reps} forwards: "
          f"{sum(e.count for e in kernels) / args.reps:.0f} kernels/forward")
    # the port's spans of these forwards, by name, in the order they opened
    spans = [s for s in trace.spans() if s.t0_ns >= t_start]
    host, dev = trace.self_times(spans, "host"), trace.self_times(spans, "device")
    rows = {}
    for s in spans:
        row = rows.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += host[s.id]
        row[2] += dev[s.id]
    print(f"  {'span':<12} {'per fwd':>7} {'host self ms/img':>17} {'device self ms/img':>19}")
    for name, (count, h, d) in rows.items():
        print(f"  {name:<12} {count / args.reps:>7.0f} {h / n:>17.3f} {d / n:>19.3f}")
    # the port's own kernels (csrc/), by their __global__ names
    for e in kernels:
        if any(k in e.key for k in OWN_KERNELS):
            print(f"  {e.key[:70]}: {1e-3 * e.self_device_time_total / args.reps:.4f} "
                  f"ms/forward in {e.count / args.reps:.0f} launches")
    print(events.table(sort_by="self_device_time_total", row_limit=args.top,
                       max_name_column_width=90))
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
