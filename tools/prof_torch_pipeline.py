#!/usr/bin/env python3
"""Where the time of a training run goes on a CUDA card, for the PyTorch
port's entry point:
python3 tools/prof_torch_pipeline.py [--iters 10] [--profile-at 5] [--top 15]

Writes seeded synthetic 1024px PNGs (8 train, 2 val) into a temporary
directory and runs the training CLI itself, `python -m
ood_gan_inversion_tpu_torch.run_train --opt options/train/E4E_Face.yml`,
overriding only the dataroots, the absent pretrained G and D, the
experiment root, `train:total_iter`, `logger:profile_iters` and
`network_g:ModSize=256` (the full SAMM width of a step past the
curriculum); print, save and validation periods stay the shipped ones, so
the traced iterations are plain loop iterations. The CLI's torch.profiler
trace covers iterations profile-at .. profile-at + 3. Prints the card,
the traced wall time per iteration, the device-busy share of it (the
union of kernel and copy intervals on the card over the window from the
first to the last of them), the host-to-device copies per iteration, and
the kernels with the most device time. Deletes its directory afterwards.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import write_face_pngs  # noqa: E402


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile-at", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    root = tempfile.mkdtemp(prefix="ogi_prof_pipeline_")
    try:
        write_face_pngs(f"{root}/train", 8, 20)
        write_face_pngs(f"{root}/val", 2, 21)
        cmd = [sys.executable, "-m", "ood_gan_inversion_tpu_torch.run_train",
               "--opt", "options/train/E4E_Face.yml", "--force_yml",
               f"datasets:train:dataroot_gt_list=[{root}/train]",
               f"datasets:val:dataroot_gt={root}/val",
               "path:pretrain_network_g=~", "path:pretrain_network_d=~",
               f"path:experiments_root={root}/exp", f"train:total_iter={args.iters}",
               f"logger:profile_iters={args.profile_at}", "network_g:ModSize=256"]
        subprocess.run(cmd, check=True, cwd=ROOT)
        with open(f"{root}/exp/profile/trace.json") as f:
            events = json.load(f)["traceEvents"]
        gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and "dur" in e]
        if not gpu:
            raise SystemExit("the trace holds no device events")
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in gpu]
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        n = 4                     # iterations profile-at .. profile-at + 3
        busy = busy_us(spans)
        h2d = [e for e in gpu if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
        by_name = defaultdict(float)
        for e in gpu:
            by_name[e["name"]] += float(e["dur"])
        print(f"run_train, E4E_Face.yml at ModSize 256, b = 2, 1024px, float32, iterations "
              f"{args.profile_at}..{args.profile_at + 3} under the profiler: window "
              f"{1e-3 * window / n:.2f} ms/iteration, device busy {1e-3 * busy / n:.2f} "
              f"ms/iteration ({100 * busy / window:.1f}%), "
              f"{sum(1 for e in gpu if e.get('cat') == 'kernel') / n:.0f} kernels/iteration, "
              f"{len(h2d) / n:.1f} host-to-device copies/iteration taking "
              f"{1e-3 * sum(float(e['dur']) for e in h2d) / n:.3f} ms ({smi})")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
            print(f"  {1e-3 * us / n:9.3f} ms/iteration  {name[:110]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
