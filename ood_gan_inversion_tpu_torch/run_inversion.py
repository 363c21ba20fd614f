"""Folder inversion CLI of the port (counterpart of run_inversion.py):

python -m ood_gan_inversion_tpu_torch.run_inversion \
    --opt options/test/E4E_Face_test.yml [--weights state_dict.pt] \
    [--out results/inversion] [--direction smile --intensity 1.5] \
    [--device cuda] [--dtype bfloat16] [--packed-tail] \
    [--tail-kernel none|pair|stage] [--samm-body0 algebraic|fused|literal] \
    [--samm-conv-kernel] [--samm-fp32-infer] [--samm-conv-bf16] \
    [--samm-warp-bf16 off|fit|all] [--samm-gather-bf16]

Inverts every image of each dataset's `dataroot_gt`, writes the inversion
and the per-scale masks as PNG files and reports each `val.metrics` entry
(the inversion against the input at the model's size), averaged over the
images, with the seconds per image. Without --weights the weights are
drawn from a seed. --dtype overrides the
option file's `network_g: dtype`; the other flags are InversionEngine's
options of the same names. Reads the option file with
`utils/options.load_yaml` and images with `utils/img_util` (the port's
codec).
"""

import argparse
import glob
import os.path as osp
import time

import numpy as np
import torch

from .infer import InversionEngine, load_editing_direction
from .metrics import calculate_metric
from .utils.img_util import img2input, imread, imwrite, tensor2img
from .utils.options import load_yaml


def list_images(folder):
    files = []
    for ext in ("*.png", "*.jpg", "*.jpeg"):
        files.extend(glob.glob(osp.join(folder, ext)))
    return sorted(files)


def run_inversion(opt, out_dir, params=None, device="cuda", **engine_options):
    engine = InversionEngine(opt, params=params, device=device, **engine_options)
    editing = opt.get("editing") or {}
    if editing.get("direction"):
        engine.apply_direction(load_editing_direction(
            editing.get("dir_path", "directions"), editing["direction"],
            editing.get("intensity", 1.0)))
    metrics_opt = (opt.get("val") or {}).get("metrics") or {}
    sums, times = {}, []
    for ds in (opt.get("datasets") or {}).values():
        for path in list_images(ds.get("dataroot_gt")):
            img = imread(path)
            t0 = time.time()
            out = engine.invert(img, seed=0)
            inv = tensor2img(out["image"].float().cpu().numpy())   # waits for the card
            times.append(time.time() - t0)
            base = osp.splitext(osp.basename(path))[0]
            imwrite(inv, osp.join(out_dir, "inversion", f"{base}.png"))
            for k, align in out["aligns"].items():
                m = (align[0, ..., 2].float().clamp(0, 1) * 255).to(torch.uint8)
                imwrite(m.cpu().numpy(), osp.join(out_dir, "masks", f"{base}_{k}.png"))
            gt = tensor2img(img2input(img, engine.out_size))
            for name, m_opt in metrics_opt.items():
                sums[name] = sums.get(name, 0.0) + calculate_metric(
                    {"img": inv, "img2": gt, "device": engine.device}, m_opt)
    report = {name: v / len(times) for name, v in sums.items()}
    report.update(images=len(times),
                  sec_per_img=float(np.mean(times[1:] if len(times) > 1 else times))
                  if times else 0.0)
    print(f"Inversion report: {report}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", required=True)
    ap.add_argument("--weights", default=None,
                    help="a torch.save'd state_dict of the arch")
    ap.add_argument("--out", default=None)
    ap.add_argument("--direction", default=None)
    ap.add_argument("--dir_path", default="directions")
    ap.add_argument("--intensity", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"))
    ap.add_argument("--packed-tail", action="store_true")
    ap.add_argument("--tail-kernel", default="none", choices=("none", "pair", "stage"))
    ap.add_argument("--samm-body0", default=None,
                    choices=("algebraic", "fused", "literal"),
                    help="AlignNet body0's route; the engine's default_samm_body0 "
                         "without it")
    ap.add_argument("--samm-conv-kernel", action="store_true")
    ap.add_argument("--samm-fp32-infer", action="store_true")
    ap.add_argument("--samm-conv-bf16", action="store_true")
    ap.add_argument("--samm-warp-bf16", default="off", choices=("off", "fit", "all"))
    ap.add_argument("--samm-gather-bf16", action="store_true")
    args = ap.parse_args(argv)
    with open(args.opt) as f:
        opt = load_yaml(f)
    if args.dtype:
        opt["network_g"]["dtype"] = args.dtype
    if args.direction:
        opt["editing"] = {"direction": args.direction, "dir_path": args.dir_path,
                          "intensity": args.intensity}
    params = (torch.load(args.weights, map_location="cpu", weights_only=True)
              if args.weights else None)
    run_inversion(opt, args.out or osp.join("results", opt.get("name", "inversion")),
                  params=params, device=args.device, packed_tail=args.packed_tail,
                  tail_kernel=args.tail_kernel, samm_body0=args.samm_body0,
                  samm_conv_kernel=args.samm_conv_kernel,
                  samm_fp32_infer=args.samm_fp32_infer,
                  samm_conv_bf16=args.samm_conv_bf16, samm_warp_bf16=args.samm_warp_bf16,
                  samm_gather_bf16=args.samm_gather_bf16)


if __name__ == "__main__":
    main()
