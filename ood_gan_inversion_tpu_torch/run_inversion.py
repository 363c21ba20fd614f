"""Folder inversion CLI of the port (counterpart of run_inversion.py):

python -m ood_gan_inversion_tpu_torch.run_inversion \
    --opt options/test/E4E_Face_test.yml [--weights state_dict.pt] \
    [--out results/inversion] [--direction smile --intensity 1.5] \
    [--device cuda]

Inverts every image of each dataset's `dataroot_gt`, writes the inversion
and the per-scale masks as PNG files and prints the seconds per image.
Without --weights the weights are drawn from a seed. Reads YAML and image
files with PyYAML and OpenCV, imported here only.
"""

import argparse
import glob
import os
import os.path as osp
import time

import numpy as np
import torch

from .infer import InversionEngine, load_editing_direction
from .utils.img_util import tensor2img


def list_images(folder):
    files = []
    for ext in ("*.png", "*.jpg", "*.jpeg"):
        files.extend(glob.glob(osp.join(folder, ext)))
    return sorted(files)


def run_inversion(opt, out_dir, params=None, device="cuda"):
    import cv2

    def imwrite(img, path):
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        if not cv2.imwrite(path, img):
            raise IOError(f"failed to write image: {path}")

    engine = InversionEngine(opt, params=params, device=device)
    editing = opt.get("editing") or {}
    if editing.get("direction"):
        engine.apply_direction(load_editing_direction(
            editing.get("dir_path", "directions"), editing["direction"],
            editing.get("intensity", 1.0)))
    times = []
    for ds in (opt.get("datasets") or {}).values():
        for path in list_images(ds.get("dataroot_gt")):
            bgr = cv2.imread(path, cv2.IMREAD_COLOR)
            if bgr is None:
                raise IOError(f"failed to read image: {path}")
            img = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
            t0 = time.time()
            out = engine.invert(img, seed=0)
            inv = tensor2img(out["image"].cpu().numpy())   # waits for the card
            times.append(time.time() - t0)
            base = osp.splitext(osp.basename(path))[0]
            imwrite(inv, osp.join(out_dir, "inversion", f"{base}.png"))
            for k, align in out["aligns"].items():
                m = (align[0, ..., 2].clamp(0, 1) * 255).to(torch.uint8)
                imwrite(m.cpu().numpy(), osp.join(out_dir, "masks", f"{base}_{k}.png"))
    report = {"images": len(times),
              "sec_per_img": float(np.mean(times[1:] if len(times) > 1 else times))
              if times else 0.0}
    print(f"Inversion report: {report}")
    return report


def main():
    import yaml

    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", required=True)
    ap.add_argument("--weights", default=None,
                    help="a torch.save'd state_dict of the arch")
    ap.add_argument("--out", default=None)
    ap.add_argument("--direction", default=None)
    ap.add_argument("--dir_path", default="directions")
    ap.add_argument("--intensity", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    with open(args.opt) as f:
        opt = yaml.safe_load(f)
    if args.direction:
        opt["editing"] = {"direction": args.direction, "dir_path": args.dir_path,
                          "intensity": args.intensity}
    params = (torch.load(args.weights, map_location="cpu", weights_only=True)
              if args.weights else None)
    run_inversion(opt, args.out or osp.join("results", opt.get("name", "inversion")),
                  params=params, device=args.device)


if __name__ == "__main__":
    main()
