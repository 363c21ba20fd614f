"""Validation (counterpart of models/validation.py): per-sample inversion,
image and mask-strip dumps, metric dispatch and best-value tracking.

The inversion's noise comes from a generator seeded with `manual_seed`
afresh for every batch, as JAX draws it from PRNGKey(manual_seed) for
every batch: validation never draws from the model's training generator,
so a run with validation takes the same train steps as one without.
"""

import os.path as osp
from collections import defaultdict

import numpy as np
import torch

from ..metrics import calculate_metric
from ..utils.img_util import imwrite, resize_nearest, tensor2img
from ..utils.logger import get_root_logger


class BestMetricTracker:
    """The best value of each metric and the iteration that reached it."""

    def __init__(self, metrics_opt):
        self.records = {}
        for name, m in (metrics_opt or {}).items():
            better = m.get("better", "higher")
            init = -float("inf") if better == "higher" else float("inf")
            self.records[name] = {"better": better, "val": init, "iter": -1}

    def update(self, name, val, it):
        r = self.records[name]
        improved = (val >= r["val"]) if r["better"] == "higher" else (val <= r["val"])
        if improved:
            r["val"], r["iter"] = val, it
        return improved


def mask_strip(aligns, strip_h=256):
    """A horizontal strip of the per-scale alpha masks of sample 0, each
    resized to strip_h (nearest), as uint8."""
    cols = []
    for k in sorted(aligns.keys()):
        alpha = resize_nearest(np.asarray(aligns[k][0, ..., 2]), strip_h)
        cols.append((np.clip(alpha, 0, 1) * 255).astype(np.uint8))
    return np.concatenate(cols, axis=1) if cols else None


def run_validation(model, loader, opt, current_iter, tb_logger=None,
                   tracker: BestMetricTracker | None = None, ema=False):
    """Inverts every validation batch with `model.infer` (no grad, the EMA
    weights with `ema`), dumps view 0's inversion and mask strip (and the
    ground truth) when `val.save_img`, and returns each `val.metrics`
    entry averaged over the views of a sample, then over samples."""
    val_opt = opt.get("val", {}) or {}
    metrics_opt = val_opt.get("metrics", None)
    save_img = val_opt.get("save_img", False)
    save_lq_and_gt = val_opt.get("save_lq_and_gt", False)
    dataset_name = "val"
    logger = get_root_logger()
    seed = opt.get("manual_seed", 0)

    sums = defaultdict(float)
    count = 0
    for batch in loader:
        gt5 = np.asarray(batch["gt"])
        x = torch.from_numpy(np.ascontiguousarray(gt5.reshape((-1,) + gt5.shape[2:])))
        noise = model.make_noise(x.shape[0], torch.Generator(model.device).manual_seed(seed))
        with torch.no_grad():
            out = model.infer(x.to(model.device), step=current_iter, ema=ema, noise=noise)
        sr5 = out["image"].float().cpu().numpy().reshape(gt5.shape)   # (B, K, H, W, C)
        # uint8 BGR of every view, once; view 0 for the visual dumps
        sr_imgs = [[tensor2img(v) for v in views] for views in sr5]
        gt_imgs = [[tensor2img(v) for v in views] for views in gt5]
        sr_img, gt_img = sr_imgs[0][0], gt_imgs[0][0]

        img_name = osp.splitext(osp.basename(
            batch["gt_path"][0][0] if isinstance(batch["gt_path"][0], list)
            else batch["gt_path"][0]))[0]
        if save_img:
            vis = opt["path"]["visualization"]
            imwrite(sr_img, osp.join(vis, img_name, f"{img_name}_{current_iter}.jpg"))
            strip = mask_strip({k: v.float().cpu().numpy() for k, v in out["aligns"].items()})
            if strip is not None:
                imwrite(strip, osp.join(vis, img_name, f"{img_name}_{current_iter}_masks.jpg"))
            if save_lq_and_gt:
                imwrite(gt_img, osp.join(vis, img_name, f"{img_name}_gt.jpg"))

        if metrics_opt:
            # every view against its own ground truth, averaged per sample
            n_views = int(np.prod(gt5.shape[:2]))
            for name, m_opt in metrics_opt.items():
                v = 0.0
                for bi in range(gt5.shape[0]):
                    for ki in range(gt5.shape[1]):
                        v += calculate_metric({"img": sr_imgs[bi][ki], "img2": gt_imgs[bi][ki],
                                               "device": model.device}, m_opt)
                sums[name] += v / n_views
        count += 1

    results = {k: v / max(count, 1) for k, v in sums.items()}
    if metrics_opt:
        log = f"Validation {dataset_name}, iter {current_iter}: "
        for name, val in results.items():
            log += f"{name}: {val:.4f} "
            if tracker is not None:
                tracker.update(name, val, current_iter)
                r = tracker.records[name]
                log += f"(best: {r['val']:.4f} @ {r['iter']}) "
            if tb_logger is not None:
                tb_logger.add_scalar(f"metrics/{dataset_name}/{name}", val, current_iter)
        logger.info(log)
    return results
