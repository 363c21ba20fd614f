"""Test pipeline of the port (counterpart of test.py): options, one loader
per test set, the model with its pretrained generator, then validation of
every set, on one CUDA card (or the CPU when `--device cpu` asks for it).

    python -m ood_gan_inversion_tpu_torch.run_test --opt options/test/E4E_Face_test.yml \\
        [--force_yml k:k=v ...] [--device cuda]

Any of the three arch families runs (E4E, ReStyle, FeatureStyle). Each
set's `val.metrics` (PSNR, SSIM, LPIPS, identity, ...) are averaged over
its images; `val.save_img` dumps each inversion and its mask strip under
`results/<name>/visualization`. `path.pretrain_network_g` is a `.npz` of
the JAX tree (`train.load_pretrained`); without it the weights are seeded
from `manual_seed`.
"""

import os.path as osp
import time

import torch

from .data import build_dataloader, build_dataset
from .device import resolve_device
from .models.validation import run_validation
from .train import build_model, load_pretrained
from .utils.logger import get_root_logger
from .utils.options import make_exp_dirs, parse_options


def test_pipeline(root_path, args=None):
    """Runs the test the command line `args` describes; returns {test set
    name: {metric: value}}."""
    opt, parsed = parse_options(root_path, is_train=False, args=args)
    device = resolve_device(parsed.device)
    make_exp_dirs(opt)
    log_file = osp.join(opt["path"]["log"], f"test_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_file=log_file)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    loaders = []
    for phase, dataset_opt in sorted((opt.get("datasets") or {}).items()):
        ds = build_dataset(dataset_opt)
        name = dataset_opt.get("name", phase)
        loaders.append((name, build_dataloader(ds, dataset_opt, is_train=False)))
        logger.info(f"Test images in {name}: {len(ds)}")

    model = build_model(opt, device, opt.get("manual_seed", 0))
    p = (opt.get("path", {}) or {}).get("pretrain_network_g")
    if p:
        load_pretrained(model, p, "g", opt["path"].get("param_key_g", "params"),
                        strict=opt["path"].get("strict_load_g", False))
        logger.info(f"Loaded pretrained g from {p}")

    results = {}
    for name, loader in loaders:
        logger.info(f"Testing {name}...")
        results[name] = run_validation(model, loader, opt, current_iter=0, ema=False)
    return results
