"""Training pipeline of the port (counterpart of train.py): options, data,
the model, pretrained weights, auto-resume, the iteration loop with its
logging, checkpoints and validation, on one CUDA card (or the CPU when
`--device cpu` asks for it).

    python -m ood_gan_inversion_tpu_torch.run_train --opt options/train/E4E_Face.yml \\
        [--auto_resume] [--debug] [--seed N] [--force_yml k:k=v ...] [--device cuda]

The loop mirrors the JAX package's: iterations count from 1; each batch
goes to the card in page-locked memory without blocking the host; losses
reach the host (`float`) only at `print_freq`; a checkpoint at every
`save_checkpoint_freq`, validation at every `val_freq`, and at the end a
final checkpoint and a final validation, so the last iteration is saved
(and validated) twice when it falls on those periods, as in JAX. A resumed
run restarts the sampler at epoch 0, as JAX's does.

Multiple cards are not ported (ROADMAP A10): `num_devices` must be 1 and
the step's batch is `batch_size_per_gpu`.
"""

import os
import os.path as osp
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .convert import from_jax_params
from .data import build_dataloader, build_dataset
from .device import resolve_device
from .models import OODFaceGANModel
from .models.optim import multistep_lr
from .models.validation import BestMetricTracker, run_validation
from .utils import checkpoint as ckpt
from .utils.logger import (AvgTimer, MessageLogger, get_root_logger, init_tb_logger,
                           init_wandb_logger)
from .utils.options import copy_opt_file, make_exp_dirs, parse_options

@dataclass
class TrainRun:
    """What a `train_pipeline` run did: the model as it ended, the
    iteration it resumed from (0: none) and the one it reached, the
    host-clock averages of the loop's timers (seconds per iteration, and
    waiting for data), the seconds of each checkpoint and each
    validation, and the last validation's results."""
    model: OODFaceGANModel
    start_iter: int
    current_iter: int
    iter_time: float
    data_time: float
    save_seconds: list = field(default_factory=list)
    val_seconds: list = field(default_factory=list)
    val_results: dict = field(default_factory=dict)


def num_devices(opt):
    n = opt.get("num_devices") or 1
    if n != 1:
        raise NotImplementedError(f"num_devices {n}: the port trains on one card "
                                  "(multiple devices are ROADMAP A10)")
    return n


def create_train_val_dataloader(opt, logger, pin_keys=()):
    """(train loader, validation loader) of opt's datasets; the train
    batches' entries under pin_keys come in page-locked memory."""
    train_loader, val_loader = None, None
    n_dev = num_devices(opt)
    for phase, dataset_opt in (opt.get("datasets") or {}).items():
        if phase == "train":
            ds = build_dataset(dataset_opt)
            dataset_opt = dict(dataset_opt)
            dataset_opt["batch_size_per_gpu"] = dataset_opt.get("batch_size_per_gpu", 1) * n_dev
            train_loader = build_dataloader(ds, dataset_opt, num_shards=1, shard_index=0,
                                            seed=opt.get("manual_seed", 0), is_train=True,
                                            pin_keys=pin_keys)
            logger.info(f"Training images: {len(ds)}; {len(train_loader)} iters/epoch/process")
        elif phase.startswith("val"):
            ds = build_dataset(dataset_opt)
            val_loader = build_dataloader(ds, dataset_opt, is_train=False)
            logger.info(f"Validation images: {len(ds)}")
    return train_loader, val_loader


def to_device(batch, keys, device):
    """The batch's `keys` as tensors on device: page-locked ones copied
    without blocking the host."""
    out = {}
    for k in keys:
        v = batch[k]
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(device, non_blocking=t.is_pinned())
    return out


def build_model(opt, device, seed):
    if opt["model_type"] != "ood_faceGAN_Model":
        raise NotImplementedError(f"model_type {opt['model_type']!r} is not ported "
                                  "(ported: 'ood_faceGAN_Model')")
    return OODFaceGANModel(opt, device=device, seed=seed)


def train_pipeline(root_path, args=None):
    """Runs the training that the command line `args` describes; returns
    a `TrainRun`."""
    opt, parsed = parse_options(root_path, is_train=True, args=args)
    device = resolve_device(parsed.device)

    make_exp_dirs(opt)
    copy_opt_file(parsed.opt, opt["path"]["experiments_root"])
    log_file = osp.join(opt["path"]["log"], f"train_{opt['name']}_{int(time.time())}.log")
    logger = get_root_logger(log_file=log_file)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    if opt.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
    logger_opt = opt.get("logger", {}) or {}
    tb_logger = (init_tb_logger(osp.join(opt["path"]["experiments_root"], "tb_logger"))
                 if logger_opt.get("use_tb_logger") else None)
    if logger_opt.get("wandb"):
        init_wandb_logger(opt)

    seed = opt.get("manual_seed", 0)
    model = build_model(opt, device, seed)
    train_loader, val_loader = create_train_val_dataloader(
        opt, logger, pin_keys=model.batch_keys if device.type == "cuda" else ())

    # pretrained / converted weights
    path_opt = opt.get("path", {}) or {}
    for key, which in (("pretrain_network_g", "g"), ("pretrain_network_d", "d"),
                       ("pretrain_network_d2", "d2")):
        p = path_opt.get(key)
        if p:
            load_pretrained(model, p, which, path_opt.get(f"param_key_{which}", "params"),
                            strict=path_opt.get(f"strict_load_{which}", True))
            logger.info(f"Loaded pretrained {which} from {p}")

    start_iter = 0
    if opt.get("auto_resume"):
        it = ckpt.resume_training_state(model, opt["path"]["training_states"])
        if it:
            start_iter = it
            logger.info(f"Resumed training from iter {it}.")

    total_iter = int(opt["train"]["total_iter"])
    print_freq = logger_opt.get("print_freq", 100)
    save_freq = logger_opt.get("save_checkpoint_freq", 2000)
    val_freq = (opt.get("val", {}) or {}).get("val_freq", None)
    tracker = BestMetricTracker((opt.get("val", {}) or {}).get("metrics"))
    prof_at = logger_opt.get("profile_iters")
    trace_path = osp.join(opt["path"]["experiments_root"], "profile", "trace.json")

    msg_logger = MessageLogger(opt, start_iter + 1, tb_logger)
    iter_timer, data_timer = AvgTimer(), AvgTimer()
    sched = opt["train"].get("scheduler", {}) or {}
    lr_fn = multistep_lr(opt["train"].get("optim_g", {}).get("lr", 2e-5),
                         sched.get("milestones"), sched.get("gamma", 1.0))
    run = TrainRun(model, start_iter, start_iter, 0.0, 0.0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def save(it):
        sync()
        t0 = time.time()
        ckpt.save_training_checkpoint(model, opt["path"]["models"],
                                      opt["path"]["training_states"], it)
        run.save_seconds.append(time.time() - t0)
        logger.info(f"Saved models and training states at iter {it} "
                    f"({run.save_seconds[-1]:.2f} s).")

    def validate(it):
        sync()
        t0 = time.time()
        run.val_results = run_validation(model, val_loader, opt, it, tb_logger, tracker)
        run.val_seconds.append(time.time() - t0)

    logger.info(f"Start training from iter {start_iter}, total {total_iter}.")
    current_iter = start_iter
    epoch = 0
    profiler = None
    start = time.time()
    while current_iter < total_iter:
        train_loader.sampler.set_epoch(epoch)
        for batch_np in train_loader:
            data_timer.record()
            if current_iter >= total_iter:
                break
            current_iter += 1
            batch = to_device(batch_np, model.batch_keys, device)
            if prof_at and current_iter == int(prof_at):
                profiler = start_profile(device)
            logs = model.train_step(batch, current_iter)
            iter_timer.record()
            if profiler is not None and current_iter == int(prof_at) + 3:
                stop_profile(profiler, trace_path, device)
                profiler = None
                logger.info(f"Wrote the profiler trace of iterations {int(prof_at)}.."
                            f"{current_iter} to {trace_path}.")

            if current_iter % print_freq == 0:
                log_vars = {"epoch": epoch, "iter": current_iter,
                            "lrs": [float(lr_fn(current_iter))],
                            "time": iter_timer.get_avg_time(),
                            "data_time": data_timer.get_avg_time()}
                log_vars.update({k: float(v) for k, v in logs.items()})
                msg_logger(log_vars)

            if current_iter % save_freq == 0:
                save(current_iter)
            if val_freq and current_iter % int(val_freq) == 0 and val_loader:
                validate(current_iter)
            data_timer.start()
            iter_timer.start()
        epoch += 1

    if profiler is not None:           # the run ended inside the traced steps
        stop_profile(profiler, trace_path, device)
    sync()
    logger.info(f"Training done, {time.time() - start:.1f}s. Saving final.")
    save(current_iter)
    if val_loader:
        validate(current_iter)
    if tb_logger is not None:
        tb_logger.close()
    run.current_iter = current_iter
    run.iter_time, run.data_time = iter_timer.get_avg_time(), data_timer.get_avg_time()
    return run


def start_profile(device):
    """A torch.profiler trace of the host (and the card), started."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof, path, device):
    """Stops the trace once the card has finished, and writes it to path as
    a chrome trace."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(osp.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def load_pretrained(model, path, which, param_key="params", strict=True):
    """Merges converted weights into net_g ("g"), net_d ("d") or net_d2
    ("d2"): a `.npz` of the JAX net's flattened tree (keys 'a/b/c'),
    through `convert.from_jax_params`. A parameter of the net that the file
    lacks raises KeyError when strict, else warns and keeps its value; a
    leaf of the file that the net lacks warns; a shape mismatch warns and
    raises ValueError when strict, else keeps the value. Loading "g" resets
    the EMA to the trainable parameters. An orbax directory raises: convert
    it to `.npz` first (the port reads no orbax)."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the port loads converted weights as .npz; convert the "
                         "orbax checkpoint to .npz (a flattened 'a/b/c' tree) first")
    with np.load(path, allow_pickle=False) as f:
        flat = {k: np.array(f[k]) for k in f.files}       # writable copies
    logger = get_root_logger()
    label, net = {"g": ("net_g", model.net_g), "d": ("net_d", model.net_d),
                  "d2": ("net_d2", model.net_d2)}[which]
    incoming, leftovers = from_jax_params(flat, which)
    target = net.state_dict()
    missing = set(target) - set(incoming)
    unexpected = set(incoming) - set(target)
    if missing:
        msg = f"{label}: {len(missing)} params not in checkpoint"
        if strict:
            raise KeyError(msg + f": {sorted(missing)[:5]} ...")
        logger.warning(msg)
    if unexpected or leftovers:
        logger.warning(f"{label}: {len(unexpected) + len(leftovers)} unexpected ckpt keys")
    merged = dict(target)
    for k in set(target) & set(incoming):
        if target[k].shape != incoming[k].shape:
            logger.warning(f"{label}: shape mismatch {k}")
            if strict:
                raise ValueError(f"shape mismatch {k}")
            continue
        merged[k] = incoming[k]
    net.load_state_dict(merged, strict=True)
    if which == "g":
        with torch.no_grad():
            for k, p in model.train_g.items():
                model.ema[k].copy_(p)
