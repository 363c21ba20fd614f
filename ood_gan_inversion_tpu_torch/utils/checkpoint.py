"""Checkpoints and resume (counterpart of utils/checkpoint.py) in
PyTorch's own format (`torch.save`, read back with weights_only=True).

At iteration `it`, `save_training_checkpoint` writes
  * `models/net_{it}.pth`: {"params": the trainable generator parameters,
    "params_ema": their EMA, "params_d": D, "params_d2": the latent D};
  * `models/delta_lat_{it}.pth`: {"delta_latent": ...}, when delta_latent
    trains;
  * `training_states/state_{it}.pth`: `OODFaceGANModel.state_dict()`, the
    whole training state.
Every tensor is moved to the CPU in one pass over the state, after the
step. A failed write is retried 3 times, 1 s apart. `--auto_resume`
restores the state file of the highest iteration.
"""

import os
import os.path as osp
import re
import time

import torch

from .logger import get_root_logger


def _queue_to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", non_blocking=True)
    if isinstance(tree, dict):
        return {k: _queue_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_queue_to_cpu(v) for v in tree)
    return tree


def to_cpu(tree):
    """The nested dict / list of tensors with every tensor detached on the
    CPU. Copies from the card go into page-locked memory without blocking
    the host, and are awaited once."""
    out = _queue_to_cpu(tree)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def save_file(tree, path, retry=3):
    """torch.save of tree to path (through a temporary file, so a reader
    never sees half a checkpoint); True once written."""
    logger = get_root_logger()
    tmp = f"{path}.tmp"
    while retry > 0:
        try:
            torch.save(tree, tmp)
            os.replace(tmp, path)
            return True
        except OSError as e:
            logger.warning(f"Save ckpt error: {e}, remaining retries: {retry - 1}")
            time.sleep(1)
            retry -= 1
    logger.warning(f"Still cannot save {path}.")
    return False


def save_training_checkpoint(model, models_dir, states_dir, it):
    """The weight file, the delta_latent file when it trains, and the
    training state of `model` at iteration it. True when all were written."""
    state = to_cpu(model.state_dict())
    nets = state["nets"]
    os.makedirs(models_dir, exist_ok=True)
    os.makedirs(states_dir, exist_ok=True)
    weights = {"params": {k: nets["net_g"][k] for k in model.train_g},
               "params_ema": state["ema"],
               "params_d": nets.get("net_d", {}),
               "params_d2": nets.get("net_d2", {})}
    ok = save_file(weights, osp.join(models_dir, f"net_{it}.pth"))
    if "delta_latent" in model.train_g:
        ok = save_file({"delta_latent": nets["net_g"]["delta_latent"]},
                       osp.join(models_dir, f"delta_lat_{it}.pth")) and ok
    ok = save_file(state, osp.join(states_dir, f"state_{it}.pth")) and ok
    return ok


def find_resume_state(states_dir):
    """(path, iteration) of the highest-iteration state file, or (None, 0)."""
    if not osp.isdir(states_dir):
        return None, 0
    found = []
    for name in os.listdir(states_dir):
        m = re.fullmatch(r"state_(\d+)\.pth", name)
        if m:
            found.append(int(m.group(1)))
    if not found:
        return None, 0
    it = max(found)
    return osp.join(states_dir, f"state_{it}.pth"), it


def resume_training_state(model, states_dir):
    """Loads the highest-iteration state into `model`; returns that
    iteration (0, model untouched, when there is none)."""
    path, it = find_resume_state(states_dir)
    if path is None:
        return 0
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return it
