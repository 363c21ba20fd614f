"""The comparison that decides `correct`, and the control that it has to
fail.

After the window has closed, the configuration's reference (the module
that its `reference` names under portbench/reference/, float32, TF32 off)
runs once over each sampled call's images and request seeds, with weights
drawn again from the run's seed (portbench/weights.py), and each output
the timed path produced is compared with it, image by image:

  lats_err       max |lats - ref| / max |ref|: the encoder, avg_latent and
                 delta_latent (after the encoder's last pass)
  gen_image_err  the same for the SAMM-conditioned decode
  mask_err       the same for the composited alphas
  image_err      the same for the blend

each the worst over the sampled images. The limits are the configuration
file's `limits`; PERF.md gives the readings they were set from.

The control (`--control`): the reference itself in the program's place,
computed with TF32 on (the precision below float32 that the engine turns
off), on the same inputs.
"""

import contextlib

import numpy as np
import torch

from . import reference as references
from .weights import make_state_dict

KEYS = ("lats", "gen_image", "mask", "image")


@contextlib.contextmanager
def tf32(on):
    """cuDNN convolutions and CUDA matrix products with TF32 on or off."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def reference(config, weight_seed, device):
    """(the configuration's reference module, its model with the weights of
    `weight_seed` on `device`)."""
    ref = references.module(config)
    model = ref.build(config["network_g"]).to(device)
    model.load_state_dict(make_state_dict(config, weight_seed, device), strict=True)
    return ref, model.eval().requires_grad_(False)


def to_input(imgs, device):
    """HWC [0, 1] images -> (B, S, S, 3) in [-1, 1], as the engine maps them."""
    x = torch.from_numpy(np.stack(imgs).astype(np.float32)).to(device)
    return (x - 0.5) / 0.5


def run_reference(ref, model, imgs, seeds, device, block):
    """The reference's outputs for the images and seeds, `block` images at a
    time, concatenated."""
    outs = []
    with torch.no_grad():
        for i in range(0, len(imgs), block):
            out = model(to_input(imgs[i:i + block], device),
                        ref.batch_noise(model, seeds[i:i + block], device))
            outs.append({k: out[k].float() for k in KEYS})
    return {k: torch.cat([o[k] for o in outs]) for k in KEYS}


def errors(outs, refs):
    """{f"{key}_err": the worst image's max |out - ref| / max |ref|}."""
    out = {}
    for k in KEYS:
        a, b = outs[k].float(), refs[k].float()
        n = a.shape[0]
        num = (a - b).abs().reshape(n, -1).amax(dim=1)
        den = b.abs().reshape(n, -1).amax(dim=1).clamp_min(1e-30)
        worst = (num / den).max().item()
        out[f"{k}_err"] = worst if np.isfinite(worst) else float("inf")
    return out


def compare(samples, pool, config, weight_seed, device):
    """samples: [(pool indices, request seeds, {key: output tensor})] of the
    sampled calls. Returns the worst reading of each number over them."""
    with tf32(False):
        ref, model = reference(config, weight_seed, device)
        worst = {f"{k}_err": 0.0 for k in KEYS}
        for idx, seeds, outs in samples:
            refs = run_reference(ref, model, [pool[i] for i in idx], seeds, device,
                                 config["check_block"])
            got = errors({k: outs[k].to(device) for k in KEYS}, refs)
            worst = {k: max(worst[k], got[k]) for k in worst}
    return worst


class ControlSystem:
    """The reference with TF32 on, behind the engine's batched entry."""

    def __init__(self, config, weight_seed, device):
        self.ref, self.model = reference(config, weight_seed, device)
        self.device, self.block = device, config["check_block"]

    def invert_batch_perkey(self, imgs, seeds, outputs=None):
        with tf32(True):
            out = run_reference(self.ref, self.model, imgs, list(seeds), self.device,
                                self.block)
        return out if outputs is None else {k: out[k] for k in outputs}
