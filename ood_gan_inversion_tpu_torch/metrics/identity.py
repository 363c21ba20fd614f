"""Identity metric (counterpart of metrics/identity.py): the cosine
similarity of the ArcFace (IR-SE-50) embeddings of two uint8 HWC images,
1 - the identity loss, on the card (or the device the caller names). The
net is a lazy module-level singleton, as in the JAX package.

Three protocol quirks of the reference are mirrored, not fixed, so that
scores compare with its published protocol:
  * crop_border and test_y_channel are accepted and ignored;
  * [0, 255] maps to x * 2 / 255 - 0.5, in [-0.5, 1.5], not [-1, 1];
  * the BGR image is fed as it is, never flipped to RGB.

Weights: `model_path` names the reference's `model_ir_se50.pth` (a torch
state_dict), read through `convert.from_reference_irse50`. Where the file
is absent the net keeps seeded weights, as JAX's does, and a warning names
the missing path: the shipped configs point at a file the repo does not
hold.
"""

import logging
import os.path as osp

import numpy as np
import torch

from ..convert import from_reference_irse50
from ..device import resolve_device
from ..losses.id_loss import IDLoss
from ..nn.layers import init_weights
from ..utils.registry import METRIC_REGISTRY

logger = logging.getLogger("ood_gan_inversion_tpu_torch")


class IdentityModel:
    """IDLoss's ArcFace net on one device, float32, without grad. params: a
    state_dict of `ArcFaceBackbone` (e.g. `convert.from_jax_params(flat,
    "id")[0]` or `from_reference_irse50(sd)`), loaded strictly; without it
    the weights are seeded."""
    _instance = None
    _instance_path = None
    _warned = set()

    def __init__(self, params=None, device="cuda"):
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.idl = IDLoss(loss_weight=1.0, ref_loss_weight=0.0)
        init_weights(self.idl, 0)
        if params is not None:
            self.idl.facenet.load_state_dict(params, strict=True)
        self.idl.eval().requires_grad_(False)

    @classmethod
    def instance(cls, params=None, model_path=None, device="cuda"):
        """The shared model: rebuilt from params when they are given; loaded
        from model_path when that file exists and is not the one loaded;
        else kept, or built seeded when there is none on this device. A
        missing model_path warns once."""
        dev = resolve_device(device)
        if params is not None:
            cls._instance, cls._instance_path = cls(params, dev), None
        elif model_path is not None and osp.exists(model_path):
            if (cls._instance_path != model_path or cls._instance.device != dev):
                sd = torch.load(model_path, map_location="cpu", weights_only=True)
                cls._instance = cls(from_reference_irse50(sd), dev)
                cls._instance_path = model_path
        else:
            if model_path is not None and model_path not in cls._warned:
                cls._warned.add(model_path)
                logger.warning("identity metric: %s not found; scoring with seeded "
                               "ArcFace weights", model_path)
            if cls._instance is None or cls._instance.device != dev:
                cls._instance, cls._instance_path = cls(None, dev), None
        return cls._instance

    @torch.no_grad()
    def __call__(self, a, b):
        """The identity loss of NHWC float arrays a against b (a float)."""
        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return float(self.idl(t(a), t(b), t(a), mimo_id=False)[0])


@METRIC_REGISTRY.register()
def calculate_identity(img, img2, crop_border=0, input_order="HWC",
                       test_y_channel=False, model_path=None, device="cuda", **kwargs):
    """img, img2: uint8 HWC BGR (`tensor2img`'s output)."""
    if img.shape != img2.shape:
        raise ValueError(f"image shapes differ: {img.shape} and {img2.shape}")

    def prep(a):
        # x * 2 / 255 - 0.5 (not [-1, 1]), channels as they are
        return (a.astype(np.float32) * (2.0 / 255.0) - 0.5)[None]

    model = IdentityModel.instance(model_path=model_path, device=device)
    return 1.0 - model(prep(img), prep(img2))
