"""LPIPS metric (counterpart of metrics/lpips.py): uint8 HWC (BGR) inputs,
crop_border, the AlexNet-LPIPS distance on the card (or the device the
caller names). The net is a lazy module-level singleton, as in the JAX
package.

Two protocol quirks of the reference are mirrored, not fixed, so that
scores compare with its published protocol:
  * [0, 255] maps to x * 2 / 255 - 0.5, in [-0.5, 1.5], not [-1, 1];
  * the BGR image is fed as it is, not flipped to the RGB order the LPIPS
    shift and scale were fit for.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..nn.layers import init_weights
from ..nn.lpips import LPIPS
from ..utils.registry import METRIC_REGISTRY


class LPIPSModel:
    """The LPIPS net on one device, float32, without grad. params: a port
    state_dict (e.g. `convert.from_jax_params(flat, "lpips")[0]`), loaded
    strictly; without it the weights are seeded."""
    _instance = None

    def __init__(self, params=None, device="cuda"):
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.net = LPIPS()
        init_weights(self.net, 0)
        if params is not None:
            self.net.load_state_dict(params, strict=True)
        self.net.eval().requires_grad_(False)

    @classmethod
    def instance(cls, params=None, device="cuda"):
        """The shared model, rebuilt when params are given or the device
        changes."""
        dev = resolve_device(device)
        if cls._instance is None or params is not None or cls._instance.device != dev:
            cls._instance = cls(params, dev)
        return cls._instance

    @torch.no_grad()
    def __call__(self, a, b):
        """(B,) distances of NHWC float arrays or tensors."""
        def nchw(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2)
        return self.net(nchw(a), nchw(b)).cpu().numpy()


@METRIC_REGISTRY.register()
def calculate_lpips(img, img2, crop_border, input_order="HWC",
                    test_y_channel=False, strict_shape=True,
                    model_path=None, device="cuda", **kwargs):
    """img, img2: uint8 HWC BGR (`tensor2img`'s output)."""
    if strict_shape:
        if img.shape != img2.shape:
            raise ValueError(f"image shapes differ: {img.shape} and {img2.shape}")
    else:
        # crop both to the common extent
        h = min(img.shape[0], img2.shape[0])
        w = min(img.shape[1], img2.shape[1])
        c = min(img.shape[2], img2.shape[2])
        img, img2 = img[:h, :w, :c], img2[:h, :w, :c]
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]

    def prep(a):
        # x * 2 / 255 - 0.5 (not [-1, 1]), channels as they are
        a = a.astype(np.float32) * (2.0 / 255.0) - 0.5
        return a[None]

    model = LPIPSModel.instance(device=device)
    return float(model(prep(img), prep(img2))[0])
