"""Inversion engine (counterpart of infer.py): builds the arch from a
`network_g` option dict, loads or seeds its weights, and inverts images.

Numerics: float32 throughout. The engine turns TF32 off for both cuDNN
convolutions and CUDA matrix products (`torch.backends.cudnn.allow_tf32`,
`torch.backends.cuda.matmul.allow_tf32`), process-wide, so the card
computes what the float32 reference computes. It also restricts cuDNN to
deterministic algorithms and turns its autotuning off, so that a
convolution sums in the same order on every call: a reply is then
bit-identical across calls, which the per-seed contract below needs.

Noise: every request carries an integer seed; its noise comes from its own
`torch.Generator` on the engine's device, and each request is decoded as a
batch of one. A reply therefore depends only on its image and seed, never
on its slot in a batch or on the batch size.

Results stay on the engine's device; reading them on the host waits for
the device.
"""

import os.path as osp

import numpy as np
import torch

from .archs import build_network
from .device import resolve_device
from .nn.layers import init_weights
from .utils.img_util import img2input

# network_g keys that configure training or checkpoint loading, not the arch
_NON_ARCH_KEYS = ("stage", "progressiveModSize", "progressiveStart",
                  "progressiveStep", "progressiveStageSteps", "ModSize")


def load_editing_direction(path, name, intensity=1.0):
    """np.load(<path>/<name>.npy) * intensity."""
    return np.load(osp.join(path, f"{name}.npy")).astype(np.float32) * intensity


class InversionEngine:
    def __init__(self, opt, params=None, seed: int = 0, device="cuda",
                 packed_tail: bool = False, tail_kernel: str = "none",
                 samm_body0: str = "algebraic", samm_conv_kernel: bool = False):
        """opt: option dict with `network_g`; params: a state_dict of the
        arch (e.g. from convert.from_jax_params), loaded strictly; without
        it the weights are drawn from `seed`. packed_tail, tail_kernel: how
        the generator computes its >=512px stages (nn/stylegan2.py); the
        default is the unpacked tail. samm_body0, samm_conv_kernel: how the
        SAMM blocks compute AlignNet's body0 (nn/samm.py); the default is
        the algebraic formulation in plain PyTorch."""
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        g_opt = {k: v for k, v in opt["network_g"].items()
                 if not (k.endswith("_pth") or k.endswith("_pth_key")
                         or k in _NON_ARCH_KEYS)}
        g_opt.update(packed_tail=packed_tail, tail_kernel=tail_kernel,
                     samm_body0=samm_body0, samm_conv_kernel=samm_conv_kernel)
        self.out_size = opt["network_g"].get("out_size", 1024)
        self.mod_size = opt["network_g"].get("ModSize") or 256
        with torch.device(self.device):
            self.net = build_network(g_opt)
        if params is None:
            init_weights(self.net, seed)
        else:
            self.net.load_state_dict(params, strict=True)
        self.net.eval().requires_grad_(False)

    def apply_direction(self, direction):
        """delta_latent += direction ((n_latent, 512) or (1, n_latent, 512))."""
        d = torch.as_tensor(np.asarray(direction, np.float32), device=self.device)
        with torch.no_grad():
            self.net.delta_latent += d.reshape(self.net.delta_latent.shape)

    def _forward(self, x, seed: int):
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.inference_mode():
            return self.net(x, mod_size=self.mod_size, generator=g)

    def _input(self, img01):
        return torch.from_numpy(img2input(img01, self.out_size)).to(self.device)

    def invert(self, img01, seed: int = 0):
        """One HWC [0, 1] RGB image -> the arch's output dict (NHWC, batch 1)."""
        return self._forward(self._input(img01), seed)

    def invert_batch_perkey(self, imgs01, seeds, outputs=None):
        """One seed per image; each image is decoded on its own (see the
        module docstring), the replies are stacked along the batch axis.
        `outputs`: optional tuple of result keys to return (e.g. ("image",
        "mask")); all keys by default."""
        if len(imgs01) != len(seeds):
            raise ValueError(f"{len(imgs01)} images but {len(seeds)} seeds")
        outs = [self._forward(self._input(im), s) for im, s in zip(imgs01, seeds)]
        keys = outputs or tuple(outs[0])
        packed = {}
        for k in keys:
            if k == "aligns":
                packed[k] = {a: torch.cat([o[k][a] for o in outs])
                             for a in outs[0][k]}
            elif outs[0][k] is None:
                packed[k] = None
            else:
                packed[k] = torch.cat([o[k] for o in outs])
        return packed
