"""Inversion engine (counterpart of infer.py): builds the arch from a
`network_g` option dict (any of the E4E, ReStyle and FeatureStyle
families), loads or seeds its weights, and inverts images.

Numerics: the arch's dtype, `network_g["dtype"]` (float32 by default, or
bfloat16, the serving config). The engine turns TF32 off for both cuDNN
convolutions and CUDA matrix products (`torch.backends.cudnn.allow_tf32`,
`torch.backends.cuda.matmul.allow_tf32`), and reduced-precision sums off
for bfloat16 matrix products, process-wide, so the card computes what the
reference computes. It also restricts cuDNN to deterministic algorithms and
turns its autotuning off, so that a convolution of a given shape sums in the
same order on every call: a reply is then bit-identical across calls.

Noise: every request carries an integer seed. Its noise is drawn from its
own `torch.Generator(seed)` on the engine's device at batch 1, which is what
a lone request draws; a batch of requests concatenates the draws along the
batch axis and runs one forward (`invert_batch_perkey`). The draw is the
arch's `make_noise`: one decode's per-layer list for E4E and FeatureStyle,
and for ReStyle the lists of all its decodes (the average image, the
refinements, the final decode), so its internal decodes follow the seed
too. A reply's noise
therefore depends only on its seed, never on its slot or the batch size.
So does the rest of the reply: every op whose sums cuDNN, cuBLAS, oneDNN
or PyTorch order by the whole shape (convolutions, matrix products, the
norms' moments) runs sample by sample (ops/batch_invariant.py), so a reply
from a batched forward is bit-identical to the lone request's. JAX holds
the contract to 1e-5 of max|ref|; in bfloat16 a one-step difference grows
through the SAMM flows to 2.3e-2 to 4.7e-2 of max|ref| at 1024px (measured
on an H100 with batched convolutions, PERF.md), which is why the port
keeps the bits. `invert_batch_perkey_split` decodes each request alone.

Results stay on the engine's device and nothing here waits for the device:
reading a result on the host is the barrier.
"""

import os.path as osp

import numpy as np
import torch

from .archs import arch_options, build_network
from .device import resolve_device
from .nn.layers import init_weights
from .utils.img_util import img2input



def load_editing_direction(path, name, intensity=1.0):
    """np.load(<path>/<name>.npy) * intensity."""
    return np.load(osp.join(path, f"{name}.npy")).astype(np.float32) * intensity


def _cat(outs):
    """One output dict from several (each a batch along dim 0): tensors
    concatenated, the aligns dict key by key, None kept."""
    packed = {}
    for k, v in outs[0].items():
        if isinstance(v, dict):
            packed[k] = {a: torch.cat([o[k][a] for o in outs]) for a in v}
        else:
            packed[k] = None if v is None else torch.cat([o[k] for o in outs])
    return packed


class InversionEngine:
    def __init__(self, opt, params=None, seed: int = 0, device="cuda",
                 packed_tail: bool = False, tail_kernel: str = "none",
                 samm_body0: str = "algebraic", samm_conv_kernel: bool = False):
        """opt: option dict with `network_g` (its `dtype`, float32 unless
        given, is the activations' dtype); params: a state_dict of the arch
        (e.g. from convert.from_jax_params), loaded strictly; without it the
        weights are drawn from `seed`. packed_tail, tail_kernel: how the
        generator computes its >=512px stages (nn/stylegan2.py); the default
        is the unpacked tail. samm_body0, samm_conv_kernel: how the SAMM
        blocks compute AlignNet's body0 (nn/samm.py); the default is the
        algebraic formulation in plain PyTorch."""
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        g_opt = arch_options(opt["network_g"])
        g_opt.update(packed_tail=packed_tail, tail_kernel=tail_kernel,
                     samm_body0=samm_body0, samm_conv_kernel=samm_conv_kernel)
        self.out_size = opt["network_g"].get("out_size", 1024)
        self.mod_size = opt["network_g"].get("ModSize") or 256
        with torch.device(self.device):
            self.net = build_network(g_opt)
        self.dtype = self.net.dtype
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

    def _noise(self, seeds):
        """The per-layer noise of a batch with one seed per sample: each
        seed's draw at batch 1, concatenated along the batch axis."""
        draws = [self.net.make_noise(
            1, torch.Generator(device=self.device).manual_seed(int(s)), self.device)
            for s in seeds]
        return [torch.cat(layer) for layer in zip(*draws)]

    def _run(self, x, noise, outputs=None):
        with torch.inference_mode():
            out = self.net(x, mod_size=self.mod_size, noise=noise)
        return out if outputs is None else {k: out[k] for k in outputs}

    def input_batch(self, imgs01):
        """HWC [0, 1] RGB images -> the (B, S, S, 3) float32 input on the
        engine's device (through pinned memory on the card, so the upload
        does not wait for work already queued there)."""
        x = torch.from_numpy(np.concatenate(
            [img2input(im, self.out_size) for im in imgs01]))
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    def invert(self, img01, seed: int = 0):
        """One HWC [0, 1] RGB image -> the arch's output dict (NHWC, batch 1)."""
        return self._dispatch_perkey(self.input_batch([img01]), [seed])

    def invert_batch(self, imgs01, seed: int = 0):
        """A batch decoded with one noise stream for the whole batch (JAX's
        one key): the noise is drawn at the batch's size from one
        generator, so a reply depends on its slot."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        noise = self.net.make_noise(len(imgs01), g, self.device)
        return self._run(self.input_batch(imgs01), noise)

    def invert_batch_perkey(self, imgs01, seeds, outputs=None):
        """One seed per image, one batched forward (see the module
        docstring). `outputs`: optional tuple of result keys to return
        (e.g. ("image", "mask")); all keys by default."""
        return self._dispatch_perkey(self.input_batch(imgs01), seeds, outputs)

    def _dispatch_perkey(self, x, seeds, outputs=None):
        """invert_batch_perkey on a preprocessed batch x (B, S, S, 3) already
        on the engine's device: the entry the batching server calls. Queues
        the work and returns; the caller's read of a result is the
        barrier."""
        if x.shape[0] != len(seeds):
            raise ValueError(f"{x.shape[0]} images but {len(seeds)} seeds")
        return self._run(x, self._noise(seeds), outputs)

    def invert_batch_perkey_split(self, imgs01, seeds, outputs=None):
        """One seed per image, each image decoded alone at batch 1 and the
        replies concatenated: each reply is bit-identical to a lone
        request's."""
        return self._dispatch_perkey_split(self.input_batch(imgs01), seeds, outputs)

    def _dispatch_perkey_split(self, x, seeds, outputs=None):
        """invert_batch_perkey_split on a device-resident batch; does not
        wait for the device."""
        if x.shape[0] != len(seeds):
            raise ValueError(f"{x.shape[0]} images but {len(seeds)} seeds")
        return _cat([self._dispatch_perkey(x[i:i + 1], [s], outputs)
                     for i, s in enumerate(seeds)])
