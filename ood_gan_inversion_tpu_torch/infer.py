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
On a CUDA device in float32 the SAMM blocks compute AlignNet's body0
through the hand-written B2a and B2b kernels unless the caller names
another route (`default_samm_body0`).

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
norms' moments) runs sample by sample (ops/batch_invariant.py), and the
hand-written kernels sum each sample's tiles in a fixed order, so a reply
from a batched forward is bit-identical to the lone request's. JAX holds
the contract to 1e-5 of max|ref|; in bfloat16 a one-step difference grows
through the SAMM flows to 2.3e-2 to 4.7e-2 of max|ref| at 1024px (measured
on an H100 with batched convolutions, PERF.md), which is why the port
keeps the bits. `invert_batch_perkey_split` decodes each request alone.

Results stay on the engine's device and nothing here waits for the device:
reading a result on the host is the barrier.

While a `torch.profiler` session runs, every public `invert*` call records
the spans of utils/trace.py (the prelude, the forward, each layer
boundary inside it), timed on the host and on the card.

Several devices (parallel/mesh.py): `invert_batch_sharded` and
`invert_batch_perkey_sharded` split a batch and its noise over a mesh's
slots, one forward per slot on its device's replica of the weights,
launched one after another without a host sync between them, the results
put together on the engine's device; a per-sample reply is bit for bit the
unsharded one. `invert_spatial` bands the >= min_h generator stages of
one image over the slots (parallel/spatial.py). A mesh's slots may repeat
a device; each distinct device holds one replica, made at its first use
and made again after `apply_direction`.
"""

import os.path as osp

import numpy as np
import torch

from .archs import arch_dtype, arch_options, build_network
from .device import resolve_device
from .nn.layers import init_weights
from .parallel import spatial
from .parallel.mesh import Replicas, make_mesh, split_batch
from .utils import trace
from .utils.img_util import img2input


def load_editing_direction(path, name, intensity=1.0):
    """np.load(<path>/<name>.npy) * intensity."""
    return np.load(osp.join(path, f"{name}.npy")).astype(np.float32) * intensity


def _cat(outs, device=None):
    """One output dict from several (each a batch along dim 0): tensors
    concatenated (on `device` when given), the aligns dict key by key,
    None kept."""
    def cat(ts):
        return torch.cat([t if device is None else t.to(device) for t in ts])

    packed = {}
    for k, v in outs[0].items():
        if isinstance(v, dict):
            packed[k] = {a: cat([o[k][a] for o in outs]) for a in v}
        else:
            packed[k] = None if v is None else cat([o[k] for o in outs])
    return packed


def default_samm_body0(device, dtype, samm_conv_bf16: bool = False) -> str:
    """The body0 route an engine takes when the caller names none: "fused"
    (B2a and B2b, float32 as 3xTF32 words; nn/samm.py) on a CUDA device in
    float32 without samm_conv_bf16, which only the algebraic form serves;
    "algebraic" otherwise. On the CPU the fused route would run its plain
    versions, and in bfloat16 the algebraic form is JAX's inference
    default, which PARITY.md holds the port to."""
    if (torch.device(device).type == "cuda" and dtype == torch.float32
            and not samm_conv_bf16):
        return "fused"
    return "algebraic"


class InversionEngine:
    def __init__(self, opt, params=None, seed: int = 0, device="cuda",
                 packed_tail: bool = False, tail_kernel: str = "none",
                 samm_body0: str | None = None, samm_conv_kernel: bool = False,
                 samm_fp32_infer: bool = False, samm_conv_bf16: bool = False,
                 samm_warp_bf16: str = "off", samm_gather_bf16: bool = False):
        """opt: option dict with `network_g` (its `dtype`, float32 unless
        given, is the activations' dtype); params: a state_dict of the arch
        (e.g. from convert.from_jax_params), loaded strictly; without it the
        weights are drawn from `seed`. packed_tail, tail_kernel: how the
        generator computes its >=512px stages (nn/stylegan2.py); the default
        is the unpacked tail. samm_body0, samm_conv_kernel: how the SAMM
        blocks compute AlignNet's body0 (nn/samm.py); samm_body0 None takes
        default_samm_body0's route, recorded as `self.samm_body0`.
        samm_fp32_infer: a bfloat16 arch runs its SAMM blocks in float32
        (archs/common.py; off by default, as JAX's OGI_SAMM_FP32_INFER).
        samm_conv_bf16, samm_warp_bf16 ("off", "fit" or "all"),
        samm_gather_bf16: a float32 arch's SAMM convs, warp feature or warp
        taps in bfloat16 (nn/samm.py; off by default, as JAX's
        OGI_SAMM_CONV_BF16, OGI_MXU_WARP_BF16 and OGI_GRIDSAMPLE=gather4bf16
        are on the CPU)."""
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        g_opt = arch_options(opt["network_g"])
        if samm_body0 is None:
            samm_body0 = default_samm_body0(self.device, arch_dtype(g_opt), samm_conv_bf16)
        self.samm_body0 = samm_body0
        g_opt.update(packed_tail=packed_tail, tail_kernel=tail_kernel,
                     samm_body0=samm_body0, samm_conv_kernel=samm_conv_kernel,
                     samm_fp32_infer=samm_fp32_infer, samm_conv_bf16=samm_conv_bf16,
                     samm_warp_bf16=samm_warp_bf16, samm_gather_bf16=samm_gather_bf16)
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
        self.replicas = Replicas(self.net, self.device)

    def apply_direction(self, direction):
        """delta_latent += direction ((n_latent, 512) or (1, n_latent, 512));
        the replicas on other devices are made again at their next use."""
        d = torch.as_tensor(np.asarray(direction, np.float32), device=self.device)
        with torch.no_grad():
            self.net.delta_latent += d.reshape(self.net.delta_latent.shape)
        self.replicas.version += 1

    def _noise(self, seeds):
        """The per-layer noise of a batch with one seed per sample: each
        seed's draw at batch 1, concatenated along the batch axis."""
        with trace.span("noise", len(seeds)):
            draws = [self.net.make_noise(
                1, torch.Generator(device=self.device).manual_seed(int(s)), self.device)
                for s in seeds]
            return [torch.cat(layer) for layer in zip(*draws)]

    def _shared_noise(self, batch, seed):
        """The noise of a batch drawn at its size from one generator (JAX's
        one key)."""
        with trace.span("noise", batch):
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            return self.net.make_noise(batch, g, self.device)

    def _perkey_noise(self, x, seeds):
        """_noise(seeds) for batch x, which must hold one image per seed."""
        if x.shape[0] != len(seeds):
            raise ValueError(f"{x.shape[0]} images but {len(seeds)} seeds")
        return self._noise(seeds)

    def _run(self, x, noise, outputs=None, net=None):
        """The forward of x with its noise through `net` (the engine's own
        by default, or a replica on x's device)."""
        with trace.span("forward", x.shape[0]), torch.inference_mode():
            out = (net or self.net)(x, mod_size=self.mod_size, noise=noise)
        return out if outputs is None else {k: out[k] for k in outputs}

    def input_batch(self, imgs01):
        """HWC [0, 1] RGB images -> the (B, S, S, 3) float32 input on the
        engine's device (through pinned memory on the card, so the upload
        does not wait for work already queued there)."""
        with trace.span("input", len(imgs01)):
            x = torch.from_numpy(np.concatenate(
                [img2input(im, self.out_size) for im in imgs01]))
        with trace.span("upload", len(imgs01)):
            if self.device.type == "cuda":
                return x.pin_memory().to(self.device, non_blocking=True)
            return x.to(self.device)

    def invert(self, img01, seed: int = 0):
        """One HWC [0, 1] RGB image -> the arch's output dict (NHWC, batch 1)."""
        with trace.span("invert", 1):
            return self._dispatch_perkey(self.input_batch([img01]), [seed])

    def invert_batch(self, imgs01, seed: int = 0):
        """A batch decoded with one noise stream for the whole batch (JAX's
        one key): the noise is drawn at the batch's size from one
        generator, so a reply depends on its slot."""
        with trace.span("invert", len(imgs01)):
            x = self.input_batch(imgs01)
            return self._run(x, self._shared_noise(len(imgs01), seed))

    def invert_batch_perkey(self, imgs01, seeds, outputs=None):
        """One seed per image, one batched forward (see the module
        docstring). `outputs`: optional tuple of result keys to return
        (e.g. ("image", "mask")); all keys by default."""
        with trace.span("invert", len(imgs01)):
            return self._dispatch_perkey(self.input_batch(imgs01), seeds, outputs)

    def _dispatch_perkey(self, x, seeds, outputs=None):
        """invert_batch_perkey on a preprocessed batch x (B, S, S, 3) already
        on the engine's device: the entry the batching server calls. Queues
        the work and returns; the caller's read of a result is the
        barrier."""
        return self._run(x, self._perkey_noise(x, seeds), outputs)

    def invert_batch_perkey_split(self, imgs01, seeds, outputs=None):
        """One seed per image, each image decoded alone at batch 1 and the
        replies concatenated: each reply is bit-identical to a lone
        request's."""
        with trace.span("invert", len(imgs01)):
            return self._dispatch_perkey_split(self.input_batch(imgs01), seeds, outputs)

    def _dispatch_perkey_split(self, x, seeds, outputs=None):
        """invert_batch_perkey_split on a device-resident batch: the sharded
        entry over a mesh of one slot per image, all on the engine's
        device. Does not wait for the device."""
        return self._dispatch_perkey_sharded(x, seeds, make_mesh([self.device] * len(seeds)),
                                             outputs)

    # -------------------------------------------------------- several devices
    def _sharded(self, x, noise, mesh, outputs=None):
        """The forward of batch x (B, S, S, 3) with its per-layer noise, both
        split over mesh's slots: one forward per slot on its device's
        replica, queued slot after slot; the outputs (the keys `outputs`, or
        all) concatenated on the engine's device."""
        xs = split_batch(x, mesh)
        parts = [split_batch(t, mesh) for t in noise]
        return _cat([self._run(xs[i], [p[i] for p in parts], outputs, self.replicas.get(dev))
                     for i, dev in enumerate(mesh.slots)], self.device)

    def invert_batch_sharded(self, imgs01, seed: int = 0, mesh=None):
        """invert_batch over a mesh (every visible CUDA device by default):
        one noise stream drawn for the whole batch at its size, as
        invert_batch draws it, then the batch and its noise split over the
        slots. len(imgs01) must divide by the mesh size."""
        mesh = mesh or make_mesh()
        with trace.span("invert", len(imgs01)):
            x = self.input_batch(imgs01)
            return self._sharded(x, self._shared_noise(len(imgs01), seed), mesh)

    def invert_batch_perkey_sharded(self, imgs01, seeds, mesh, outputs=None):
        """invert_batch_perkey over a mesh: one seed per image, the batch
        split over the slots; each reply bit for bit the unsharded one.
        len(imgs01) must divide by the mesh size."""
        with trace.span("invert", len(imgs01)):
            return self._dispatch_perkey_sharded(self.input_batch(imgs01), seeds, mesh,
                                                 outputs)

    def _dispatch_perkey_sharded(self, x, seeds, mesh, outputs=None):
        """invert_batch_perkey_sharded on a batch already on the engine's
        device (the batching server's entry); does not wait for the
        device."""
        return self._sharded(x, self._perkey_noise(x, seeds), mesh, outputs)

    def invert_spatial(self, img01, seed: int = 0, mesh=None, min_h: int = 512):
        """One image with the generator stages of at least min_h rows banded
        over the mesh's slots (every visible CUDA device by default;
        parallel/spatial.py), phase-packed where the engine's packed_tail
        packs them (each band through its tail_kernel); the encoder, the
        coarse stages, SAMM (and the stages it conditions, whose banded
        input is gathered) and the blend run once on the first slot. The
        noise is invert's for `seed`; the result is on the engine's
        device."""
        mesh = mesh or make_mesh(axes=("sp",))
        first = mesh.slots[0]
        with trace.span("invert", 1):
            x = self.input_batch([img01]).to(first)
            noise = [t.to(first) for t in self._noise([seed])]
            with (spatial.banding(mesh, self.replicas, min_h), trace.span("forward", 1),
                  torch.inference_mode()):
                out = self.replicas.get(first)(x, mod_size=self.mod_size, noise=noise)
            return _cat([out], self.device)
