"""H-banded decode of the high-resolution generator stages over a mesh's
slots (counterpart of parallel/spatial.py).

JAX annotates the >= min_h decode activations as sharded along H and lets
GSPMD split each convolution and insert the halo exchanges. PyTorch runs
eagerly, so here the stages themselves run banded: inside `banding(mesh,
replicas, min_h)` every generator stage whose output is at least min_h
rows high (and whose input splits evenly over the slots) runs as one band
of rows per slot, each band on its slot's device. Before each op with a
vertical footprint a band takes the halo rows it needs from its
neighbours' bands; at the image's border the halo is zeros, as the op's
own padding is. The ops and their halos, derived from their padding
(`halo_rows`):

  * the modulated 3x3 conv: 1 row each side;
  * the upsampling modulated conv (a stride-2 transposed 3x3 conv, then
    the 4-tap FIR blur): 1 input row each side;
  * ToRGB's 2x FIR upsample of the skip: 1 input row each side.

The style modulation, the demodulation (which sums over channels and the
kernel, never over space), the noise injection (a band takes its rows of
the noise), the bias and the activation need no exchange. A band computes
its window (band + halos) as an image of its own and keeps its rows.

A phase-packed stage (`Generator.packed_stage`, the generator's
packed_tail) runs banded too, on the coarse grid: its convs are 3x3 there
(conv1, conv2, and the skip's packed upsample), so a band's window takes
PACKED_HALO = 2 coarse rows each side of its own. The window stops at the
image's border instead of padding it: conv1 of a zero row is lrelu(noise +
bias), not the zero that conv2's padding reads, so only the stage's own
border handling (the plain convs' padding, B3's and B4's masked halo
loads) computes the border rows right. The operands that do not depend on
rows (styles, demodulation, the packed kernels) are made once on the
first slot and moved to each band's device; each band takes its window's
rows of the fine noise, packed as `packed_noise` packs them.

SAMM and FeatureStyle's feature injection stay unbanded, as JAX's
docstring keeps "SAMM's instance norms and bounded warps unsharded": the
caller `gather`s a conditioned stage's banded input onto the first slot,
runs the stage whole there, and its anchor bands the output again. The
coarse stages and the blend run once on the first slot, and `gather` puts
the image together there. The anchors (`banded`, `constrain`, `gather`)
sit where JAX calls its `constrain` (nn/stylegan2.py, archs/common.py);
outside `banding` they return at once.

Gradients. Under grad mode a band on a device other than the first slot's
computes with the running module's parameters moved to its device inside
the graph (`_Moved`), so autograd sums every band's gradient onto the
parameters that are trained; the packed stage's operands are moved the
same way. A deep-copied replica's parameters would be leaves of their own,
and the bands' gradients would not reach the trained ones. Without grad
mode (the engine's inference) a band uses its device's cached replica.
Training runs banded by calling `OODFaceGANModel.train_step` inside
`banding(mesh, Replicas(model.net_g, model.device), min_h)`; under a
process group (parallel/dist.py) each rank bands its own rows over its own
slots, the port's counterpart of JAX's 2-D ("data", "sp") mesh.
"""

import contextlib
import itertools
import threading

import torch
from torch import nn

from ..ops.modulated import upsample_blur_pads
from ..ops.upfirdn2d import _resample_pads, upsample2x
from .mesh import canonical

_CTX = threading.local()
# coarse rows a packed stage's band reads beyond its own on each side:
# conv1, then conv2, each 3x3 over the coarse grid
PACKED_HALO = 2


def halo_rows(k: int, pad0: int, up: int = 1):
    """(rows above, rows below) of an op's input that an output band needs
    beyond its own rows: the op upsamples by `up` (zero insertion), pads
    `pad0` rows before, and correlates with a k-tap kernel, so output row R
    reads input rows ceil((R - pad0) / up) .. floor((R - pad0 + k - 1) / up).
    For the band of output rows [up a, up b) that is [a - top, b + bottom)."""
    return pad0 // up, (k - 2 - pad0) // up + 1


class Bands:
    """An activation cut along H (dim 2) into equal bands, band i on slot
    i's device."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def height(self):
        return self.parts[0].shape[2]


class _Moved:
    """A module seen from another device inside the autograd graph: calling
    it runs its forward with every parameter and buffer moved there by
    `.to(device)` (torch.func.functional_call); a submodule attribute is
    another _Moved, a tensor attribute the moved tensor."""

    def __init__(self, module, device):
        object.__setattr__(self, "_module", module)
        object.__setattr__(self, "_device", device)

    def __call__(self, *args):
        m, dev = self._module, self._device
        moved = {n: t.to(dev) for n, t in itertools.chain(m.named_parameters(),
                                                           m.named_buffers())}
        return torch.func.functional_call(m, moved, args)

    def __getattr__(self, name):
        v = getattr(self._module, name)
        if isinstance(v, nn.Module):
            return _Moved(v, self._device)
        return v.to(self._device) if isinstance(v, torch.Tensor) else v


class _State:
    def __init__(self, mesh, replicas, min_h):
        self.slots, self.n, self.min_h = mesh.slots, mesh.size, int(min_h)
        self.replicas = replicas
        self._names = {id(m): name
                       for name, m in replicas.get(self.slots[0]).named_modules()}

    def twin(self, module, device):
        """`module` (a submodule of the arch that runs the decode, on the
        first slot) as band computations on `device` use it: the module
        itself on the first slot; elsewhere under grad mode the module with
        its parameters moved there in the graph, else the device's
        replica."""
        if canonical(device) == canonical(self.slots[0]):
            return module
        if torch.is_grad_enabled():
            return _Moved(module, device)
        return self.replicas.get(device).get_submodule(self._names[id(module)])


@contextlib.contextmanager
def banding(mesh, replicas, min_h: int = 512):
    """Runs the decodes inside the block with their >= min_h stages banded
    over mesh's slots (every slot one band); replicas: a `Replicas` of the
    arch, whose replica on the first slot runs the decodes (and computes
    their unbanded parts)."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = _State(mesh, replicas, min_h)
    try:
        yield
    finally:
        _CTX.state = prev


def _state():
    return getattr(_CTX, "state", None)


def banded(out, conditioned: bool) -> bool:
    """Whether the stage that takes `out` (NCHW, or Bands) runs banded: it
    is not conditioned (SAMM or a feature injection: the caller gathers
    such a stage's input and runs it whole), and its input is banded or
    its output (twice out's height) reaches min_h and out splits evenly
    over the slots."""
    st = _state()
    if st is None or conditioned:
        return False
    if isinstance(out, Bands):
        return True
    h = out.shape[2]
    return 2 * h >= st.min_h and h % st.n == 0


def constrain(x):
    """The anchor after each stage: while banding, a full NCHW activation
    at least min_h high that splits evenly over the slots becomes Bands;
    anything else (Bands, the last banded packed stage's None) is returned
    as it is."""
    st = _state()
    if (st is None or not isinstance(x, torch.Tensor) or x.shape[2] < st.min_h
            or x.shape[2] % st.n):
        return x
    return Bands(part.to(dev) for part, dev in zip(x.chunk(st.n, dim=2), st.slots))


def gather(x):
    """Bands put together on the first slot's device; anything else as it
    is."""
    if not isinstance(x, Bands):
        return x
    dev = x.parts[0].device
    return torch.cat([p.to(dev) for p in x.parts], dim=2)


def _window(parts, i, top, bottom):
    """Band i with `top` rows of band i - 1 above it and `bottom` rows of
    band i + 1 below (zeros beyond the image), on band i's device."""
    band = parts[i]
    hb = band.shape[2]
    if top > hb or bottom > hb:
        raise ValueError(f"a halo of {max(top, bottom)} rows exceeds a band of {hb}")
    shape = list(band.shape)
    rows = []
    if top:
        rows.append(parts[i - 1][:, :, hb - top:].to(band.device) if i > 0
                    else band.new_zeros(shape[:2] + [top, shape[3]]))
    rows.append(band)
    if bottom:
        rows.append(parts[i + 1][:, :, :bottom].to(band.device) if i + 1 < len(parts)
                    else band.new_zeros(shape[:2] + [bottom, shape[3]]))
    return torch.cat(rows, dim=2)


def _rows(parts, a, b, device):
    """Rows [a, b) of the image the bands `parts` cut (dim 2), gathered
    from whichever bands hold them, on `device`."""
    hb = parts[0].shape[2]
    return torch.cat([p[:, :, max(a - j * hb, 0):min(b - j * hb, hb)].to(device)
                      for j, p in enumerate(parts) if j * hb < b and (j + 1) * hb > a], dim=2)


def _halo_apply(parts, i, fn, halo, up=1):
    """fn (size-preserving up to the factor `up`) of band i's window, cut
    back to band i's own rows."""
    top, bottom = halo
    y = fn(_window(parts, i, top, bottom))
    hb = parts[i].shape[2] * up
    return y[:, :, up * top:up * top + hb]


def _as_bands(x, st):
    return x if isinstance(x, Bands) else Bands(
        p.to(dev) for p, dev in zip(x.chunk(st.n, dim=2), st.slots))


def banded_stage(gen, idx, out, skip, l0, l1, l2, noise_a, noise_b):
    """Generator stage idx (convs[2 idx] with its upsampling conv,
    convs[2 idx + 1], to_rgbs[idx]) on banded rows: out and skip (NCHW at
    the stage's input resolution, full or Bands), the three styles and the
    two noises (full, at the output resolution). Phase-packed where the
    generator packs the stage (`banded_packed_stage`). Returns (out, skip)
    as Bands at the output resolution."""
    st = _state()
    out, skip = _as_bands(out, st), _as_bands(skip, st)
    if gen.stage_is_packable(idx):
        return banded_packed_stage(gen, idx, out, skip, l0, l1, l2, noise_a, noise_b)
    conv_a, conv_b, to_rgb = gen.convs[2 * idx], gen.convs[2 * idx + 1], gen.to_rgbs[idx]
    kh = conv_a.conv.weight.shape[-1]
    blur = conv_a.conv.blur_kernel.shape[0]
    # the upsampling conv as one op: zero insertion, a kh-tap conv padded
    # kh - 1, then the blur-tap FIR padded upsample_blur_pads(...)[0]
    halo_a = halo_rows(kh + blur - 1, kh - 1 + upsample_blur_pads(kh, blur)[0], up=2)
    kb = conv_b.conv.weight.shape[-1]
    halo_b = halo_rows(kb, kb // 2)
    rk = to_rgb.blur_kernel.shape[0]
    halo_skip = halo_rows(rk, _resample_pads(rk, 2)[0], up=2)
    hb = 2 * out.height                                  # output rows per band

    def rows(t, i):
        return t[:, :, i * hb:(i + 1) * hb]

    a_parts = []
    for i, dev in enumerate(st.slots):
        ca = st.twin(conv_a, dev)
        s = l0.to(dev)
        y = _halo_apply(out.parts, i, lambda w: ca.conv(w, s), halo_a, up=2)
        a_parts.append(ca.activate(ca.noise(y, rows(noise_a, i).to(dev))))
    b_parts, rgb_parts = [], []
    for i, dev in enumerate(st.slots):
        cb, tr = st.twin(conv_b, dev), st.twin(to_rgb, dev)
        s1, s2 = l1.to(dev), l2.to(dev)
        y = _halo_apply(a_parts, i, lambda w: cb.conv(w, s1), halo_b)
        y = cb.activate(cb.noise(y, rows(noise_b, i).to(dev)))
        rgb = tr.conv(y, s2) + tr.bias.to(y.dtype)[:, None, None]
        rgb = rgb + _halo_apply(skip.parts, i, lambda w: upsample2x(w, tr.blur_kernel),
                                halo_skip, up=2)
        b_parts.append(y)
        rgb_parts.append(rgb)
    return Bands(b_parts), Bands(rgb_parts)


def banded_packed_stage(gen, idx, out, skip, l0, l1, l2, noise_a, noise_b):
    """`Generator.packed_stage` on banded rows (see the module docstring):
    out and skip Bands at the coarse resolution, the styles and the fine
    noises full. Each band runs `Generator.packed_rows` on its window of
    coarse rows, clipped to the image, and keeps its own rows. Returns
    (out, skip) as Bands of NCHW views at the output resolution; for the
    last stage out is None (the decode reads only its skip, and unpacking
    its z2 would copy it)."""
    st = _state()
    h, hb = out.height * st.n, out.height
    ops = gen.packed_operands(idx, l0, l1, l2, out.parts[0].dtype)
    cmid = gen.convs[2 * idx].conv.weight.shape[0]
    last = idx == len(gen.to_rgbs) - 1
    o_parts, s_parts = [], []
    for i, dev in enumerate(st.slots):
        w0, w1 = max(i * hb - PACKED_HALO, 0), min((i + 1) * hb + PACKED_HALO, h)
        x = _rows(out.parts, w0, w1, dev).permute(0, 2, 3, 1).contiguous()
        sk = _rows(skip.parts, w0, w1, dev).permute(0, 2, 3, 1).contiguous()
        rgb, z2 = gen.packed_rows({k: v.to(dev) for k, v in ops.items()}, x, sk,
                                  noise_a[:, :, 2 * w0:2 * w1].to(dev),
                                  noise_b[:, :, 2 * w0:2 * w1].to(dev))
        keep = slice(i * hb - w0, i * hb - w0 + hb)
        if not last:
            o_parts.append(gen.unpack(z2[:, keep], cmid))
        s_parts.append(gen.unpack(rgb[:, keep], 3))
    return (None if last else Bands(o_parts)), Bands(s_parts)
