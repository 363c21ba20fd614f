"""The port's SAMM AlignNet body0 kernels (B2a, B2b, B5), the options that
route body0 through them, and the halo probe, against the JAX package on
the CPU.

On the CPU the port's kernel wrappers run their plain versions, and the JAX
package runs its Pallas kernels in interpret mode, as its own tests do. The
inputs and weights come from numpy seeds; each test states its tolerance.
The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import importlib
import pathlib
import runpy
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err, nchw,
                          nhwc, with_style_mlp)

from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu.nn.samm import AlignNet as JAlignNet
from ood_gan_inversion_tpu.nn.samm import StyledScaleNShiftBlock as JSAMM
from ood_gan_inversion_tpu.nn.samm import _XavierBottleneckIR as JBottleneck
from ood_gan_inversion_tpu_torch import build, infer
from ood_gan_inversion_tpu_torch.archs.ood_e4e import OODFaceGANE4E
from ood_gan_inversion_tpu_torch.convert import from_jax_params
from ood_gan_inversion_tpu_torch.infer import InversionEngine, default_samm_body0
from ood_gan_inversion_tpu_torch.nn import samm
from ood_gan_inversion_tpu_torch.ops import alignnet, halo_probe, samm_conv

j_pk = importlib.import_module("ood_gan_inversion_tpu.ops.pallas_kernels")
j_samm = importlib.import_module("ood_gan_inversion_tpu.nn.samm")
ROOT = pathlib.Path(__file__).resolve().parent.parent
T = torch.from_numpy
# module-level tolerance, as in tests/test_torch_modules.py: float32 on both
# sides, convolutions summed in another order (XLA vs oneDNN)
MODULE_RTOL = 1e-4
SLICE_RTOL = 1e-3
# (port samm_body0, samm_conv_kernel) -> the JAX flags that select the same path
MODES = {
    ("algebraic", False): dict(_SAMM_FUSED=False, _SAMM_ALGEBRAIC=True, _PALLAS_SAMM=False),
    ("fused", False): dict(_SAMM_FUSED=True, _SAMM_ALGEBRAIC=True, _PALLAS_SAMM=False),
    ("literal", False): dict(_SAMM_FUSED=False, _SAMM_ALGEBRAIC=False, _PALLAS_SAMM=False),
    ("literal", True): dict(_SAMM_FUSED=False, _SAMM_ALGEBRAIC=False, _PALLAS_SAMM=True),
}


def rand(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(np.float32)


def oihw(k):
    return T(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def body0_case(b, h, c, seed):
    """Raw features s, t (NHWC) and body0's weights, HWIO kernels."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    c2 = 2 * c
    a = dict(s=f(b, h, h, c), t=f(b, h, h, c) * 2 + 0.3,
             g1=1 + 0.1 * f(c2), b1=0.1 * f(c2), k1=f(3, 3, c2, c2) / np.sqrt(9 * c2),
             alpha=0.25 + 0.05 * f(c2), k2=f(3, 3, c2, c2) / np.sqrt(9 * c2),
             g2=1 + 0.1 * f(c2), b2=0.1 * f(c2))
    return {k: v.astype(np.float32) for k, v in a.items()}


def port_args(a):
    return (nchw(a["s"]), nchw(a["t"]), T(a["g1"]), T(a["b1"]), oihw(a["k1"]),
            T(a["alpha"]), oihw(a["k2"]), T(a["g2"]), T(a["b2"]))


def jax_args(a):
    return tuple(jnp.asarray(a[k]) for k in ("s", "t", "g1", "b1", "k1", "alpha", "k2", "g2", "b2"))


def counting(monkeypatch, module, name, calls=None):
    """Replaces module.name by a wrapper that appends name to `calls` (a
    new list by default) at each call; returns the list."""
    fn = getattr(module, name)
    calls = [] if calls is None else calls

    def wrapper(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def set_jax_flags(monkeypatch, mode):
    for flag, value in MODES[mode].items():
        monkeypatch.setattr(j_samm, flag, value)


# ------------------------------------------------------------ the kernels


@pytest.mark.parametrize("act", ["prelu", "lrelu", "none"])
def test_conv3x3_act_matches_jax_kernel(act):
    """B5's plain version against JAX's conv3x3_act (its Pallas kernel in
    interpret mode): within 2e-5 abs, the JAX test's own tolerance."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 16, 16, 64).astype(np.float32)
    k = (rs.randn(3, 3, 64, 64) * 0.1).astype(np.float32)
    a = (rs.rand(64) * 0.5).astype(np.float32)
    ref = np.asarray(j_pk.conv3x3_act(jnp.asarray(x), jnp.asarray(k), jnp.asarray(a), act))
    got = samm_conv.conv3x3_act_reference(nchw(x), oihw(k), T(a), act)
    assert np.max(np.abs(nhwc(got) - ref)) <= 2e-5
    wrapped = samm_conv.conv3x3_act(nchw(x), oihw(k), T(a) if act == "prelu" else None, act)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("diff_f_and_g", [True, False])
def test_alignnet_kernel_halves_match_jax_kernels(diff_f_and_g, monkeypatch):
    """B2a's z and B2b's (y2, part), plain versions, against JAX's two Pallas
    kernels (interpret mode, two bands each, so B2b's moments accumulate
    across bands) on the same coefficients: within 1e-5 of max|ref| (sums
    of 9 * 128 float32 terms; part sums 256 pixels of them)."""
    a = body0_case(2, 16, 64, seed=9)
    s, t, g1, b1, k1, alpha, k2 = port_args(a)[:7]
    coeffs, _, _ = alignnet._alignnet_coeffs(s, t, g1, b1, diff_f_and_g, 1e-5)
    j_coeffs, _, _ = j_pk._alignnet_coeffs(jnp.asarray(a["s"]), jnp.asarray(a["t"]),
                                           jnp.asarray(a["g1"]), jnp.asarray(a["b1"]),
                                           diff_f_and_g, 1e-5)
    assert max_rel_err(coeffs.numpy(), j_coeffs) < 1e-6
    outs, pallas_call = [], j_pk.pl.pallas_call

    def spy(*args, **kwargs):
        run = pallas_call(*args, **kwargs)
        return lambda *ops: outs.append(run(*ops)) or outs[-1]

    monkeypatch.setattr(j_pk.pl, "pallas_call", spy)
    y2_ref, part_ref = j_pk._alignnet_pallas(
        jnp.asarray(a["s"]), jnp.asarray(a["t"]), jnp.asarray(coeffs.numpy()),
        jnp.asarray(a["k1"]), jnp.asarray(a["alpha"]), jnp.asarray(a["k2"]),
        band_a=8, band_b=8, cast_bf16=False, interpret=True)
    z_ref = outs[0]
    z = alignnet.alignnet_conv1_reference(s, t, coeffs, k1, alpha)
    y2, part = alignnet.alignnet_conv2_reference(z, k2)
    assert max_rel_err(nhwc(z), z_ref) < 1e-5
    assert max_rel_err(nhwc(y2), y2_ref) < 1e-5
    assert max_rel_err(part.numpy(), part_ref) < 1e-5
    # on CPU tensors the wrappers are the plain versions
    assert torch.equal(alignnet.alignnet_conv1(s, t, coeffs, k1, alpha), z)
    for got, ref in zip(alignnet.alignnet_conv2(z, k2), (y2, part)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("diff_f_and_g", [True, False])
def test_fused_alignnet_body0_matches_jax(diff_f_and_g):
    """The port's fused body0 against JAX's fused body0 (Pallas in
    interpret mode) and against the literal module dataflow: within 1e-4 of
    max|ref|."""
    a = body0_case(2, 16, 64, seed=10)
    ref_fused = np.asarray(j_pk.fused_alignnet_body0(*jax_args(a), diff_f_and_g))
    ref_lit = np.asarray(j_pk.alignnet_body0_reference(*jax_args(a), diff_f_and_g))
    got = nhwc(alignnet.fused_alignnet_body0(*port_args(a), diff_f_and_g))
    assert got.shape == (2, 16, 16, 128)
    assert max_rel_err(got, ref_fused) < MODULE_RTOL
    assert max_rel_err(got, ref_lit) < MODULE_RTOL


# ------------------------------------------------------------ the modules


@pytest.mark.parametrize("conv_kernel", [False, True])
def test_bottleneck_matches_jax(conv_kernel, monkeypatch):
    """_XavierBottleneckIR with and without the conv3x3_act path against
    JAX's with _PALLAS_SAMM set to match: within 1e-4 of max|ref|."""
    x = rand(2, 16, 16, 64, seed=8)
    jmod = JBottleneck(64, 64)
    flat = fill_params(init_shapes(jmod, jnp.asarray(x)), seed=12)
    monkeypatch.setattr(j_samm, "_PALLAS_SAMM", conv_kernel)
    ref = jmod.apply({"params": jax_tree(flat)}, jnp.asarray(x))
    btn = load_port(samm._XavierBottleneckIR(64, 64, conv_kernel), flat,
                    "modulation_0/alignment/body/body0/")
    calls = counting(monkeypatch, samm, "conv3x3_act")
    with torch.no_grad():
        got = btn(nchw(x))
    assert len(calls) == (2 if conv_kernel else 0)
    assert max_rel_err(nhwc(got), ref) < MODULE_RTOL


@pytest.mark.parametrize("mode", list(MODES))
def test_alignnet_matches_jax(mode, monkeypatch):
    """AlignNet in each body0 mode against JAX's with the matching flags:
    within 1e-4 of max|ref|; each mode runs its own path."""
    s, t = rand(2, 16, 16, 64, seed=13, scale=2, shift=0.5), rand(2, 16, 16, 64, seed=14)
    jnet = JAlignNet(64, scale=0.08)
    flat = fill_params(init_shapes(jnet, jnp.asarray(s), jnp.asarray(t)), seed=15)
    set_jax_flags(monkeypatch, mode)
    ref = jnet.apply({"params": jax_tree(flat)}, jnp.asarray(s), jnp.asarray(t))
    net = load_port(samm.AlignNet(64, scale=0.08, samm_body0=mode[0], samm_conv_kernel=mode[1]),
                    flat, "modulation_0/alignment/body/")
    calls = counting(monkeypatch, alignnet, "alignnet_conv1")
    counting(monkeypatch, alignnet, "alignnet_conv2", calls)
    b5 = counting(monkeypatch, samm, "conv3x3_act")
    with torch.no_grad():
        got = net(nchw(s), nchw(t))
    assert len(calls) == (2 if mode[0] == "fused" else 0)
    assert len(b5) == (2 if mode[1] else 0)       # body0's two convs; body1 has Co = 3
    assert max_rel_err(nhwc(got), ref) < MODULE_RTOL


@pytest.mark.parametrize("mode,floor,t_ctx_calls", [
    (("algebraic", False), 64, 1), (("fused", False), 64, 0),
    (("fused", False), 128, 1),     # below the floor: the algebraic form
    (("literal", False), 64, 0), (("literal", True), 64, 0)])
def test_samm_block_two_cycles(mode, floor, t_ctx_calls, monkeypatch):
    """A two-cycle SAMM block with the cross-scale merge in each body0 mode
    against JAX's block with the matching flags (and gate): within 1e-4 of
    max|ref|. The encoder-side t-context is built only where body0 runs
    algebraic."""
    c, size = 64, 16
    feat, gen_feat = rand(2, size, size, c, seed=16), rand(2, size, size, c, seed=17)
    coarse = np.concatenate([np.tanh(rand(2, 8, 8, 2, seed=18)) * 0.08,
                             np.random.RandomState(18).rand(2, 8, 8, 1)], -1).astype(np.float32)
    jmod = JSAMM(c, c, warp_scale=0.08, cycle_align=2)
    args = [jnp.asarray(a) for a in (feat, rand(2, 512), gen_feat, coarse)]
    flat = fill_params(init_shapes(jmod, *args), seed=19)
    set_jax_flags(monkeypatch, mode)
    monkeypatch.setattr(j_samm, "alignnet_body0_supported",
                        lambda h, w, c_, itemsize=2: c_ >= floor)
    ref_out, ref_align = jmod.apply({"params": jax_tree(flat)}, *args)
    monkeypatch.setattr(alignnet, "FUSED_MIN_CHANNELS", floor)
    mod = load_port(samm.StyledScaleNShiftBlock(c, warp_scale=0.08, cycle_align=2,
                                                samm_body0=mode[0], samm_conv_kernel=mode[1]),
                    flat, "modulation_0/")
    ctx = counting(monkeypatch, samm.AlignNet, "t_context")
    with torch.no_grad():
        out, align = mod(nchw(feat), nchw(gen_feat), aligned_coarse=nchw(coarse))
    assert len(ctx) == t_ctx_calls
    assert max_rel_err(nhwc(out), ref_out) < MODULE_RTOL
    assert max_rel_err(nhwc(align), ref_align) < MODULE_RTOL


# ----------------------------------------------------------- whole slice

# all four SAMM scales (C = 64, 32, 16, 8 at 32..256px) and one >=512px stage
SLICE_CFG = dict(out_size=512, channel_multiplier=1, narrow=0.125,
                 encoder_num_layers=4, cycle_align=2, warp_scale=0.08)


@pytest.fixture(scope="module")
def slice_inputs():
    x0 = jnp.zeros((1, 512, 512, 3), jnp.float32)
    flat = with_style_mlp(fill_params(init_shapes(JArch(**SLICE_CFG), x0, mod_size=256), seed=0),
                          JArch(**SLICE_CFG), 512, seed=1)
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    noise = [rs.randn(*s).astype(np.float32)
             for s in OODFaceGANE4E(**SLICE_CFG).generator.noise_shapes(1)]
    state, leftovers = from_jax_params(flat)
    assert leftovers == []
    return flat, x, noise, state


@pytest.mark.parametrize("mode", [("fused", False), ("literal", True)])
def test_whole_slice_matches_jax(slice_inputs, mode, monkeypatch):
    """The 512px narrow slice with every SAMM scale's body0 on the kernel
    path, on both sides (the port's floors lowered, JAX's gates patched),
    against JAX with the matching flags, jitted anew under them: within
    1e-3 of max|ref|, the slice tolerance of tests/test_torch_arch.py."""
    flat, x, noise, _ = slice_inputs
    set_jax_flags(monkeypatch, mode)
    monkeypatch.setattr(j_samm, "alignnet_body0_supported", lambda h, w, c, itemsize=2: c >= 8)
    monkeypatch.setattr(j_samm, "conv3x3_act_supported",
                        lambda h, w, ci, co, itemsize=2: ci >= 16 and co >= 16)
    jarch = JArch(**SLICE_CFG)
    ref = jax.jit(lambda p, x, n: jarch.apply({"params": p}, x, mod_size=256, noise=n))(
        jax_tree(flat), jnp.asarray(x), [jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise])
    monkeypatch.setattr(alignnet, "FUSED_MIN_CHANNELS", 8)
    monkeypatch.setattr(samm_conv, "CONV_ACT_MIN_CHANNELS", 16)
    arch = load_port(OODFaceGANE4E(**SLICE_CFG, samm_body0=mode[0], samm_conv_kernel=mode[1]),
                     flat)
    calls = counting(monkeypatch, alignnet, "alignnet_conv1")
    counting(monkeypatch, alignnet, "alignnet_conv2", calls)
    counting(monkeypatch, samm, "conv3x3_act", calls)
    with torch.no_grad():
        out = arch(T(x), mod_size=256, noise=[T(n) for n in noise])
    assert len(calls) == 16          # 4 scales x 2 cycles x (B2a + B2b, or 2 convs)
    for k in ("image", "mask", "gen_image", "lats"):
        assert tuple(out[k].shape) == ref[k].shape, k
        assert max_rel_err(out[k].numpy(), ref[k]) < SLICE_RTOL, k
    for k in (1, 2, 3, 4):
        assert max_rel_err(out["aligns"][k].numpy(), ref["aligns"][k]) < SLICE_RTOL


# ------------------------------------------------------------- the probe


def test_halo_probe_matches_jax_oracle():
    """box3x3 against the JAX probe's oracle (the zero-halo box sum, a conv
    with a ones kernel) on the probe's own input: within 1e-5 abs (9 float32
    terms of |x| < 5 in another order). The probe's Pallas output is not the
    reference: its window is shifted (see ops/halo_probe.py)."""
    probe = runpy.run_path(str(ROOT / "tools" / "prof" / "prof_pallas_halo.py"))
    x, ref = np.array(probe["x"]), np.asarray(probe["ref"])
    got = halo_probe.box3x3_reference(T(x))
    assert got.shape == (32, 32)
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5
    assert torch.equal(halo_probe.box3x3(T(x)), got)


# ------------------------------------------------- options and operands


@pytest.mark.parametrize("mode", list(MODES))
def test_bridge_loads_strictly_in_every_mode(slice_inputs, mode):
    """The options add no parameter: the bridge's state_dict of the JAX
    tree loads strictly in every mode."""
    state = slice_inputs[3]
    arch = OODFaceGANE4E(**SLICE_CFG, samm_body0=mode[0], samm_conv_kernel=mode[1])
    arch.load_state_dict(state, strict=True)
    assert set(arch.state_dict()) == set(state)


def test_engine_samm_options():
    opt = {"network_g": {"type": "ood_faceGAN_e4e", "out_size": 64,
                         "channel_multiplier": 1, "narrow": 0.125,
                         "encoder_num_layers": 4, "cycle_align": 2}}
    body = InversionEngine(opt, device="cpu").net.modulation["3"].alignment.body
    assert (body.samm_body0, body.body0.conv_kernel) == ("algebraic", False)
    body = InversionEngine(opt, device="cpu", samm_body0="literal",
                           samm_conv_kernel=True).net.modulation["3"].alignment.body
    assert (body.samm_body0, body.body0.conv_kernel, body.body1.conv_kernel) == \
        ("literal", True, True)
    with pytest.raises(ValueError, match="needs samm_body0='literal'"):
        InversionEngine(opt, device="cpu", samm_body0="fused", samm_conv_kernel=True)
    with pytest.raises(ValueError, match="not in"):
        InversionEngine(opt, device="cpu", samm_body0="pallas")
    with pytest.raises(ValueError, match="needs samm_body0='literal'"):
        OODFaceGANE4E(out_size=64, narrow=0.125, encoder_num_layers=4,
                      enable_modulation=False, samm_conv_kernel=True)


@pytest.mark.parametrize("conv_bf16", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
def test_default_samm_body0(device, dtype, conv_bf16):
    """The engine's body0 route when the caller names none: the fused
    kernels on a CUDA device in float32 without samm_conv_bf16 (which only
    the algebraic form serves), the algebraic form everywhere else."""
    fused = torch.device(device).type == "cuda" and dtype == torch.float32 and not conv_bf16
    want = "fused" if fused else "algebraic"
    assert default_samm_body0(device, dtype, conv_bf16) == want
    assert default_samm_body0(torch.device(device), dtype, conv_bf16) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body0", [None, *samm.SAMM_BODY0])
def test_engine_records_its_samm_body0(body0, dtype):
    """An engine keeps an explicit samm_body0 as given and otherwise takes
    default_samm_body0's route (the algebraic form on the CPU); it records
    the route, and every SAMM block runs it."""
    opt = {"network_g": {"type": "ood_faceGAN_e4e", "out_size": 64,
                         "channel_multiplier": 1, "narrow": 0.125,
                         "encoder_num_layers": 4, "cycle_align": 2, "dtype": dtype}}
    eng = InversionEngine(opt, device="cpu", samm_body0=body0)
    want = body0 or "algebraic"
    blocks = [m for m in eng.net.modules() if isinstance(m, samm.SPMWarp)]
    assert eng.samm_body0 == want and len(blocks) == 2
    assert {m.body.samm_body0 for m in blocks} == {want}
    if body0 is None and dtype == "float32":
        assert InversionEngine(opt, device="cpu", samm_conv_bf16=True).samm_body0 == "algebraic"


@pytest.mark.parametrize("given,want", [(None, torch.float32), ("float32", torch.float32),
                                        (torch.float32, torch.float32),
                                        ("bfloat16", torch.bfloat16)])
def test_engine_resolves_its_route_from_the_arch_dtype(monkeypatch, given, want):
    """The engine hands default_samm_body0 the arch's dtype as a torch
    dtype, whether the option file names it (a string, as YAML gives it),
    the caller passes a torch dtype, or it is absent (float32)."""
    seen = []

    def spy(device, dtype, samm_conv_bf16=False):
        seen.append((torch.device(device).type, dtype))
        return "algebraic"

    monkeypatch.setattr(infer, "default_samm_body0", spy)
    g = {"type": "ood_faceGAN_e4e", "out_size": 64, "channel_multiplier": 1,
         "narrow": 0.125, "encoder_num_layers": 4, "cycle_align": 2}
    if given is not None:
        g["dtype"] = given
    InversionEngine({"network_g": g}, device="cpu")
    assert seen == [("cpu", want)]


def test_wrappers_check_operands_and_count_no_cpu_launch():
    before = {f: f.launches for f in (samm_conv.conv3x3_act, alignnet.alignnet_conv1,
                                      alignnet.alignnet_conv2, halo_probe.box3x3)}
    x, k, a = torch.zeros(1, 8, 5, 6), torch.zeros(4, 8, 3, 3), torch.zeros(4)
    assert samm_conv.conv3x3_act(x, k, a).shape == (1, 4, 5, 6)
    with pytest.raises(ValueError, match="act"):
        samm_conv.conv3x3_act(x, k, a, "relu")
    with pytest.raises(ValueError, match="alpha"):
        samm_conv.conv3x3_act(x, k, None, "prelu")
    with pytest.raises(ValueError, match="k must be"):
        samm_conv.conv3x3_act(x, k[:, :4], a)
    with pytest.raises(ValueError, match="k must be"):
        samm_conv.conv3x3_act(x, k.double(), a)
    with pytest.raises(ValueError, match="input must be"):
        samm_conv.conv3x3_act(x.double(), k.double(), a)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        samm_conv.conv3x3_act(x.to("meta"), k.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        samm_conv.conv3x3_act(x, k.to("meta"), a)
    s = torch.zeros(2, 4, 5, 6)
    coeffs, k1, a1 = torch.zeros(2, 5, 4), torch.zeros(8, 8, 3, 3), torch.zeros(8)
    assert alignnet.alignnet_conv1(s, s, coeffs, k1, a1).shape == (2, 8, 5, 6)
    with pytest.raises(ValueError, match="coeffs must be"):
        alignnet.alignnet_conv1(s, s, coeffs[:1], k1, a1)
    with pytest.raises(ValueError, match="t must be"):
        alignnet.alignnet_conv1(s, s[:, :2], coeffs, k1, a1)
    with pytest.raises(ValueError, match="k1 must be"):
        alignnet.alignnet_conv1(s, s, coeffs, k1.bfloat16(), a1)
    y2, part = alignnet.alignnet_conv2(torch.zeros(2, 8, 5, 6), k1)
    assert (y2.shape, part.shape) == ((2, 8, 5, 6), (2, 2, 8))
    with pytest.raises(ValueError, match="k2 must be"):
        alignnet.alignnet_conv2(torch.zeros(2, 8, 5, 6), k1[:4])
    with pytest.raises(ValueError, match="float32 \\(H, W\\)"):
        halo_probe.box3x3(torch.zeros(1, 5, 6))
    assert {f: f.launches for f in before} == before


def test_library_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edited shared header gives every kernel a new library name, so
    the kernels that include it are rebuilt."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("a")
    assert build.library_path("a") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build.library_path("a") != first
    # csrc/tma_conv.cuh, the bfloat16 core of B5, B2a and B2b: an edit
    # rebuilds all three
    csrc = tmp_path / "csrc"
    shutil.copytree(ROOT / "ood_gan_inversion_tpu_torch" / "csrc", csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    for name in ("samm_conv", "alignnet_conv2", "alignnet_conv1"):
        assert '#include "tma_conv.cuh"' in (csrc / f"{name}.cu").read_text()
    names = ("samm_conv", "alignnet_conv2", "alignnet_conv1")
    before = {n: build.library_path(n) for n in names}
    header = csrc / "tma_conv.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(build.library_path(n) != before[n] for n in names)
