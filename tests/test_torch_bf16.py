"""The port's bfloat16 serving path against the JAX package's bfloat16 on
the CPU: the plain ops, the norms, one modulated conv, the encoder, the SAMM
block and the whole slice, on the same seeded weights (through the bridge)
and the same inputs, each rounded to bfloat16 once on the way in.

The two sides round differently by design: PyTorch rounds each op's output
to bfloat16, XLA keeps float32 within a fused chain of ops and rounds at
its end; and the port blends the SAMM warp in float32, as JAX's TPU kernel
does, where JAX's CPU route blends in bfloat16 (nn/samm.py). So the bounds
are in bfloat16 steps (2^-8 relative), stated per test:
  * ops, norms: 2^-7 of max|ref| (a step or two at the largest value);
  * one modulated conv: 2^-6 of max|ref| (the input scaled by the style
    and rounded, the conv rounded, the demodulation rounded);
  * the encoder and the SAMM block: 2^-5 of max|ref| (dozens of rounded
    layers; the flows move sample positions);
  * the slice: JAX's own bound for its bfloat16 island against float32
    (tests/test_arch_e4e.py): image within 2% of its range, mask within
    0.02."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err, nhwc,
                          with_style_mlp)

from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu.nn.encoders.e4e import Encoder4Editing as JEncoder
from ood_gan_inversion_tpu.nn.layers import BatchNorm2dEval as JBatchNorm
from ood_gan_inversion_tpu.nn.layers import InstanceNorm2d as JInstanceNorm
from ood_gan_inversion_tpu.nn.samm import StyledScaleNShiftBlock as JSAMM
from ood_gan_inversion_tpu_torch.archs import build_network
from ood_gan_inversion_tpu_torch.archs.ood_e4e import OODFaceGANE4E
from ood_gan_inversion_tpu_torch.infer import InversionEngine
from ood_gan_inversion_tpu_torch.nn.encoders.e4e import Encoder4Editing
from ood_gan_inversion_tpu_torch.nn.layers import BatchNorm2dEval, InstanceNorm2d
from ood_gan_inversion_tpu_torch.nn.samm import StyledScaleNShiftBlock
from ood_gan_inversion_tpu_torch.ops import fused_act, modulated, resize, upfirdn2d
from ood_gan_inversion_tpu_torch.ops.grid_sample import grid_sample_bilinear

j_act, j_gs, j_mod, j_rs, j_fir = (
    importlib.import_module(f"ood_gan_inversion_tpu.ops.{m}") for m in
    ("fused_act", "grid_sample", "modulated", "resize", "upfirdn2d"))

BF16 = torch.bfloat16
OPS_RTOL, CONV_RTOL, MODULE_RTOL = 2.0 ** -7, 2.0 ** -6, 2.0 ** -5
# all four SAMM scales (32..256px) at a narrow width and a 4-unit trunk
CFG = dict(out_size=256, channel_multiplier=1, narrow=0.125, encoder_num_layers=4,
           cycle_align=2, warp_scale=0.08)


def rand(*shape, seed=0, scale=1.0):
    """Seeded normal values, rounded to bfloat16 and back (float32 numpy),
    so both sides start from the same bfloat16 numbers."""
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(BF16).float().numpy()


def tb(a):
    """numpy NHWC -> port NCHW bfloat16."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(BF16)


def jb(a):
    return jnp.asarray(a, jnp.bfloat16)


def f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def check(got, ref, rtol):
    """got (port, bfloat16) within rtol of max|ref| (JAX, bfloat16)."""
    assert got.dtype == BF16
    ref = np.asarray(ref)
    assert ref.dtype == jnp.bfloat16
    err = max_rel_err(f32(got), ref.astype(np.float32))
    assert err <= rtol, err


def _nhwc_t(t):
    return t.permute(0, 2, 3, 1)


def _ops_cases():
    k = j_fir.make_kernel([1, 3, 3, 1])
    x, xs = rand(2, 9, 8, 6), rand(2, 12, 12, 5, seed=3)
    grid = np.tanh(rand(2, 12, 12, 2, seed=4)).astype(np.float32)
    b = rand(6, seed=1)
    return {
        "resize_bilinear": (lambda: _nhwc_t(resize.resize_bilinear(tb(x), (16, 5))),
                            lambda: j_rs.resize_bilinear(jb(x), (16, 5))),
        "resize_bicubic_ac": (lambda: _nhwc_t(resize.resize_bicubic_ac(tb(x), (17, 13))),
                              lambda: j_rs.resize_bicubic_ac(jb(x), (17, 13))),
        "upsample2x": (lambda: _nhwc_t(upfirdn2d.upsample2x(tb(x), k)),
                       lambda: j_fir.upsample2x(jb(x), k)),
        "blur": (lambda: _nhwc_t(upfirdn2d.blur(tb(x), k, pad=(2, 1))),
                 lambda: j_fir.blur(jb(x), jnp.asarray(k, jnp.bfloat16), pad=(2, 1))),
        "fused_leaky_relu": (
            lambda: _nhwc_t(fused_act.fused_leaky_relu(tb(x), torch.from_numpy(b))),
            lambda: j_act.fused_leaky_relu(jb(x), jnp.asarray(b))),
        "grid_sample": (
            lambda: grid_sample_bilinear(torch.from_numpy(xs).to(BF16), torch.from_numpy(grid)),
            lambda: j_gs.grid_sample_bilinear(jb(xs), jnp.asarray(grid))),
    }


@pytest.mark.parametrize("op", list(_ops_cases()))
def test_plain_ops_bf16(op):
    """resize, upfirdn2d, fused_act and the bilinear taps in bfloat16: the
    resize matrices and FIR kernels in the input's dtype on both sides."""
    port, ref = _ops_cases()[op]
    got = port()
    check(got, ref(), OPS_RTOL)


@pytest.mark.parametrize("norm", ["instance_affine", "instance", "batch"])
def test_norms_bf16(norm):
    """Norm statistics in float32, the output in the input's dtype."""
    c = 6
    x = rand(2, 7, 9, c, seed=5, scale=3.0) + 1.5
    g, b = 1.0 + 0.1 * rand(c, seed=6), 0.1 * rand(c, seed=7)
    if norm == "batch":
        jmod = JBatchNorm(c)
        mean, var = 0.2 * rand(c, seed=8), 1.0 + 0.3 * np.abs(rand(c, seed=9))
        params = {"scale": g, "bias": b, "mean": mean, "var": var}
        mod = BatchNorm2dEval(c)
        with torch.no_grad():
            for name, v in (("weight", g), ("bias", b), ("running_mean", mean),
                            ("running_var", var)):
                getattr(mod, name).copy_(torch.from_numpy(v))
    else:
        affine = norm == "instance_affine"
        jmod = JInstanceNorm(c, affine=affine)
        params = {"scale": g, "bias": b} if affine else {}
        mod = InstanceNorm2d(c, affine=affine)
        if affine:
            with torch.no_grad():
                mod.weight.copy_(torch.from_numpy(g))
                mod.bias.copy_(torch.from_numpy(b))
    ref = jmod.apply({"params": params}, jb(x))
    with torch.no_grad():
        got = nhwc(mod(tb(x)).float())
    assert mod(tb(x)).dtype == BF16
    assert np.asarray(ref).dtype == jnp.bfloat16
    assert max_rel_err(got, np.asarray(ref, np.float32)) <= OPS_RTOL


@pytest.mark.parametrize("upsample", [False, True])
def test_modulated_conv_bf16(upsample):
    """One modulated conv layer: bfloat16 input and style scales, float32
    weights cast at use, demodulation computed in float32 then rounded."""
    x = rand(2, 8, 8, 16)
    w = rand(3, 3, 16, 12, seed=1)
    s = 1.0 + 0.2 * rand(2, 16, seed=2)
    bk = j_fir.make_kernel([1, 3, 3, 1])
    got = modulated.modulated_conv2d(
        tb(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(s).to(BF16), upsample=upsample, blur_kernel=bk)
    ref = j_mod.modulated_conv2d(jb(x), jnp.asarray(w), jb(s), upsample=upsample,
                                 blur_kernel=bk)
    check(_nhwc_t(got), ref, CONV_RTOL)


def test_encoder_bf16():
    jenc = JEncoder(num_layers=4, mode="ir_se", stylegan_size=64)
    x = rand(1, 256, 256, 3, scale=0.5)
    flat = fill_params(init_shapes(jenc, jnp.asarray(x)), seed=4)
    w_ref, feats_ref = jax.jit(jenc.apply)({"params": jax_tree(flat)}, jb(x))
    enc = load_port(Encoder4Editing(4, "ir_se", 64), flat, "encoder/")
    with torch.no_grad():
        w, feats = enc(tb(x))
    check(w, w_ref, MODULE_RTOL)
    for f, fr in zip(feats, feats_ref):
        check(_nhwc_t(f), fr, MODULE_RTOL)


def test_samm_block_bf16():
    """One SAMM block in bfloat16 (two align cycles, the coarse merge); its
    warp-blend runs warp_blend's plain version, the kernel's twin."""
    c, size = 16, 32
    jmod = JSAMM(c, c, warp_scale=0.08, cycle_align=2)
    feat, gen_feat = rand(2, size, size, c, seed=7), rand(2, size, size, c, seed=8)
    coarse = np.concatenate([np.tanh(rand(2, 16, 16, 2, seed=9)) * 0.08,
                             np.random.RandomState(9).rand(2, 16, 16, 1)], -1)
    coarse = torch.from_numpy(coarse.astype(np.float32)).to(BF16).float().numpy()
    lat = rand(2, 512, seed=10)
    flat = fill_params(init_shapes(jmod, *(jnp.asarray(a) for a in
                                           (feat, lat, gen_feat, coarse))), seed=11)
    ref_out, ref_align = jmod.apply({"params": jax_tree(flat)}, jb(feat), jb(lat),
                                    jb(gen_feat), aligned_coarse=jb(coarse))
    mod = load_port(StyledScaleNShiftBlock(c, warp_scale=0.08, cycle_align=2), flat,
                    "modulation_0/")
    with torch.no_grad():
        out, align = mod(tb(feat), tb(gen_feat), aligned_coarse=tb(coarse))
    check(_nhwc_t(out), ref_out, MODULE_RTOL)
    check(_nhwc_t(align), ref_align, MODULE_RTOL)


def test_bf16_slice_matches_jax_bf16():
    """The whole arch in bfloat16 against JAX's bfloat16 arch (SAMM in the
    arch dtype, JAX's inference default), the same weights and noise."""
    x = np.random.RandomState(1).uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    flat = with_style_mlp(fill_params(init_shapes(JArch(**CFG), jnp.zeros((1, 256, 256, 3)),
                                              mod_size=256), seed=0), JArch(**CFG), 512, seed=1)
    arch = load_port(OODFaceGANE4E(**CFG, dtype=BF16), flat)
    noise = [rand(*s, seed=20 + i) for i, s in enumerate(arch.generator.noise_shapes(2))]
    jarch = JArch(**CFG, dtype=jnp.bfloat16)
    ref = jax.jit(lambda p, x, n: jarch.apply({"params": p}, x, mod_size=256, noise=n))(
        jax_tree(flat), jnp.asarray(x), [jb(n.transpose(0, 2, 3, 1)) for n in noise])
    with torch.no_grad():
        out = arch(torch.from_numpy(x), mod_size=256,
                   noise=[torch.from_numpy(n) for n in noise])
    for k in ("image", "mask", "gen_image", "lats"):
        assert out[k].dtype == BF16, k
        assert out[k].shape == ref[k].shape, k
    img, img_ref = f32(out["image"]), np.asarray(ref["image"], np.float32)
    assert np.abs(img - img_ref).max() / (img_ref.max() - img_ref.min()) < 0.02
    assert np.abs(f32(out["mask"]) - np.asarray(ref["mask"], np.float32)).max() < 0.02
    for k in (1, 2, 3, 4):
        assert out["aligns"][k].dtype == BF16


def test_dtype_from_options():
    """A YAML dtype string reaches the arch as a torch dtype; the engine runs
    in it; a dtype that is not ported raises."""
    opt = {"type": "ood_faceGAN_e4e", "out_size": 64, "channel_multiplier": 1,
           "narrow": 0.125, "encoder_num_layers": 4, "cycle_align": 1}
    assert build_network({**opt, "dtype": "bfloat16"}).dtype == BF16
    assert build_network(opt).dtype == torch.float32
    with pytest.raises(NotImplementedError):
        build_network({**opt, "dtype": "float16"})
    with pytest.raises(ValueError):
        build_network({**opt, "dtype": "bfloat17"})
    eng = InversionEngine({"network_g": {**opt, "dtype": "bfloat16", "ModSize": 256}},
                          device="cpu")
    out = eng.invert(np.random.RandomState(0).rand(64, 64, 3).astype(np.float32), seed=1)
    assert out["image"].dtype == BF16 and out["mask"].dtype == BF16
    assert all(p.dtype == torch.float32 for p in eng.net.parameters())


def test_bf16_batched_decode():
    """The bfloat16 engine's batched per-seed decode: the split path and the
    batched forward bit for bit a lone request (the contract's bound in
    bfloat16 is 2^-7 of max|ref|; a one-step difference anywhere grows past
    it through the SAMM flows, so the port holds the bits)."""
    opt = {"type": "ood_faceGAN_e4e", "out_size": 64, "channel_multiplier": 1,
           "narrow": 0.125, "encoder_num_layers": 4, "cycle_align": 2,
           "warp_scale": 0.08, "dtype": "bfloat16", "ModSize": 256}
    eng = InversionEngine({"network_g": opt}, seed=2, device="cpu")
    rs = np.random.RandomState(3)
    a, b = (rs.rand(64, 64, 3).astype(np.float32) for _ in range(2))
    alone = eng.invert(a, seed=7)
    split = eng.invert_batch_perkey_split([b, a], [8, 7])
    batch = eng.invert_batch_perkey([b, a], [8, 7])
    for k in ("image", "mask", "gen_image", "lats"):
        assert torch.equal(split[k][1], alone[k][0]), k
        assert torch.equal(batch[k][1], alone[k][0]), k
