"""The port's modules against their JAX counterparts on the CPU, with the
same seeded weights passed through the bridge (convert.from_jax_params) and
the same numpy inputs and noise. Tolerance for modules: 1e-4 of max|ref| --
float32 on both sides, but dozens of layers of convolutions whose sums
accumulate in different orders (XLA vs oneDNN) compound the rounding."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err, nchw,
                          nhwc, with_style_mlp)

from ood_gan_inversion_tpu.nn.encoders.e4e import Encoder4Editing as JEncoder
from ood_gan_inversion_tpu.nn.samm import StyledScaleNShiftBlock as JSAMM
from ood_gan_inversion_tpu.nn.stylegan2 import Generator as JGenerator
from ood_gan_inversion_tpu_torch.nn.encoders.e4e import Encoder4Editing
from ood_gan_inversion_tpu_torch.nn.samm import StyledScaleNShiftBlock
from ood_gan_inversion_tpu_torch.nn.stylegan2 import Generator
from ood_gan_inversion_tpu_torch.ops import alignnet

j_pk = importlib.import_module("ood_gan_inversion_tpu.ops.pallas_kernels")
MODULE_RTOL = 1e-4


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def body0_weights(c2, seed):
    """norm1 affine, k1 (HWIO), PReLU slopes, k2, norm2 affine."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return (1 + 0.1 * f(c2), 0.1 * f(c2), f(3, 3, c2, c2) / np.sqrt(9 * c2),
            0.25 + 0.05 * f(c2), f(3, 3, c2, c2) / np.sqrt(9 * c2),
            1 + 0.1 * f(c2), 0.1 * f(c2))


def oihw(k):
    return torch.from_numpy(k.transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("diff_f_and_g", [True, False])
def test_algebraic_alignnet_body0(diff_f_and_g):
    """With and without the hoisted t-context, against JAX's algebraic
    body0 and against the literal module dataflow (JAX's
    alignnet_body0_reference). Tolerance: module-level, 1e-4 of max|ref|."""
    c = 8
    s, t = rand(2, 12, 12, c, seed=1) * 2 + 0.5, rand(2, 12, 12, c, seed=2)
    g1, b1, k1, al, k2, g2, b2 = body0_weights(2 * c, seed=3)
    jargs = [jnp.asarray(a) for a in (s, t, g1, b1, k1, al, k2, g2, b2)]
    ref_alg = np.asarray(j_pk.algebraic_alignnet_body0(*jargs, diff_f_and_g))
    ref_lit = np.asarray(j_pk.alignnet_body0_reference(*jargs, diff_f_and_g))
    tg = [torch.from_numpy(a) for a in (g1, b1)]
    targs = [nchw(s), nchw(t), *tg, oihw(k1), torch.from_numpy(al), oihw(k2),
             torch.from_numpy(g2), torch.from_numpy(b2)]
    t_ctx = alignnet.alignnet_t_context(nchw(t), tg[0], tg[1], oihw(k1))
    for ctx in (None, t_ctx):
        got = nhwc(alignnet.algebraic_alignnet_body0(*targs, diff_f_and_g, t_ctx=ctx))
        assert max_rel_err(got, ref_alg) < MODULE_RTOL
        assert max_rel_err(got, ref_lit) < MODULE_RTOL
    got_lit = nhwc(alignnet.alignnet_body0_reference(*targs, diff_f_and_g))
    assert max_rel_err(got_lit, ref_lit) < MODULE_RTOL


def test_encoder4editing_4_layer_trunk():
    jenc = JEncoder(num_layers=4, mode="ir_se", stylegan_size=64)
    x = rand(1, 256, 256, 3) * 0.5
    flat = fill_params(init_shapes(jenc, jnp.asarray(x)), seed=4)
    w_ref, feats_ref = jax.jit(jenc.apply)({"params": jax_tree(flat)}, jnp.asarray(x))
    enc = load_port(Encoder4Editing(4, "ir_se", 64), flat, "encoder/")
    with torch.no_grad():
        w, feats = enc(nchw(x))
    assert w.shape == (1, 10, 512)
    assert max_rel_err(w.numpy(), w_ref) < MODULE_RTOL
    assert len(feats) == len(feats_ref) == 5
    for f, fr in zip(feats, feats_ref):
        assert max_rel_err(nhwc(f), fr) < MODULE_RTOL


def test_generator_512_unpacked_vs_jax_packed_tail():
    """The port decodes every stage unpacked; JAX runs its default
    phase-packed path at the 512px stage. Same weights, same noise."""
    jgen = JGenerator(size=512, channel_multiplier=1, narrow=0.125)
    lat = rand(2, 16, 512, seed=5)
    flat = with_style_mlp(fill_params(init_shapes(jgen, jnp.asarray(lat)), seed=6), jgen, 512,
                          seed=7)
    gen = load_port(Generator(512, 512, 1, 0.125), flat, "generator/")
    noise = [rand(*s, seed=10 + i) for i, s in enumerate(gen.noise_shapes(2))]
    ref = jax.jit(lambda p, l, n: jgen.apply({"params": p}, l, noise=n))(
        jax_tree(flat), jnp.asarray(lat),
        [jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise])
    with torch.no_grad():
        got = gen(torch.from_numpy(lat), [torch.from_numpy(n) for n in noise])
    assert got.shape == (2, 3, 512, 512)
    assert max_rel_err(nhwc(got), ref) < MODULE_RTOL


def test_samm_block_two_cycles_with_coarse_merge():
    """One SAMM block: two align cycles, warp-blend, cross-scale merge."""
    c, size = 8, 32
    jmod = JSAMM(c, c, warp_scale=0.08, cycle_align=2)
    feat, gen_feat = rand(2, size, size, c, seed=7), rand(2, size, size, c, seed=8)
    coarse = np.concatenate([np.tanh(rand(2, 16, 16, 2, seed=9)) * 0.08,
                             np.random.RandomState(9).rand(2, 16, 16, 1)],
                            -1).astype(np.float32)
    args = [jnp.asarray(a) for a in (feat, rand(2, 512), gen_feat, coarse)]
    flat = fill_params(init_shapes(jmod, *args), seed=11)
    ref_out, ref_align = jmod.apply({"params": jax_tree(flat)}, *args)
    mod = load_port(StyledScaleNShiftBlock(c, warp_scale=0.08, cycle_align=2), flat,
                    "modulation_0/")
    with torch.no_grad():
        out, align = mod(nchw(feat), nchw(gen_feat), aligned_coarse=nchw(coarse))
    assert max_rel_err(nhwc(out), ref_out) < MODULE_RTOL
    assert max_rel_err(nhwc(align), ref_align) < MODULE_RTOL
