"""The ReStyle and FeatureStyle arch families of the port (archs/
ood_restyle.py, archs/ood_featurestyle.py, their encoders nn/encoders/
restyle.py and nn/encoders/feature_style.py, the content injection of
archs/common.py:conditioned_decode) against the JAX package on the CPU,
on seeded parameter trees loaded through the weights bridge with
strict=True and no leftovers.

JAX's ReStyle draws the noise of its internal decodes (the average image,
the refinements) from its 'noise' rng; here it gets the port's noise list
in call order through `flax.linen.intercept_methods` on NoiseInjection,
so both sides decode with the same noise. The JAX archs build their
50-layer encoders at 256px, whatever out_size is.

Tolerances: the encoders within 1e-4 of max|ref|; the archs' image,
gen_image, mask, lats and aligns within 1e-3 of max|ref| (the slice's
bound, tests/test_torch_arch.py); a batched ReStyle reply bit for bit the
lone request's."""

import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err, nchw,
                          nhwc, with_style_mlp)

from ood_gan_inversion_tpu.archs.ood_featurestyle import OODFaceGANFeatureStyle as JFS
from ood_gan_inversion_tpu.archs.ood_restyle import OODFaceGANReStyle as JReStyle
from ood_gan_inversion_tpu.nn.encoders.feature_style import FSEncoderV2 as JFSEncoder
from ood_gan_inversion_tpu.nn.encoders.restyle import ProgressiveBackboneEncoder as JPBE
from ood_gan_inversion_tpu.nn.stylegan2 import NoiseInjection as JNoiseInjection
from ood_gan_inversion_tpu_torch.archs import build_network
from ood_gan_inversion_tpu_torch.archs.ood_featurestyle import OODFaceGANFeatureStyle
from ood_gan_inversion_tpu_torch.archs.ood_restyle import OODFaceGANReStyle
from ood_gan_inversion_tpu_torch.convert import from_jax_params
from ood_gan_inversion_tpu_torch.infer import InversionEngine
from ood_gan_inversion_tpu_torch.losses import id_loss
from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
from ood_gan_inversion_tpu_torch.nn.encoders.feature_style import FSEncoderV2
from ood_gan_inversion_tpu_torch.nn.encoders.restyle import ProgressiveBackboneEncoder
from ood_gan_inversion_tpu_torch.nn.irse import ArcFaceBackbone
from ood_gan_inversion_tpu_torch.nn.stylegan2 import NoiseInjection
from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENCODER_RTOL = 1e-4
SLICE_RTOL = 1e-3
RESTYLE = dict(out_size=64, channel_multiplier=1, narrow=0.125, enc_cycle=2, cycle_align=1,
               warp_scale=0.08)
# the content tensor has 512 channels, the generator's 16px layer 512 * narrow
FEATURESTYLE = dict(out_size=64, channel_multiplier=1, narrow=1.0, cycle_align=1,
                    warp_scale=0.08)


def arch_flat(jcls, cfg, seed):
    x = jnp.zeros((1, cfg["out_size"], cfg["out_size"], 3), jnp.float32)
    flat = with_style_mlp(fill_params(init_shapes(jcls(**cfg), x, mod_size=256), seed),
                          jcls(**cfg), 512, seed=seed + 1)
    assert from_jax_params(flat)[1] == []
    flat["avg_latent"] = 0.3 * np.random.RandomState(seed + 1).randn(
        *flat["avg_latent"].shape).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def restyle_flat():
    """One seeded ReStyle tree for the arch and its encoder's tests."""
    flat = arch_flat(JReStyle, RESTYLE, 2)
    assert flat["avg_latent"].shape == (10, 512)
    return flat


@pytest.fixture(scope="module")
def featurestyle_flat():
    """One seeded FeatureStyle tree for both settings of inject_content (it
    adds no parameter) and its encoder's test."""
    return arch_flat(JFS, FEATURESTYLE, 5)


def encoder_subtree(flat):
    return {k[len("encoder/"):]: v for k, v in flat.items() if k.startswith("encoder/")}


def test_progressive_backbone_encoder_matches_jax(restyle_flat):
    """The ReStyle arch's encoder (6 channels, 10 styles) alone, at 64px:
    at Inference, at stage 3 (four heads active, the others' deltas zero)
    and at stage 0 (WTraining: one W for every layer)."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (2, 64, 64, 6)).astype(np.float32)
    jenc = JPBE(num_layers=50, n_styles=10, input_nc=6)
    flat = encoder_subtree(restyle_flat)
    enc = load_port(ProgressiveBackboneEncoder(50, "ir_se", 10, input_nc=6), flat, "encoder/")
    jfwd = jax.jit(lambda p, xx, stage: jenc.apply({"params": p}, xx, stage=stage),
                   static_argnums=2)
    for stage in (18, 3, 0):
        ref_w, ref_feats = jfwd(jax_tree(flat), jnp.asarray(x), stage)
        with torch.no_grad():
            w, feats = enc(nchw(x), stage)
        assert w.shape == ref_w.shape == (2, 10, 512)
        assert max_rel_err(w.numpy(), ref_w) < ENCODER_RTOL, stage
        assert len(feats) == len(ref_feats) == 5
        for f, r in zip(feats, ref_feats):
            assert max_rel_err(nhwc(f), r) < ENCODER_RTOL, stage
        active = min(stage + 1, 10)
        assert torch.equal(w[:, active:], w[:, :1].expand(-1, 10 - active, -1)), stage


def test_feature_style_encoder_matches_jax(featurestyle_flat):
    """The FeatureStyle arch's encoder (10 styles) alone, at 64px."""
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jenc = JFSEncoder(n_styles=10)
    flat = encoder_subtree(featurestyle_flat)
    enc = load_port(FSEncoderV2(n_styles=10), flat, "encoder/")
    ref_w, ref_c, ref_feats = jax.jit(jenc.apply)({"params": jax_tree(flat)}, jnp.asarray(x))
    with torch.no_grad():
        w, c, feats = enc(nchw(x))
    assert w.shape == ref_w.shape == (2, 10, 512)
    assert max_rel_err(w.numpy(), ref_w) < ENCODER_RTOL
    assert max_rel_err(nhwc(c), ref_c) < ENCODER_RTOL
    assert [tuple(f.shape[1:]) for f in feats] == [(64, 64, 64), (64, 32, 32), (128, 16, 16),
                                                   (256, 8, 8)]
    for f, r in zip(feats, ref_feats):
        assert max_rel_err(nhwc(f), r) < ENCODER_RTOL


def jax_apply_with_noise(jarch, params, x, noise, mod_size=256):
    """JAX's forward with every NoiseInjection that would draw from the
    'noise' rng given the next of `noise` (NCHW numpy arrays, in call
    order) instead."""
    def fwd(p, xx, ns):
        it = iter(ns)

        def feed(next_fun, args, kwargs, context):
            if isinstance(context.module, JNoiseInjection) and context.method_name == "__call__":
                given = kwargs.get("noise", args[1] if len(args) > 1 else None)
                if given is None:
                    return next_fun(args[0], noise=next(it))
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(feed):
            out = jarch.apply({"params": p}, xx, mod_size=mod_size)
        assert next(it, None) is None          # every noise tensor was drawn
        return out

    return jax.jit(fwd)(jax_tree(params), jnp.asarray(x),
                        [jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise])


def assert_outputs_match(out, ref, scales):
    for k in ("image", "gen_image", "mask", "lats"):
        assert out[k].shape == ref[k].shape, k
        assert max_rel_err(out[k].numpy(), ref[k]) < SLICE_RTOL, k
    assert sorted(k for k in out["aligns"] if k <= 4) == scales
    for k in scales:
        assert max_rel_err(out["aligns"][k].numpy(), ref["aligns"][k]) < SLICE_RTOL, k


def test_restyle_arch_matches_jax(restyle_flat):
    """Batch 2. JAX decodes the average image once at batch 1 and tiles
    it; the port decodes it per sample, here with that batch-1 noise
    tiled, so both give the same average image."""
    flat = restyle_flat
    arch = load_port(OODFaceGANReStyle(**RESTYLE), flat)
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    gen = arch.generator
    noise = [rs.randn(*s).astype(np.float32)
             for b in (1, 2, 2) for s in gen.noise_shapes(b)]
    assert len(arch.make_noise(2)) == len(noise) == 3 * gen.num_layers
    ref = jax_apply_with_noise(JReStyle(**RESTYLE), flat, x, noise)
    tiled = [np.repeat(n, 2, axis=0) if n.shape[0] == 1 else n for n in noise]
    with torch.no_grad():
        out = arch(torch.from_numpy(x), mod_size=256,
                   noise=[torch.from_numpy(n) for n in tiled])
    assert_outputs_match(out, ref, [1, 2])


@pytest.mark.parametrize("inject", [False, True], ids=["no_injection", "inject_content"])
def test_featurestyle_arch_matches_jax(inject, featurestyle_flat):
    cfg = dict(FEATURESTYLE, inject_content=inject)
    flat = featurestyle_flat
    arch = load_port(OODFaceGANFeatureStyle(**cfg), flat)
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    noise = [rs.randn(*s).astype(np.float32) for s in arch.generator.noise_shapes(1)]
    ref = jax_apply_with_noise(JFS(**cfg), flat, x, noise)
    with torch.no_grad():
        out = arch(torch.from_numpy(x), mod_size=256,
                   noise=[torch.from_numpy(n) for n in noise])
    assert_outputs_match(out, ref, [1, 2])
    if inject:      # the content really reaches the generator
        with torch.no_grad():
            arch.inject_content = False
            plain = arch(torch.from_numpy(x), mod_size=256,
                         noise=[torch.from_numpy(n) for n in noise])
        assert max_rel_err(plain["gen_image"].numpy(), out["gen_image"].numpy()) > 1e-2


def small_opt(arch_type, **g):
    return {"network_g": {"type": arch_type, "out_size": 64, "channel_multiplier": 1,
                          "narrow": 0.125, "encoder_num_layers": 4, "warp_scale": 0.08,
                          "cycle_align": 2, "ModSize": 256, "stage": "Inference", **g}}


def test_restyle_batched_reply_is_bit_for_bit_the_lone_request():
    """invert_batch_perkey draws every decode's noise per seed at batch 1:
    each sample decodes its own average image and refinements, and its
    reply equals the lone request's, bit for bit."""
    eng = InversionEngine(small_opt("ood_faceGAN_restyle", enc_cycle=3), seed=3,
                          device="cpu")
    for m in eng.net.modules():        # make the noise matter
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.5)
    rs = np.random.RandomState(2)
    imgs = [rs.rand(64, 64, 3).astype(np.float32) for _ in range(3)]
    alone = eng.invert(imgs[0], seed=7)
    batch = eng.invert_batch_perkey([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    split = eng.invert_batch_perkey_split([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    for out in (batch, split):
        for k in ("image", "gen_image", "mask", "lats"):
            assert torch.equal(out[k][2], alone[k][0]), k
    # the seed reaches the internal decodes: another seed, other latents
    other = eng.invert(imgs[0], seed=8)
    assert not torch.equal(other["lats"], alone["lats"])


def test_featurestyle_batched_reply_is_bit_for_bit_the_lone_request():
    """FeatureStyle at three align cycles, as published: a batched reply
    (the iresnet50 trunk, the 18 heads on pools with uneven bins, the
    content branch, the SAMM blocks) equals the lone request's, bit for
    bit, and so does the split entry's."""
    eng = InversionEngine(small_opt("ood_faceGAN_FeatureStyle", cycle_align=3), seed=3,
                          device="cpu")
    for m in eng.net.modules():        # make the noise matter
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.5)
    rs = np.random.RandomState(4)
    imgs = [rs.rand(64, 64, 3).astype(np.float32) for _ in range(3)]
    alone = eng.invert(imgs[0], seed=7)
    batch = eng.invert_batch_perkey([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    split = eng.invert_batch_perkey_split([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    for out in (batch, split):
        for k in ("image", "gen_image", "mask", "lats"):
            assert torch.equal(out[k][2], alone[k][0]), k
    # each sample its own latents, and its seed its own decode
    assert not torch.equal(batch["lats"][0], batch["lats"][1])
    assert not torch.equal(batch["gen_image"][2], eng.invert(imgs[0], seed=8)["gen_image"][0])


def test_featurestyle_engine_and_model_run_and_train_step_refuses(monkeypatch):
    """Once a refusal, now the behaviour that replaced it: a FeatureStyle
    engine inverts, and each family's train_step (ReStyle_Face.yml and
    FeatureStyle_Face.yml's losses on a small arch) takes a fused step on
    the CPU with finite losses and trainable parameters moved, the
    warp-blend through its plain version (no kernel launch)."""
    eng = InversionEngine(small_opt("ood_faceGAN_FeatureStyle", cycle_align=3), seed=0,
                          device="cpu")
    out = eng.invert(np.random.RandomState(0).rand(64, 64, 3).astype(np.float32), seed=1)
    assert out["image"].shape == (1, 64, 64, 3) and bool(torch.isfinite(out["image"]).all())
    rs = np.random.RandomState(1)
    batch = {"gt": rs.uniform(-1, 1, (2, 1, 64, 64, 3)).astype(np.float32),
             "lq_size": rs.rand(2, 1).astype(np.float32)}
    # the identity loss's ArcFace with a 4-layer trunk, as the train tests cut it
    monkeypatch.setattr(id_loss, "ArcFaceBackbone", lambda num_layers: ArcFaceBackbone(4))
    warp_blend.launches = 0
    for arch, yml, g in (("ood_faceGAN_restyle", "ReStyle_Face.yml", {"enc_cycle": 2}),
                         ("ood_faceGAN_FeatureStyle", "FeatureStyle_Face.yml",
                          {"cycle_align": 3})):
        opt = yaml.safe_load((ROOT / "options/train" / yml).read_text())
        opt["network_g"] = small_opt(arch, **g)["network_g"]
        opt["network_d"].update(out_size=64, channel_multiplier=1, narrow=0.125)
        opt["network_d2"].update(chn=10, n_mlp=2)
        model = OODFaceGANModel(opt, device="cpu")
        if arch == "ood_faceGAN_restyle":
            assert len(model.make_noise(1, torch.Generator().manual_seed(0))) == \
                3 * model.net_g.generator.num_layers
        before = {k: p.detach().clone() for k, p in model.train_g.items()}
        logs = model.train_step(batch, 1)
        assert {"l_d", "l_g", "l_pix", "l_bin"} <= set(logs)
        assert all(bool(torch.isfinite(v)) for v in logs.values()), (arch, logs)
        assert any(not torch.equal(p, before[k]) for k, p in model.train_g.items()), arch
    assert warp_blend.launches == 0


@pytest.mark.parametrize("g", [
    {"type": "ood_faceGAN_e4e", "mod_btn": "StyleBottleneckIR"},
    {"type": "ood_faceGAN_restyle", "modulation_type": "SFT"},
    {"type": "ood_faceGAN_FeatureStyle", "encoder": "E4E"},
    {"type": "ood_faceGAN_gpen"},
], ids=["e4e_mod_btn", "restyle_sft", "featurestyle_e4e_encoder", "gpen"])
def test_unported_arch_options_still_raise(g):
    """The options the port once refused now do what JAX's do: a mod_btn
    other than "style_bottleneck_IR" builds no bottleneck; SFT builds and
    raises at decode; an arch type outside the registry raises KeyError.
    The port keeps one refusal of its own: a family's `encoder` key must
    name that family (JAX ignores the key)."""
    opt = {"out_size": 64, "channel_multiplier": 1, "narrow": 0.125, "encoder_num_layers": 4,
           **g}
    if g["type"] == "ood_faceGAN_gpen":
        with pytest.raises(KeyError):
            build_network(opt)
    elif "encoder" in g:
        with pytest.raises(ValueError, match="FeatureStyle encoder"):
            build_network(opt)
    else:
        arch = build_network(opt)
        assert all(m.btn1 is None for m in arch.modulation.values())
        if g.get("modulation_type") == "SFT":
            with pytest.raises(NotImplementedError, match="SFT"), torch.no_grad():
                arch(torch.zeros(1, 64, 64, 3), mod_size=64,
                     generator=torch.Generator().manual_seed(0))
