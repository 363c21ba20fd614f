"""The SAMM options and generator families of the port that no shipped
config uses, against the JAX package on the CPU, on seeded parameter trees
loaded through the weights bridge (strict, nothing left over):

  * nn/stylegan2.py:feature_modulation (SFT, ADD, FUSE);
  * `modulation_type: ADD` (archs/common.py): JAX draws the injection's
    N(0, 1) from its 'noise' rng; here `jax.random.normal` is replaced,
    for the draws of those full-channel shapes only, by the port's own
    draw (the arch's make_noise after the generator's list), so the two
    forwards see the same numbers;
  * `mod_btn: style_bottleneck_IR` (nn/samm.py:StyleBottleneckIR), in a
    forward and in a micro E4E train step (tests/test_torch_train.py's
    Case and tolerances), the bottleneck's leaves among the gradients;
  * the float32 SAMM island of a bfloat16 arch (`samm_fp32_infer`)
    against JAX's with its `_SAMM_FP32_INFER` flag set;
  * GPENGenerator and GCFSRGenerator (its feature blend and condition
    injection).

Tolerances: float32 modules and forwards within 1e-4 of max|ref|; the
bfloat16 island within JAX's own bfloat16 bound (tests/test_arch_e4e.py,
tests/test_torch_bf16.py): the image within 2% of its range, the mask
within 0.02."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import Case, check_grads, check_logs, micro_e4e_opt
from torch_parity import release_freed_memory  # noqa: F401 (autouse)
from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err, nchw,
                          nhwc, with_style_mlp)

from ood_gan_inversion_tpu.archs import common as j_common
from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu.nn.gcfsr import GCFSRGenerator as JGCFSR
from ood_gan_inversion_tpu.nn.stylegan2 import feature_modulation as j_feature_modulation
from ood_gan_inversion_tpu.nn.stylegan2_gpen import GPENGenerator as JGPEN
from ood_gan_inversion_tpu_torch.archs import build_network
from ood_gan_inversion_tpu_torch.archs.ood_e4e import OODFaceGANE4E
from ood_gan_inversion_tpu_torch.nn.gcfsr import GCFSRGenerator
from ood_gan_inversion_tpu_torch.nn.layers import init_weights
from ood_gan_inversion_tpu_torch.nn.samm import StyleBottleneckIR
from ood_gan_inversion_tpu_torch.nn.stylegan2 import STYLEGAN2_CHANNELS, feature_modulation
from ood_gan_inversion_tpu_torch.nn.stylegan2_gpen import GPENGenerator

RTOL = 1e-4
BTN = "style_bottleneck_IR"
# both SAMM scales of a 64px arch (32, 64px), a 4-unit trunk
CFG = dict(out_size=64, channel_multiplier=1, narrow=0.125, encoder_num_layers=4,
           cycle_align=2, warp_scale=0.08)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def arch_case(seed=0, **cfg):
    """(JAX arch, seeded flat tree, the port arch holding it)."""
    cfg = {**CFG, **cfg}
    jarch = JArch(**cfg)
    flat = with_style_mlp(fill_params(init_shapes(jarch, jnp.zeros((1, 64, 64, 3)),
                                                  mod_size=256), seed), jarch, 512, seed + 1)
    dtype = torch.bfloat16 if cfg.pop("dtype", None) == jnp.bfloat16 else torch.float32
    return jarch, flat, load_port(OODFaceGANE4E(**cfg, dtype=dtype), flat)


def jax_forward(jarch, flat, x, noise, n_gen, mod_size=64, **kw):
    """JAX's forward on the port's noise list: the generator's per-layer
    list passed in (in the arch's dtype), the rest (ADD's draws) handed to
    jax.random.normal where it draws a tensor of that shape."""
    extra = {tuple(np.asarray(n).transpose(0, 2, 3, 1).shape):
             np.asarray(n, np.float32).transpose(0, 2, 3, 1) for n in noise[n_gen:]}
    normal = jax.random.normal

    def fed(key, shape=(), dtype=jnp.float32):
        if tuple(shape) in extra:
            return jnp.asarray(extra[tuple(shape)]).astype(dtype)
        return normal(key, shape, dtype)

    jnoise = [jnp.asarray(np.asarray(n, np.float32).transpose(0, 2, 3, 1), jarch.dtype)
              for n in noise[:n_gen]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", fed)
        return jax.jit(lambda p, xx, n: jarch.apply(
            {"params": p}, xx, mod_size=mod_size, noise=n,
            rngs={"noise": jax.random.PRNGKey(0)}, **kw))(jax_tree(flat), jnp.asarray(x), jnoise)


# ------------------------------------------------------- feature_modulation

@pytest.mark.parametrize("mod_type", ["SFT", "ADD", "FUSE"])
@pytest.mark.parametrize("per_class", [False, True])
def test_feature_modulation_matches_jax(mod_type, per_class):
    rs = np.random.RandomState(0)
    g, scale, shift = (rs.randn(2, 4, 5, 3).astype(np.float32) for _ in range(3))
    clss = rs.rand(2).astype(np.float32) if per_class else None
    ref = j_feature_modulation(jnp.asarray(g), (jnp.asarray(scale), jnp.asarray(shift)),
                               None if clss is None else jnp.asarray(clss), mod_type=mod_type)
    got = feature_modulation(nchw(g), (nchw(scale), nchw(shift)),
                             None if clss is None else t(clss), mod_type=mod_type)
    assert max_rel_err(nhwc(got), ref) < 1e-6
    if mod_type == "ADD":
        got = feature_modulation(nchw(g), (None, nchw(shift)), mod_type="ADD")
        assert max_rel_err(nhwc(got), g + shift) < 1e-6


def test_feature_modulation_unknown_type_raises():
    g = torch.ones(1, 1, 2, 2)
    with pytest.raises(NotImplementedError):
        feature_modulation(g, (g, g), mod_type="nope")


# ---------------------------------------------------------- arch options

@pytest.mark.parametrize("opts", [{"modulation_type": "ADD"}, {"mod_btn": BTN},
                                  {"modulation_type": "ADD", "mod_btn": BTN}],
                         ids=["add", "mod_btn", "add_mod_btn"])
def test_arch_option_forward_matches_jax(opts):
    """The E4E arch at 64px with both SAMM scales, NHWC outputs and every
    align within RTOL; ADD's draws are the port's, after the generator's
    list."""
    jarch, flat, arch = arch_case(**opts)
    if "mod_btn" in opts:
        assert isinstance(arch.modulation["3"].btn1, StyleBottleneckIR)
        assert any(k.startswith("modulation_3/btn1/final_conv/") for k in flat)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    noise = arch.make_noise(2, torch.Generator().manual_seed(3))
    n_gen = arch.generator.num_layers
    extra = [tuple(n.shape) for n in noise[n_gen:]]
    assert extra == ([(2, 64, 32, 32), (2, 32, 64, 64)] if "modulation_type" in opts else [])
    ref = jax_forward(jarch, flat, x, noise, n_gen)
    with torch.no_grad():
        out = arch(t(x), mod_size=64, noise=noise)
    for k in ("image", "mask", "gen_image", "lats"):
        assert out[k].shape == ref[k].shape, k
        assert max_rel_err(out[k].numpy(), ref[k]) < RTOL, k
    for k in (1, 2):
        assert max_rel_err(out["aligns"][k].numpy(), ref["aligns"][k]) < RTOL, k


def test_add_injection_draw_is_standard_normal():
    """The port's own draw: at each conditioned layer the output minus the
    aligned feature is the injected N(0, 1) (2 x 64 x 32 x 32 and 2 x 32 x
    64 x 64 samples: mean within 0.02 of 0, std within 0.02 of 1)."""
    arch = init_weights(build_network({"type": "ood_faceGAN_e4e", **CFG,
                                       "modulation_type": "ADD"}), 0).eval()
    seen = {}
    for ind, key in ((1, "3"), (2, "2")):
        idx = ind + 1                       # the stage of layer 2 ind + 3
        arch.modulation[key].register_forward_hook(
            lambda m, a, o, ind=ind: seen.__setitem__(("aligned", ind), o[0]))
        arch.generator.convs[2 * idx + 1].register_forward_pre_hook(
            lambda m, a, ind=ind: seen.__setitem__(("out", ind), a[0]))
    x = torch.rand(2, 64, 64, 3) * 2 - 1
    with torch.no_grad():
        arch(x, mod_size=64, generator=torch.Generator().manual_seed(5))
    for ind in (1, 2):
        n = seen[("out", ind)] - seen[("aligned", ind)]
        assert abs(float(n.mean())) < 0.02 and abs(float(n.std()) - 1.0) < 0.02, ind


@pytest.mark.parametrize("arch_type", ["ood_faceGAN_e4e", "ood_faceGAN_restyle",
                                       "ood_faceGAN_FeatureStyle"])
def test_every_family_builds_the_options(arch_type):
    """ADD and the bottleneck build in all three families, and the
    noise carries ADD's draws after the final decode's list; SFT (with the
    bottleneck's out_ch doubled) and FUSE build and raise at decode."""
    base = {"type": arch_type, "out_size": 64, "channel_multiplier": 1, "narrow": 0.125,
            "encoder_num_layers": 4}
    if arch_type == "ood_faceGAN_FeatureStyle":
        base["narrow"] = 1.0
    for opts in ({"modulation_type": "ADD"}, {"mod_btn": BTN},
                 {"modulation_type": "SFT", "mod_btn": BTN}, {"modulation_type": "FUSE"}):
        arch = build_network({**base, **opts})
        assert (arch.modulation["3"].btn1 is not None) == ("mod_btn" in opts)
        noise = arch.make_noise(1, torch.Generator().manual_seed(0))
        _, dec = arch.split_noise(noise)
        n_add = 2 if opts.get("modulation_type") == "ADD" else 0
        assert len(dec) == arch.generator.num_layers + n_add
        if opts.get("modulation_type") in ("SFT", "FUSE"):
            # the decode raises at its first conditioned layer, as JAX's
            ch = STYLEGAN2_CHANNELS(1, base["narrow"])
            feats = [torch.zeros(1, ch[s], s, s) for s in (256, 128, 64, 32)]
            if arch_type == "ood_faceGAN_FeatureStyle":
                feats = (feats, None)
            with pytest.raises(NotImplementedError, match=opts["modulation_type"]):
                arch.decode_samm(torch.zeros(1, 10, 512), feats, torch.zeros(1, 3, 64, 64),
                                 64, dec)
    sft = build_network({**base, "modulation_type": "SFT", "mod_btn": BTN})
    w = sft.generator.convs[4].conv.weight.shape[0]
    assert sft.modulation["3"].btn1.final_conv.weight.shape[0] == 2 * w


def test_mod_btn_train_step_matches_jax():
    """A micro E4E train step (options/train/E4E_Face.yml cut as
    tests/test_torch_train.py cuts it, NOISE) with the bottleneck: the
    fused step 1, every loss within LOSS_RTOL and every trainable leaf's
    gradient, the bottleneck's too, within GRAD_RTOL, on the seeded state
    of tests/test_torch_train.py's E4E case with the bottleneck's leaves
    added. At step 0 the path-length penalty of this random state is
    2.2e8 (its logs agree within 6e-6), and its gradients differ by up to
    6.6e-3 of a leaf's max in float32 (ROADMAP C)."""
    opt = micro_e4e_opt()
    opt["network_g"]["mod_btn"] = BTN
    case = Case(opt, seed=0)
    jstate, jlogs, model, logs, grads, _ = case.run(1)
    assert "l_g_path" not in logs
    check_logs(jlogs, logs)
    check_grads(jstate.opt_d["grads"], grads["d"])
    check_grads(jstate.opt_g["grads"], grads["g"])
    btn = {k for k in grads["g"] if ".btn1." in k}
    assert btn == {n for n, _ in model.net_g.named_parameters() if ".btn1." in n}
    assert btn <= set(model.train_g)
    # step 1 runs ModSize 32: the 32px block's bottleneck is on the path
    assert all(grads["g"][k].any() for k in btn if k.startswith("modulation.3."))


def test_samm_fp32_island_matches_jax():
    """A bfloat16 arch with samm_fp32_infer against JAX's bfloat16 arch with
    its float32 inference island on (`_SAMM_FP32_INFER`, what
    OGI_SAMM_FP32_INFER=1 sets): same weights and noise, rounded to
    bfloat16 once on the way in."""
    jarch, flat, _ = arch_case(dtype=jnp.bfloat16)
    arch = load_port(OODFaceGANE4E(**CFG, dtype=torch.bfloat16, samm_fp32_infer=True), flat)
    x = np.random.RandomState(2).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    noise = [n.to(torch.bfloat16).float()
             for n in arch.make_noise(2, torch.Generator().manual_seed(4))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "_SAMM_FP32_INFER", True)
        ref = jax_forward(jarch, flat, x, noise, len(noise))
    with torch.no_grad():
        out = arch(t(x), mod_size=64, noise=noise)
    for k in ("image", "mask"):
        assert out[k].shape == ref[k].shape, k
        assert str(out[k].dtype).split(".")[-1] == str(ref[k].dtype), k
    for k in (1, 2):
        assert out["aligns"][k].dtype == torch.float32
    img, img_ref = out["image"].float().numpy(), np.asarray(ref["image"], np.float32)
    assert np.abs(img - img_ref).max() / (img_ref.max() - img_ref.min()) < 0.02
    assert np.abs(out["mask"].float().numpy() - np.asarray(ref["mask"], np.float32)).max() < 0.02


# ------------------------------------------------------ generator families

def gen_case(jcls, pcls, net, seed, size=32, **cfg):
    lats = np.random.RandomState(seed).randn(2, 2 * int(np.log2(size)) - 2, 32)
    jgen = jcls(size=size, style_dim=32, n_mlp=2, channel_multiplier=1, **cfg)
    flat = with_style_mlp(fill_params(init_shapes(jgen, jnp.asarray(lats, jnp.float32)), seed),
                          jgen, 32, seed + 1)
    gen = load_port(pcls(size, 32, 2, 1, **cfg), flat, net=net)
    noise = gen.make_noise(2, torch.Generator().manual_seed(seed))
    return jgen, flat, gen, lats.astype(np.float32), noise


def jnoise(noise):
    return [jnp.asarray(n.numpy().transpose(0, 2, 3, 1)) for n in noise]


def test_gpen_generator_matches_jax():
    """The JAX test's GPEN (32px, narrow 0.5): concatenated full-channel
    noise, so each toRGB and next conv reads twice the conv's width. JAX's
    GPEN without isconcat fails at its first call (its noise weight is
    created outside setup); the port refuses it."""
    jgen, flat, gen, lats, noise = gen_case(JGPEN, GPENGenerator, "gpen", 1, narrow=0.5)
    assert noise[0].shape == (2, 256, 4, 4)
    assert gen.to_rgb1.conv.weight.shape[1] == 512
    ref = jgen.apply({"params": jax_tree(flat)}, jnp.asarray(lats), noise=jnoise(noise))
    with torch.no_grad():
        img = gen(t(lats), noise)
    assert img.shape == (2, 3, 32, 32)
    assert max_rel_err(nhwc(img), ref) < RTOL
    with pytest.raises(NotImplementedError, match="isconcat"):
        GPENGenerator(32, 32, 2, 1, 0.5, isconcat=False)


def test_gcfsr_generator_matches_jax():
    """GCFSR (16px, narrow 0.125, merge concat_modulation): plain; with a
    feature blended into conv1 (sigma (0.5, 0.5)) and into layer 1's pair;
    with SFT, ADD and FUSE conditions injected after layer 1's first
    conv."""
    jgen, flat, gen, lats, noise = gen_case(JGCFSR, GCFSRGenerator, "gcfsr", 2, size=16,
                                            narrow=0.125, merge="concat_modulation")
    assert gen.feat_multiplier == 2
    rs = np.random.RandomState(3)
    feats = [None] * gen.num_layers
    sigmas = [None] * gen.num_layers
    feats[0] = rs.randn(2, 4, 4, 128).astype(np.float32)
    sigmas[0] = np.asarray([[0.5, 0.5], [0.2, 0.9]], np.float32)
    feats[1] = rs.randn(2, 8, 8, 128).astype(np.float32)
    sigmas[1] = sigmas[2] = np.asarray([[0.7, 0.3], [1.0, 0.5]], np.float32)
    cond = tuple(0.3 * rs.randn(2, 8, 8, 128).astype(np.float32) for _ in range(2))
    cases = [({}, {})]
    cases.append(({"feats": [None if f is None else jnp.asarray(f) for f in feats],
                   "sigmas": [None if s is None else jnp.asarray(s) for s in sigmas]},
                  {"feats": [None if f is None else nchw(f) for f in feats],
                   "sigmas": [None if s is None else t(s) for s in sigmas]}))
    for mt in ("SFT", "ADD", "FUSE"):
        cases.append(({"conditions": [tuple(jnp.asarray(c) for c in cond)], "cond_ind": [1],
                       "mod_type": mt},
                      {"conditions": [tuple(nchw(c) for c in cond)], "cond_ind": [1],
                       "mod_type": mt}))
    base = None
    for jkw, pkw in cases:
        ref = jgen.apply({"params": jax_tree(flat)}, jnp.asarray(lats), noise=jnoise(noise),
                         **jkw)
        with torch.no_grad():
            img = gen(t(lats), noise, **pkw)
        assert max_rel_err(nhwc(img), ref) < RTOL, jkw.get("mod_type")
        if base is None:
            base = img
        else:
            assert not torch.allclose(img, base)
