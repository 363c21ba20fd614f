"""The rest of the port's module and loss inventory against the JAX package
on the CPU: pSp's GradualStyleEncoder and the single-W encoder
(nn/encoders/e4e.py), ResNetArcFace and ArcFaceLoss, LPIPS_Loss, the
BasicSR losses of losses/extra.py, `build_loss` over JAX's whole loss
registry, LatentCodesPool and deform_conv2d. Weights are seeded JAX trees
loaded through the bridge (strict, nothing left over); inputs are seeded
numpy arrays. Every value within 1e-4 of max|ref| in float32.

The pool draws from a torch.Generator where JAX's draws from a numpy
RandomState: JAX's pool is handed the port's draws in the port's order.
gradient_penalty_loss gets the interpolation weights
jax.random.uniform draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import release_freed_memory  # noqa: F401 (autouse)
from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err, nchw,
                          nhwc)

from ood_gan_inversion_tpu.losses import build_loss as j_build_loss
from ood_gan_inversion_tpu.losses import extra as j_extra
from ood_gan_inversion_tpu.losses.id_loss import ArcFaceLoss as JArcFaceLoss
from ood_gan_inversion_tpu.losses.lpips_loss import LPIPS_Loss as JLPIPSLoss
from ood_gan_inversion_tpu.nn.arcface_resnet import ResNetArcFace as JResNetArcFace
from ood_gan_inversion_tpu.nn.encoders.e4e import (
    BackboneEncoderUsingLastLayerIntoW as JWEncoder, GradualStyleEncoder as JPSP)
from ood_gan_inversion_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from ood_gan_inversion_tpu.utils import latent_pool as j_latent_pool
from ood_gan_inversion_tpu.utils.registry import LOSS_REGISTRY
from ood_gan_inversion_tpu_torch import losses as tl
from ood_gan_inversion_tpu_torch.nn.arcface_resnet import ResNetArcFace
from ood_gan_inversion_tpu_torch.nn.encoders.e4e import (BackboneEncoderUsingLastLayerIntoW,
                                                         GradualStyleEncoder)
from ood_gan_inversion_tpu_torch.ops.deform_conv import deform_conv2d
from ood_gan_inversion_tpu_torch.utils.latent_pool import LatentCodesPool

RTOL = 1e-4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


# ------------------------------------------------------------- encoders

def test_gradual_style_encoder_matches_jax():
    """pSp's encoder at stylegan_size 64 (10 styles) on a 4-unit trunk at
    256px: every W independent (coarse, middle and fine heads)."""
    jenc = JPSP(num_layers=4, stylegan_size=64)
    x = rand(2, 256, 256, 3, seed=1)
    flat = fill_params(init_shapes(jenc, jnp.asarray(x)), 2)
    enc = load_port(GradualStyleEncoder(4, "ir_se", 64), flat, net="psp")
    ref = jax.jit(jenc.apply)({"params": jax_tree(flat)}, jnp.asarray(x))
    with torch.no_grad():
        w = enc(nchw(x))
    assert w.shape == ref.shape == (2, 10, 512)
    assert max_rel_err(w.numpy(), ref) < RTOL


def test_backbone_w_encoder_matches_jax():
    """The single-W encoder: one W (the JAX test's input) repeated for
    every layer."""
    jenc = JWEncoder(num_layers=4, stylegan_size=64)
    x = rand(1, 256, 256, 3, seed=3)
    flat = fill_params(init_shapes(jenc, jnp.asarray(x)), 4)
    enc = load_port(BackboneEncoderUsingLastLayerIntoW(4, "ir_se", 64), flat, net="w_encoder")
    ref = jax.jit(jenc.apply)({"params": jax_tree(flat)}, jnp.asarray(x))
    with torch.no_grad():
        w = enc(nchw(x))
    assert w.shape == (1, 10, 512)
    assert torch.equal(w[:, 0], w[:, 5])
    assert max_rel_err(w.numpy(), ref) < RTOL


# ---------------------------------------------------------------- ArcFace

@pytest.mark.parametrize("use_se", [False, True])
def test_resnet_arcface_matches_jax(use_se):
    """The JAX test's net (layers [1, 1, 1, 1]) with and without SE."""
    jnet = JResNetArcFace(layers=(1, 1, 1, 1), use_se=use_se)
    x = rand(2, 128, 128, 1, seed=5)
    flat = fill_params(init_shapes(jnet, jnp.asarray(x)), 6)
    net = load_port(ResNetArcFace((1, 1, 1, 1), use_se), flat, net="arcface")
    ref = jax.jit(jnet.apply)({"params": jax_tree(flat)}, jnp.asarray(x))
    with torch.no_grad():
        e = net(nchw(x))
    assert e.shape == (2, 512)
    assert max_rel_err(e.numpy(), ref) < RTOL


def test_arcface_loss_matches_jax():
    """ArcFaceLoss through the registry (loss_weight 2, layers [1, 1, 1,
    1]) on 64px images: the loss and its gradient w.r.t. y_hat, the
    target's embedding carrying none."""
    jloss = JArcFaceLoss(loss_weight=2.0, layers=(1, 1, 1, 1))
    flat = fill_params(init_shapes(jloss.facenet, jnp.zeros((1, 128, 128, 1))), 7)
    loss = tl.build_loss({"type": "ArcFaceLoss", "loss_weight": 2.0, "layers": [1, 1, 1, 1]})
    assert isinstance(loss, tl.ArcFaceLoss)
    load_port(loss.facenet, flat, net="arcface")
    y = rand(1, 64, 64, 3, seed=8, scale=0.3)
    y_hat = y + rand(1, 64, 64, 3, seed=9, scale=0.1)
    p = {"params": jax_tree(flat)}
    ref, ref_g = jax.value_and_grad(lambda a: jloss(p, a, jnp.asarray(y)))(jnp.asarray(y_hat))
    yh = t(y_hat).requires_grad_()
    got = loss(yh, t(y))
    (g,) = torch.autograd.grad(got, yh)
    assert abs(float(got) - float(ref)) <= RTOL * abs(float(ref))
    assert max_rel_err(g.numpy(), ref_g) < RTOL


# ------------------------------------------------------------------ LPIPS

def test_lpips_loss_matches_jax():
    """LPIPS_Loss by the registry on [-1, 1] images: the double normalize
    (min_max (0, 1), then 2x - 1), each reduction, normalize=False; only
    the alex net builds."""
    jloss = JLPIPSLoss(loss_weight=0.5)
    flat = fill_params(jax.eval_shape(lambda r: jloss.init_params(r, 64),
                                      jax.random.PRNGKey(0))["params"], 10)
    x, y = (np.tanh(rand(2, 64, 64, 3, seed=s)) for s in (11, 12))
    p = {"params": jax_tree(flat)}
    for reduction in ("mean", "sum", "none"):
        jl = JLPIPSLoss(loss_weight=0.5, reduction=reduction)
        loss = tl.build_loss({"type": "LPIPS_Loss", "loss_weight": 0.5,
                              "reduction": reduction})
        load_port(loss.net, flat, net="lpips")
        for normalize in (True, False):
            ref, _ = jl(p, jnp.asarray(x), jnp.asarray(y), normalize=normalize)
            with torch.no_grad():
                got, extra = loss(t(x), t(y), normalize=normalize)
            assert extra is None
            assert max_rel_err(got.numpy(), ref) < RTOL, (reduction, normalize)
    with pytest.raises(NotImplementedError, match="alex"):
        tl.build_loss({"type": "LPIPS_Loss", "net": "vgg"})


# ------------------------------------------------------------ extra losses

def test_weighted_tv_loss_matches_jax():
    pred = rand(2, 9, 7, 3, seed=13)
    w = np.abs(rand(2, 9, 7, 3, seed=14))
    for kw in ({}, {"loss_weight": 3.0, "reduction": "sum"}):
        for weight in (None, w):
            ref = j_extra.WeightedTVLoss(**kw)(
                jnp.asarray(pred), None if weight is None else jnp.asarray(weight))
            got = tl.build_loss({"type": "WeightedTVLoss", **kw})(
                t(pred), None if weight is None else t(weight))
            assert max_rel_err(got.numpy(), ref) < RTOL


@pytest.mark.parametrize("gan_type", ["wgan_softplus", "vanilla", "hinge"])
def test_multiscale_gan_loss_matches_jax(gan_type):
    """A list of scales, one of them a list (its last entry counts), and a
    bare tensor; as D and as G."""
    a, b, c = (rand(2, 1, seed=s) for s in (15, 16, 17))
    for preds_np in ([a, [b, c]], [a], a):
        def conv(p, f):
            return [conv(q, f) for q in p] if isinstance(p, list) else f(p)
        for real in (True, False):
            for is_disc in (True, False):
                kw = {"gan_type": gan_type, "loss_weight": 0.5}
                ref = j_extra.MultiScaleGANLoss(**kw)(conv(preds_np, jnp.asarray), real, is_disc)
                got = tl.build_loss({"type": "MultiScaleGANLoss", **kw})(
                    conv(preds_np, t), real, is_disc)
                assert abs(float(got) - float(ref)) <= RTOL * max(abs(float(ref)), 1e-6)


@pytest.mark.parametrize("criterion", ["l1", "l2", "charbonnier"])
def test_gan_feat_loss_matches_jax(criterion):
    """Two discriminators of three maps each (the last, the score, left
    out) and one discriminator's list; the real features get no
    gradient."""
    feats = [[rand(2, 4, 4, 3, seed=20 + 3 * d + i) for i in range(3)] for d in range(2)]
    reals = [[rand(2, 4, 4, 3, seed=40 + 3 * d + i) for i in range(3)] for d in range(2)]
    kw = {"criterion": criterion, "loss_weight": 2.0}
    for f, r in ((feats, reals), (feats[0], reals[0])):
        jf = jax.tree_util.tree_map(jnp.asarray, f)
        jr = jax.tree_util.tree_map(jnp.asarray, r)
        ref = j_extra.GANFeatLoss(**kw)(jf, jr)
        tr = [[t(a).requires_grad_() for a in d] for d in r] if isinstance(r[0], list) \
            else [t(a).requires_grad_() for a in r]
        tf = [[t(a) for a in d] for d in f] if isinstance(f[0], list) else [t(a) for a in f]
        got = tl.build_loss({"type": "GANFeatLoss", **kw})(tf, tr)
        assert abs(float(got) - float(ref)) <= RTOL * abs(float(ref))
        assert got.grad_fn is None
    with pytest.raises(ValueError):
        tl.GANFeatLoss(criterion="nope")


@pytest.mark.parametrize("weighted", [False, True])
def test_gradient_penalty_loss_matches_jax(weighted):
    """WGAN-GP through a small conv critic: the penalty on JAX's
    interpolation weights (jax.random.uniform), and its gradient w.r.t. the
    critic's weights (the penalty's own gradient, through
    create_graph)."""
    k = rand(3, 3, 3, 4, seed=50, scale=0.4)           # HWIO
    lin = rand(4, seed=51)
    real, fake = rand(2, 8, 8, 3, seed=52), rand(2, 8, 8, 3, seed=53)
    weight = np.abs(rand(2, 8, 8, 3, seed=54)) if weighted else None
    rng = jax.random.PRNGKey(5)
    alpha = np.asarray(jax.random.uniform(rng, (2, 1, 1, 1)))

    def j_disc(kk):
        def d(x):
            y = jax.lax.conv_general_dilated(x, kk, (1, 1), "SAME",
                                             dimension_numbers=("NHWC", "HWIO", "NHWC"))
            return (jnp.tanh(y).mean(axis=(1, 2)) @ jnp.asarray(lin))[:, None]
        return d

    def j_loss(kk):
        return j_extra.gradient_penalty_loss(j_disc(kk), jnp.asarray(real), jnp.asarray(fake),
                                             rng, None if weight is None else jnp.asarray(weight))

    ref, ref_g = jax.value_and_grad(j_loss)(jnp.asarray(k))
    kt = t(k.transpose(3, 2, 0, 1)).requires_grad_()

    def p_disc(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), kt, padding=1)
        return (torch.tanh(y).mean(dim=(2, 3)) @ t(lin))[:, None], None

    got = tl.gradient_penalty_loss(p_disc, t(real), t(fake), alpha=t(alpha),
                                   weight=None if weight is None else t(weight))
    (g,) = torch.autograd.grad(got, kt)
    assert abs(float(got) - float(ref)) <= RTOL * abs(float(ref))
    assert max_rel_err(g.permute(2, 3, 1, 0).numpy(), ref_g) < RTOL
    drawn = tl.gradient_penalty_loss(p_disc, t(real), t(fake),
                                     generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn)


def test_build_loss_builds_every_jax_loss_type():
    """Every type of JAX's LOSS_REGISTRY builds in the port from the options
    JAX's builds from (its defaults; PerceptualLoss's required layer
    weights), as a port class of the same name."""
    names = sorted(LOSS_REGISTRY.keys())
    assert {"WeightedTVLoss", "MultiScaleGANLoss", "GANFeatLoss", "LPIPS_Loss",
            "ArcFaceLoss"} <= set(names)
    for name in names:
        opt = {"type": name}
        if name == "PerceptualLoss":
            opt["layer_weights"] = {"conv5_4": 1.0}
        j_build_loss(opt)
        assert type(tl.build_loss(opt)).__name__ == name


# ------------------------------------------------------------- latent pool

class _Replay:
    """A numpy RandomState stand-in replaying the port's draws."""

    def __init__(self, draws):
        self.draws = list(draws)

    def randint(self, n):
        kind, m, v = self.draws.pop(0)
        assert (kind, m) == ("randint", n)
        return v

    def uniform(self):
        kind, _, v = self.draws.pop(0)
        assert kind == "uniform"
        return v


def test_latent_codes_pool_matches_jax():
    """The JAX test's pool (size 4): codes pass through while it fills,
    old codes are replayed later, a W+ code gives one of its rows; the
    same draws give JAX's pool the same outputs and history."""
    pool = LatentCodesPool(4, seed=3)
    draws = []
    randint, uniform = pool.randint, pool.uniform
    pool.randint = lambda n: draws.append(("randint", n, randint(n))) or draws[-1][2]
    pool.uniform = lambda: draws.append(("uniform", None, uniform())) or draws[-1][2]
    queries = [rand(2, 512, seed=0)] + [np.full((2, 512), float(i + 1), np.float32)
                                         for i in range(20)]
    queries.append(rand(2, 10, 512, seed=1))
    outs = [pool.query(t(q)) for q in queries]
    np.testing.assert_array_equal(outs[0].numpy(), queries[0])
    assert any(not np.allclose(o.numpy(), q) for o, q in zip(outs[1:-1], queries[1:-1]))
    assert outs[-1].shape == (2, 512)
    jpool = j_latent_pool.LatentCodesPool(4)
    jpool._rng = _Replay(draws)
    for q, o in zip(queries, outs):
        np.testing.assert_array_equal(jpool.query(q), o.numpy())
    assert not jpool._rng.draws
    for a, b in zip(jpool.ws, pool.ws):
        np.testing.assert_array_equal(a, b.numpy())
    w = t(np.ones((3, 512)))
    assert LatentCodesPool(0).query(w) is w


# ----------------------------------------------------------- deform conv

@pytest.mark.parametrize("stride,masked", [(1, True), (2, False)])
def test_deform_conv2d_matches_jax(stride, masked):
    """JAX's test shapes (offsets of scale 0.7, many taps leaving the
    image), with the mask and bias, and stride 2 without the mask."""
    rs = np.random.RandomState(0)
    n, h, w, cin, cout, k = 2, 8, 8, 4, 6, 3
    ho = (h + 2 - k) // stride + 1
    x = rs.randn(n, h, w, cin).astype(np.float32)
    wgt = rs.randn(k, k, cin, cout).astype(np.float32)
    off = (rs.randn(n, ho, ho, 2 * k * k) * 0.7).astype(np.float32)
    msk = rs.rand(n, ho, ho, k * k).astype(np.float32) if masked else None
    bias = rs.randn(cout).astype(np.float32)
    ref = j_deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt),
                          None if msk is None else jnp.asarray(msk), jnp.asarray(bias),
                          stride=stride, padding=1)
    got = deform_conv2d(nchw(x), nchw(off), t(wgt.transpose(3, 2, 0, 1)),
                        None if msk is None else nchw(msk), t(bias), stride=stride, padding=1)
    assert got.shape == (n, cout, ho, ho)
    assert max_rel_err(nhwc(got), ref) < RTOL


def test_deform_conv2d_zero_offset_equals_conv():
    rs = np.random.RandomState(1)
    x = t(rs.randn(1, 3, 8, 8))
    wgt = t(rs.randn(5, 3, 3, 3))
    got = deform_conv2d(x, torch.zeros(1, 18, 8, 8), wgt)
    assert max_rel_err(got.numpy(), F.conv2d(x, wgt, padding=1).numpy()) < RTOL
