"""The port's losses, discriminators and the ops they need against the JAX
package on the CPU, on the same numpy inputs and, for the nets, the same
seeded weights passed through the bridge (convert.from_jax_params, loaded
strictly with no leaf left over).

Tolerances, each stated where it is used:
  * elementwise losses and small reductions: 1e-5 relative;
  * losses over nets (VGG, ArcFace, the discriminators), and module
    outputs: 1e-4 relative (LOSS_RTOL), or 1e-4 of max|ref| for arrays --
    float32 on both sides, but convolutions sum in another order;
  * gradients: 1e-3 of max|ref| (GRAD_RTOL).
The identity loss runs a 4-layer IR-SE trunk on both sides (the loss's
50-layer trunk has the same layer types; its shapes are checked apart)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import fill_params, jax_tree, max_rel_err

from ood_gan_inversion_tpu import losses as jl
from ood_gan_inversion_tpu.archs.discriminators import (
    LatentDiscriminator as JLatentD, StyleGAN2DiscriminatorMod as JImageD)
from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu.losses.gan_loss import path_regularize_stats as j_path_stats
from ood_gan_inversion_tpu.losses.gan_loss import r1_penalty_fn as j_r1
from ood_gan_inversion_tpu.nn.irse import ArcFaceBackbone as JArcFace
from ood_gan_inversion_tpu.ops.resize import adaptive_avg_pool as j_adaptive_avg_pool
from ood_gan_inversion_tpu.ops.stats import minibatch_stddev as j_minibatch_stddev
from ood_gan_inversion_tpu.ops.upfirdn2d import downsample2x as j_downsample2x
from ood_gan_inversion_tpu.ops.upfirdn2d import make_kernel as j_make_kernel
from ood_gan_inversion_tpu_torch import losses as tl
from ood_gan_inversion_tpu_torch.archs import build_network
from ood_gan_inversion_tpu_torch.archs.discriminators import (
    LatentDiscriminator, StyleGAN2DiscriminatorMod)
from ood_gan_inversion_tpu_torch.archs.ood_e4e import OODFaceGANE4E
from ood_gan_inversion_tpu_torch.convert import from_jax_params
from ood_gan_inversion_tpu_torch.losses.gan_loss import path_regularize_stats, r1_penalty_fn
from ood_gan_inversion_tpu_torch.losses.perceptual import gram_matrix
from ood_gan_inversion_tpu_torch.nn.irse import ArcFaceBackbone
from ood_gan_inversion_tpu_torch.ops.resize import adaptive_avg_pool
from ood_gan_inversion_tpu_torch.ops.stats import minibatch_stddev
from ood_gan_inversion_tpu_torch.ops.upfirdn2d import downsample2x, make_kernel

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
LAYERS = {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1, "conv4_4": 1, "conv5_4": 1}


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rtol):
    got = float(got.detach()) if torch.is_tensor(got) else float(got)
    want = float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), (got, want)


def shapes_of(init, *args):
    """The parameter tree of a flax init, traced without computing."""
    return jax.eval_shape(lambda r: init(r, *args), jax.random.PRNGKey(0))["params"]


def equal_lr_fill(shapes, seed):
    """Equalized-lr nets' leaves at their init scale: weights N(0, 1),
    other leaves 0.1 N(0, 1)."""
    flat = fill_params(shapes, seed)
    rs = np.random.RandomState(seed + 1)
    return {k: (rs.randn(*v.shape) if k.endswith("weight") else 0.1 * rs.randn(*v.shape)
                ).astype(np.float32) for k, v in flat.items()}


def load(module, flat, net):
    state, leftovers = from_jax_params(flat, net)
    assert leftovers == []
    module.load_state_dict(state, strict=True)
    return module.eval()


# ------------------------------------------------------------ plain losses

@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan", "wgan_softplus", "hinge"])
def test_gan_loss_matches_jax(gan_type):
    """Every type, real and fake, D and G sides. 1e-5 relative."""
    pred = rand(4, 1, seed=1, scale=2.0)
    j = jl.GANLoss(gan_type, real_label_val=0.9, fake_label_val=0.1, loss_weight=0.5)
    p = tl.GANLoss(gan_type, real_label_val=0.9, fake_label_val=0.1, loss_weight=0.5)
    for real in (True, False):
        for disc in (True, False):
            close(p(t(pred), real, is_disc=disc), j(jnp.asarray(pred), real, is_disc=disc), 1e-5)


@pytest.mark.parametrize("cls", ["L1Loss", "MSELoss", "CharbonnierLoss"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_pixel_losses_match_jax(cls, reduction):
    """Weighted and unweighted, each reduction. 1e-5 of max|ref|."""
    a, b, w = rand(2, 8, 8, 3, seed=2), rand(2, 8, 8, 3, seed=3), np.abs(rand(2, 8, 8, 3, seed=4))
    j = getattr(jl, cls) if hasattr(jl, cls) else getattr(jl.basic, cls)
    j, p = j(loss_weight=0.7, reduction=reduction), getattr(tl, cls)(0.7, reduction)
    for weight in (None, w):
        got = p(t(a), t(b), None if weight is None else t(weight))
        ref = j(jnp.asarray(a), jnp.asarray(b), None if weight is None else jnp.asarray(weight))
        assert max_rel_err(got.numpy(), ref) < 1e-5


def test_r1_penalty_matches_jax():
    """D(x) = sum(x^2) per sample (grad 2x), and a D with a parameter: the
    penalty and its gradient w.r.t. the parameter (second order). 1e-5."""
    x = rand(3, 4, 4, 2, seed=5)
    w = rand(4, 4, 2, seed=6)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    j_val, j_grad = jax.value_and_grad(
        lambda w_: j_r1(lambda im: jnp.sum(jnp.square(im) * w_, axis=(1, 2, 3)), jx))(jw)
    tw = t(w).requires_grad_()
    got = r1_penalty_fn(lambda im: (im.square() * tw).sum(dim=(1, 2, 3)), t(x))
    (g,) = torch.autograd.grad(got, tw)
    close(got, j_val, 1e-5)
    assert max_rel_err(g.numpy(), j_grad) < 1e-5
    close(r1_penalty_fn(lambda im: (im.square().sum(dim=(1, 2, 3)),), t(x)),
          np.mean(np.sum((2 * x) ** 2, axis=(1, 2, 3))), 1e-5)


def test_path_regularize_stats_matches_jax():
    g = rand(4, 18, 64, seed=7)
    got = path_regularize_stats(t(g), torch.tensor(0.3))
    ref = j_path_stats(jnp.asarray(g), 0.3)
    for a, b in zip(got, ref):
        close(a, b, 1e-5)
    assert not got[2].requires_grad


def test_mask_loss_matches_jax():
    """The tests/test_losses.py case, and random aligns at every SAMM size
    plus the full-size composite, both targets. 1e-5 relative."""
    kw = dict(loss_weight=2.0, loss_func={"binary": [8], "area": {"8": 0.25},
                                          "target": 1, "binary_weight": 0.5})
    align = np.concatenate([np.zeros((1, 8, 8, 2)), np.full((1, 8, 8, 1), 0.75)],
                           -1).astype(np.float32)
    got = tl.MaskLoss(**kw)({1: t(align)})
    close(got[0], 0.25 * 0.5 * 2.0, 1e-6)
    close(got[1], (0.75 - 0.25) * 2.0, 1e-6)
    rs = np.random.RandomState(8)
    aligns = {i + 1: rs.rand(2, s, s, 3).astype(np.float32)
              for i, s in enumerate((32, 64, 128, 256))}
    aligns[1024] = np.repeat(rs.rand(2, 1024, 1024, 1).astype(np.float32), 3, -1)
    for target in (0, 1):
        kw = dict(loss_weight=5.0, loss_func={
            "binary": [32, 64, 128, 256, 1024], "target": target, "binary_weight": 0.04,
            "area": {"32": 0.3, "64": 0.3, "128": 0.2, "256": 0.2, "1024": 0.2}})
        got = tl.MaskLoss(**kw)({k: t(v) for k, v in aligns.items()})
        ref = jl.MaskLoss(**kw)({k: jnp.asarray(v) for k, v in aligns.items()})
        for a, b in zip(got, ref):
            close(a, b, 1e-5)


def test_build_loss_registry():
    loss = tl.build_loss({"type": "MSELoss", "loss_weight": 2.0})
    assert isinstance(loss, tl.MSELoss)
    close(loss(torch.ones(2, 2), torch.zeros(2, 2)), 2.0, 1e-7)
    assert isinstance(tl.build_loss({"type": "GANLoss", "gan_type": "hinge"}), tl.GANLoss)
    assert isinstance(tl.build_loss({"type": "LPIPS_Loss"}), tl.LPIPS_Loss)
    with pytest.raises(KeyError):
        tl.build_loss({"type": "NoSuchLoss"})
    with pytest.raises(KeyError):
        tl.build_loss({"loss_weight": 1.0})


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize("b", [2, 4, 8])
def test_minibatch_stddev_matches_jax(b):
    """Group-major grouping (sample i with i +- b/group); 1e-5 of max|ref|.
    At b = 8 with group 4 a neighbour grouping would differ."""
    x = rand(b, 4, 4, 6, seed=b)
    x[::2] *= 3.0
    ref = j_minibatch_stddev(jnp.asarray(x), 4, 1)
    got = minibatch_stddev(t(x.transpose(0, 3, 1, 2)), 4, 1)
    assert got.shape == (b, 7, 4, 4)
    assert max_rel_err(got.permute(0, 2, 3, 1).numpy(), ref) < 1e-5


def test_adaptive_avg_pool_matches_jax_and_torch():
    """300 -> 112 (non-integer ratio, uneven bins) and 64 -> 112
    (upsampling bins): against JAX and F.adaptive_avg_pool2d, 1e-5."""
    for size in (300, 64):
        x = rand(2, size, size, 3, seed=size)
        ref = j_adaptive_avg_pool(jnp.asarray(x), (112, 112))
        got = adaptive_avg_pool(t(x.transpose(0, 3, 1, 2)), (112, 112))
        assert max_rel_err(got.permute(0, 2, 3, 1).numpy(), ref) < 1e-5
        lib = torch.nn.functional.adaptive_avg_pool2d(t(x.transpose(0, 3, 1, 2)), 112)
        assert max_rel_err(got.numpy(), lib.numpy()) < 1e-5


def test_downsample2x_matches_jax():
    x = rand(2, 16, 16, 5, seed=9)
    k = (1, 3, 3, 1)
    ref = j_downsample2x(jnp.asarray(x), j_make_kernel(k))
    got = downsample2x(t(x.transpose(0, 3, 1, 2)), make_kernel(k))
    assert got.shape == (2, 5, 8, 8)
    assert max_rel_err(got.permute(0, 2, 3, 1).numpy(), ref) < 1e-5


# ---------------------------------------------------------- the discriminators

D_CFG = dict(out_size=64, channel_multiplier=1, narrow=0.25)


def test_image_discriminator_matches_jax():
    """StyleGAN2Discriminator_mod at 64px, b = 4 (one stddev group of 4):
    score and both features, 1e-4 of max|ref|; the
    gradient of the mean score w.r.t. the image and the first conv's
    weight, 1e-3 of max|ref|."""
    jd = JImageD(**D_CFG)
    x = rand(4, 64, 64, 3, seed=10)
    flat = equal_lr_fill(shapes_of(jd.init, jnp.asarray(x)), seed=11)
    d = load(build_network({"type": "StyleGAN2Discriminator_mod", **D_CFG}), flat, "d")
    assert isinstance(d, StyleGAN2DiscriminatorMod)

    def jscore(p, im):
        return jnp.mean(jd.apply({"params": p}, im)[0])

    ref_s, ref_f = jd.apply({"params": jax_tree(flat)}, jnp.asarray(x))
    ref_gp, ref_gx = jax.grad(jscore, argnums=(0, 1))(jax_tree(flat), jnp.asarray(x))
    tx = t(x).requires_grad_()
    score, feats = d(tx)
    assert score.shape == (4, 1)
    assert max_rel_err(score.detach().numpy(), ref_s) < LOSS_RTOL
    for f, rf in zip(feats, ref_f):
        assert max_rel_err(f.detach().numpy(), rf) < LOSS_RTOL
    w = d.d.conv0.conv.weight
    gx, gw = torch.autograd.grad(score.mean(), [tx, w])
    assert max_rel_err(gx.numpy(), ref_gx) < GRAD_RTOL
    assert max_rel_err(gw.numpy().transpose(2, 3, 1, 0),
                       ref_gp["d"]["conv0"]["conv"]["weight"]) < GRAD_RTOL


def test_latent_discriminator_matches_jax():
    jd = JLatentD(chn=10, dim=64, n_mlp=2, hidden_chn=4)
    lat = rand(3, 10, 64, seed=12)
    flat = equal_lr_fill(shapes_of(jd.init, jnp.asarray(lat)), seed=13)
    d = load(LatentDiscriminator(chn=10, dim=64, n_mlp=2, hidden_chn=4), flat, "d2")
    ref, none = jd.apply({"params": jax_tree(flat)}, jnp.asarray(lat))
    got, nothing = d(t(lat))
    assert none is None and nothing is None
    assert max_rel_err(got.detach().numpy(), ref) < LOSS_RTOL


def test_style_mlp_and_random_latents_match_jax():
    """The arch's random_latents (pixel norm, n_mlp lr_mul-0.01 layers,
    repeated to W+) at n_mlp 2 with the style MLP loaded strictly."""
    cfg = dict(out_size=64, channel_multiplier=1, narrow=0.125, encoder_num_layers=4, n_mlp=2)
    jarch = JArch(**cfg)
    z = rand(3, 512, seed=14)
    rs = np.random.RandomState(15)
    shapes = shapes_of(lambda r, zz: jarch.init(r, zz, method=JArch.random_latents),
                       jnp.asarray(z))
    flat = {k: (rs.randn(*v.shape) * (100.0 if k.endswith("weight") else 0.1)).astype(np.float32)
            for k, v in fill_params(shapes, 0).items()}
    arch = OODFaceGANE4E(**cfg)
    state, leftovers = from_jax_params(flat)
    assert leftovers == []
    state = {k: v for k, v in state.items() if k.startswith("generator.style.")}
    assert sorted(state) == ["generator.style.0.bias", "generator.style.0.weight",
                             "generator.style.1.bias", "generator.style.1.weight"]
    arch.generator.style.load_state_dict(
        {k[len("generator.style."):]: v for k, v in state.items()}, strict=True)
    ref = jarch.apply({"params": jax_tree(flat)}, jnp.asarray(z), method=JArch.random_latents)
    got = arch.random_latents(t(z))
    assert got.shape == (3, 10, 512)
    assert max_rel_err(got.detach().numpy(), ref) < LOSS_RTOL


# ------------------------------------------------------------ loss nets

def test_perceptual_loss_matches_jax():
    """E4E_Face.yml's perceptual_opt (five layers, range_norm, style 50):
    perceptual and style terms, the features/compare split, the gradient
    w.r.t. the image, and the Gram matrix; 32px images."""
    kw = dict(layer_weights=LAYERS, use_input_norm=True, range_norm=True,
              perceptual_weight=1.0, style_weight=50, criterion="l1")
    jp = jl.PerceptualLoss(**kw)
    x, gt = rand(2, 32, 32, 3, seed=16), rand(2, 32, 32, 3, seed=17)
    shapes = jax.eval_shape(lambda r: jp.init(r, (1, 32, 32, 3)), jax.random.PRNGKey(0))
    flat = fill_params(shapes["params"], seed=18)
    jparams = {"params": jax_tree(flat)}
    pl = tl.PerceptualLoss(**kw)
    load(pl.vgg, flat, "vgg")
    ref_p, ref_s = jp(jparams, jnp.asarray(x), jnp.asarray(gt))
    ref_g = jax.grad(lambda xx: sum(jp(jparams, xx, jnp.asarray(gt))))(jnp.asarray(x))
    tx = t(x).requires_grad_()
    p, s = pl(tx, t(gt))
    close(p, ref_p, LOSS_RTOL)
    close(s, ref_s, LOSS_RTOL)
    (g,) = torch.autograd.grad(p + s, tx)
    assert max_rel_err(g.numpy(), ref_g) < GRAD_RTOL
    p2, s2 = pl.compare(pl.features(t(x)), pl.features(t(gt)))
    close(p2, p, 1e-6)
    feat = rand(2, 6, 5, 4, seed=19)
    ref_gram = jl.perceptual.gram_matrix(jnp.asarray(feat.transpose(0, 2, 3, 1)))
    assert max_rel_err(gram_matrix(t(feat)).numpy(), ref_gram) < 1e-5


def _id_losses(**kw):
    """JAX's and the port's IDLoss with 4-layer IR-SE trunks, the same
    seeded weights."""
    jid = jl.IDLoss(**kw)
    jid.facenet = JArcFace(num_layers=4)
    flat = fill_params(shapes_of(jid.facenet.init, jnp.zeros((1, 112, 112, 3))), seed=20)
    pid = tl.IDLoss(**kw)
    pid.facenet = load(ArcFaceBackbone(num_layers=4), flat, "id")
    return jid, {"params": jax_tree(flat)}, pid


@pytest.mark.parametrize("size", [64, 256])
def test_id_loss_matches_jax(size):
    """Single-view and MIMO (K = 2, scores picking view 1 while the
    closest view differs, and tied scores) at 64px (no crop) and 256px
    (the face crop): the loss and the reference term, relative 1e-4; the
    gradient w.r.t. y_hat within GRAD_RTOL of max|ref| plus twice JAX's
    own float32 error against the port run in float64. The cross-output
    term compares nearly parallel unit embeddings, and at 256px both
    frameworks' float32 gradients sit ~1e-3 of max|ref| off a float64
    evaluation (the port the closer one); elsewhere that error is ~1e-6."""
    jid, jparams, pid = _id_losses(loss_weight=0.1, ref_loss_weight=0.5)
    pid64 = copy.deepcopy(pid).double()
    y_hat, y = rand(2, 2, size, size, 3, seed=21), rand(2, 2, size, size, 3, seed=22)
    y_hat = (0.5 * y + 0.5 * y_hat).astype(np.float32)

    def jloss(a, yy, score, mimo):
        loss, ref = jid(jparams, a, yy, yy, mimo_id=mimo, score=score)
        return loss + ref, (loss, ref)

    jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True), static_argnums=3)
    cases = [(False, y_hat[:, 0], y[:, 0], np.ones((2, 1), np.float32))]
    cases += [(True, y_hat, y, score) for score in (np.array([[0.0, 1.0], [1.0, 0.0]], np.float32),
                                                   np.ones((2, 2), np.float32))]
    for mimo, yh, yy, score in cases:
        (_, (ref_l, ref_r)), ref_g = jgrad(jnp.asarray(yh), jnp.asarray(yy),
                                           jnp.asarray(score), mimo)
        grads = []
        for net, dt in ((pid, torch.float32), (pid64, torch.float64)):
            th = t(yh).to(dt).requires_grad_()
            loss, ref = net(th, t(yy).to(dt), t(yy).to(dt), mimo_id=mimo, score=t(score))
            grads.append(torch.autograd.grad(loss + ref, th)[0].numpy())
            if dt == torch.float32:
                close(loss, ref_l, LOSS_RTOL)
                if mimo:
                    close(ref, ref_r, LOSS_RTOL)
        bound = GRAD_RTOL + 2 * max_rel_err(ref_g, grads[1])
        assert max_rel_err(grads[0], ref_g) < bound, (score, mimo)


def test_id_loss_facenet_is_ir_se_50():
    """The loss's own trunk has the 50-layer shapes of JAX's, leaf for leaf
    (names through the bridge, layouts transposed)."""
    flat = fill_params(shapes_of(JArcFace(num_layers=50).init, jnp.zeros((1, 112, 112, 3))), 0)
    state, leftovers = from_jax_params(flat, "id")
    assert leftovers == []
    net = tl.IDLoss().facenet
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in net.state_dict().items()}
