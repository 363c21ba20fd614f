"""The port's trainer (models/ood_model.py, models/optim.py) against JAX's
`OODFaceGANModel.train_step` on the CPU, on options/train/E4E_Face.yml cut
to micro size: 64px, channel_multiplier 1, narrow 0.25, a 4-layer IR-SE
encoder trunk, n_mlp 2, ModSize 32 then 64 after step 2. Its losses are
the config's: GAN (wgan_softplus), MSE, VGG19 perceptual + style, the
MIMO identity loss and the mask losses; R1 and the path-length
regularizer fire at step 0 (reg_every 99999999). The identity loss runs a
4-layer IR-SE trunk on both sides (tests/test_torch_losses.py checks the
50-layer one's shapes).

Each compared step starts both frameworks from the same state: JAX's
TrainState built from seeded numpy weights (no flax init), loaded into a
fresh port model by `convert.load_jax_train_state` (strict, nothing left
over). JAX's noise, path cotangent and latent-D z are pinned (its
`_forward` / `_decode_samm` / `_path_cot` hooks, and the z it draws from
fold_in(rng, 3)) and passed to the port. JAX's gradients are read from
its optimizer states through a wrapper transformation, the port's where
`_grads` returns them.

Tolerances:
  * every logged loss: 1e-4 relative (LOSS_RTOL);
  * every trainable leaf's gradient: 1e-3 of the leaf's max|ref|
    (GRAD_RTOL), or 1e-6 of the net's largest gradient where that is more
    (NOISE_FLOOR: leaves whose exact gradient is zero); a leaf JAX leaves
    at zero is zero in the port;
  * the updates (D, D2, G) and the EMA: Adam with beta1 = 0 moves each
    element by lr * g / (|g| + eps), about +-lr whatever |g| is, so the
    updates are compared where |g_ref| is well above the gradients' error
    (2e-3 of the leaf's max|ref|) and above 1e-6, within 1e-3 lr plus two
    float32 steps of the parameter; elsewhere each update is at most lr.
JAX runs its phases jitted, as train_step does."""

import copy
import math
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from torch_parity import fill_params
from torch_parity import release_freed_memory  # noqa: F401 (autouse)

from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu.models import build_model
from ood_gan_inversion_tpu.models import ood_model as j_ood
from ood_gan_inversion_tpu.models.optim import make_optimizer as j_make_optimizer
from ood_gan_inversion_tpu.nn.irse import ArcFaceBackbone as JArcFace
from ood_gan_inversion_tpu_torch.convert import flatten_tree, load_jax_train_state, port_key, port_value
from ood_gan_inversion_tpu_torch.losses import id_loss
from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
from ood_gan_inversion_tpu_torch.models import ood_model as p_ood
from ood_gan_inversion_tpu_torch.models.optim import (clip_by_global_norm, linear_warmup,
                                                      make_optimizer, multistep_lr)
from ood_gan_inversion_tpu_torch.nn.irse import ArcFaceBackbone
from ood_gan_inversion_tpu_torch.nn.layers import init_weights

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
# a leaf whose gradient is zero in exact arithmetic (a bias ahead of an
# instance norm: feats_conv_3/bias, AlignNet's body0/norm2/bias) holds
# float32 noise in both frameworks, up to ~4e-7 of the net's largest
# gradient (path regularization at step 0); it is held to 1e-6 of that
NOISE_FLOOR = 1e-3
B, K, SIZE = 2, 1, 64


def micro_e4e_opt(**train):
    """options/train/E4E_Face.yml at micro size; `train` overrides."""
    opt = yaml.safe_load((ROOT / "options/train/E4E_Face.yml").read_text())
    opt["network_g"].update(out_size=SIZE, channel_multiplier=1, narrow=0.25,
                            encoder_num_layers=4, n_mlp=2, progressiveModSize=[32, 64],
                            progressiveStart=2, progressiveStep=4)
    opt["network_d"].update(out_size=SIZE, channel_multiplier=1, narrow=0.25)
    opt["network_d2"].update(chn=10, n_mlp=2)
    opt["train"].update(train)
    return opt


def capture(tx):
    """tx whose state also keeps the last gradients it was given."""
    def init(params):
        return {"inner": tx.init(params), "grads": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state["inner"], params)
        return upd, {"inner": inner, "grads": grads}

    return optax.GradientTransformation(init, update)


def equal_lr_fill(shapes, seed):
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*v.shape) if k.endswith("weight") else 0.1 * rs.randn(*v.shape)
                ).astype(np.float32) for k, v in fill_params(shapes, seed).items()}


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


class Case:
    """A JAX model with pinned noise and captured gradients, its seeded
    TrainState, and the inputs of a step."""

    def __init__(self, opt, seed):
        self.opt = opt
        jm = build_model(copy.deepcopy(opt))
        jm.cri_id.facenet = JArcFace(num_layers=4)
        for name in ("tx_g", "tx_d", "tx_d2"):
            setattr(jm, name, (lambda f: lambda: capture(f()))(getattr(jm, name)))
        shapes = jax.eval_shape(lambda r: jm._init_net_params(r, (B * K, SIZE, SIZE, 3)),
                                jax.random.PRNGKey(0))
        nets = {"g": unflatten(fill_params(shapes["g"], seed)),
                "d": unflatten(equal_lr_fill(shapes["d"], seed + 1)),
                "d2": unflatten(equal_lr_fill(shapes["d2"], seed + 2)),
                "loss": {"vgg": {"params": unflatten(fill_params(shapes["loss"]["vgg"]["params"],
                                                                 seed + 3))},
                         "id": {"params": unflatten(fill_params(shapes["loss"]["id"]["params"],
                                                                seed + 4))}}}
        self.jm, self.state = jm, jm._state_from_net_params(nets)
        rs = np.random.RandomState(seed + 5)
        self.batch = {"gt": (0.5 * rs.randn(B, K, SIZE, SIZE, 3)).astype(np.float32),
                      "lq_size": rs.rand(B, K).astype(np.float32)}
        # (B*K, 1, s, s) per layer: conv1 at 4px, then two per stage
        sizes = [4] + [2 ** (3 + j // 2) for j in range(2 * int(math.log2(SIZE)) - 4)]
        self.noise = [rs.randn(B * K, 1, s, s).astype(np.float32) for s in sizes]
        self.cot = (rs.randn(B * K, SIZE, SIZE, 3) / SIZE).astype(np.float32)
        jnoise = [jnp.asarray(n.transpose(0, 2, 3, 1)) for n in self.noise]
        jm._forward = lambda pg, x, rng, mod_size, stage, train=True: jm.net_g.apply(
            {"params": pg}, x, mod_size=mod_size, stage=stage, train=train, noise=jnoise)
        jm._decode_samm = lambda pg, lats, feats_c, x, rng, mod_size: jm.net_g.apply(
            {"params": pg}, lats, feats_c, x, mod_size, method=JArch.decode_samm, train=True,
            noise=jnoise)
        jm._path_cot = lambda rng, shape, dtype: jnp.asarray(self.cot)

    def port(self):
        """A fresh port model holding the JAX state (its identity loss
        built with the 4-layer trunk JAX's has)."""
        with mock.patch.object(id_loss, "ArcFaceBackbone", lambda num_layers: ArcFaceBackbone(4)):
            model = OODFaceGANModel(copy.deepcopy(self.opt), device="cpu")
        load_jax_train_state(model, self.state)
        return model

    def run(self, step):
        """One step in both frameworks from the same state: (JAX state
        after, JAX logs, port model after, port logs, port gradients by
        net)."""
        rng = jax.random.PRNGKey(step + 7)
        z = np.asarray(jax.random.normal(jax.random.fold_in(rng, 3), (B * K, 512)))
        model = self.port()
        # JAX's jitted phases donate the state they are given: pass a copy
        state = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), self.state)
        jstate, jlogs = self.jm.train_step(state, self.batch, rng, step)
        grads = {}
        names = {id(p): (net, n) for net, mod in (("g", model.net_g), ("d", model.net_d),
                                                 ("d2", model.net_d2))
                 for n, p in mod.named_parameters()}
        inner = model._grads

        def record(loss, params):
            out = inner(loss, params)
            for p, g in zip(params, out):
                net, n = names[id(p)]
                grads.setdefault(net, {})[n] = g.detach().clone()
            return out

        model._grads = record
        before = {net: {k: v.detach().clone() for k, v in mod.state_dict().items()}
                  for net, mod in (("g", model.net_g), ("d", model.net_d), ("d2", model.net_d2))}
        logs = model.train_step(self.batch, step, noise=[torch.from_numpy(n) for n in self.noise],
                                path_cot=torch.from_numpy(self.cot), z=torch.from_numpy(z))
        return jstate, jlogs, model, logs, grads, before


def check_logs(jlogs, logs):
    assert set(jlogs) == set(logs)
    for k, v in logs.items():
        ref = float(jlogs[k])
        assert abs(float(v) - ref) <= LOSS_RTOL * max(abs(ref), 1e-6), (k, float(v), ref)


def check_grads(jgrads, grads, buffers=()):
    """JAX's gradient tree against the port's {name: grad}: each leaf within
    GRAD_RTOL of max(its max|ref|, NOISE_FLOOR x the net's largest
    gradient). JAX leaves that are port buffers (BatchNorm statistics) must
    be zero, and so must a port leaf whose JAX gradient is exactly zero."""
    flat = {jk: port_value(jk, v).numpy() for jk, v in flatten_tree(jgrads).items()}
    top = max(np.abs(v).max() for v in flat.values())
    checked = set()
    for jk, ref in flat.items():
        k = port_key(jk)
        if k in buffers:
            assert not ref.any(), jk
            continue
        got = grads[k].numpy()
        scale = np.abs(ref).max()
        if scale == 0:
            assert not got.any(), jk
        else:
            bound = GRAD_RTOL * max(scale, NOISE_FLOOR * top)
            assert np.abs(got - ref).max() <= bound, (jk, np.abs(got - ref).max(), scale)
        checked.add(k)
    assert checked == set(grads)


def check_updates(jgrads, jnew, before, after, lr, buffers=()):
    """The parameters' moves against JAX's where the gradient decides the
    sign (see the module docstring; a leaf's max|g| is taken at least
    NOISE_FLOOR x the net's largest, as in check_grads)."""
    jg = flatten_tree(jgrads)
    top = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    for jk, v in flatten_tree(jnew).items():
        k = port_key(jk)
        if k in buffers or k not in after:
            continue
        g = port_value(jk, jg[jk]).numpy() if jk in jg else np.zeros(0)
        old = before[k].numpy()
        d_ref = port_value(jk, v).numpy() - old
        d_got = after[k].detach().numpy() - old
        assert np.abs(d_got).max() <= lr * (1 + 1e-3) + 4 * np.spacing(np.abs(old).max()), jk
        if g.size == 0 or not np.abs(g).max():
            continue
        sure = (np.abs(g) > 2e-3 * max(np.abs(g).max(), NOISE_FLOOR * top)) & (np.abs(g) > 1e-6)
        tol = 1e-3 * lr + 2 * np.spacing(np.abs(old))
        assert (np.abs(d_got - d_ref) <= tol)[sure].all(), jk


def check_ema(jstate, model, lr):
    d = model.ema_decay
    for jk, v in flatten_tree(jstate.ema_train).items():
        k = port_key(jk)
        if k in model.ema:
            ref = port_value(jk, v).numpy()
            assert np.abs(model.ema[k].numpy() - ref).max() <= (1 - d) * 2 * lr + 4 * np.spacing(
                np.abs(ref).max()), jk


@pytest.fixture(scope="module")
def e4e():
    return Case(micro_e4e_opt(), seed=0)


def test_split_step0_matches_jax(e4e):
    """Step 0, ModSize 32: the split phases with R1 in the D phase and the
    path-length regularizer (double backward through the decode) in the G
    phase."""
    jstate, jlogs, model, logs, grads, before = e4e.run(0)
    assert {"l_d_r1", "l_g_path", "path_length"} <= set(logs)
    check_logs(jlogs, logs)
    check_grads(jstate.opt_d["grads"], grads["d"])
    check_grads(jstate.opt_g["grads"], grads["g"])
    assert set(grads["g"]) == {k for k in grads["g"]
                               if k.startswith(("feats_conv.", "modulation."))}
    check_updates(jstate.opt_d["grads"], jstate.params_d,
                  before["d"], dict(model.net_d.named_parameters()), 2e-5)
    check_updates(jstate.opt_g["grads"], jstate.params_g_train,
                  before["g"], dict(model.net_g.named_parameters()), 2e-5)
    check_ema(jstate, model, 2e-5)
    assert abs(float(model.mean_path_length) - float(jstate.mean_path_length)) <= \
        LOSS_RTOL * abs(float(jstate.mean_path_length))
    # frozen parameters stay bit for bit
    for k, p in model.net_g.named_parameters():
        if k not in model.train_g:
            assert torch.equal(p, before["g"][k]), k


def test_fused_step1_matches_jax(e4e):
    """Step 1: the fused program (one G forward, D updated on its detached
    fake, G losses against the new D), no regularizer."""
    jstate, jlogs, model, logs, grads, before = e4e.run(1)
    assert "l_d_r1" not in logs and "l_g_path" not in logs
    check_logs(jlogs, logs)
    check_grads(jstate.opt_d["grads"], grads["d"])
    check_grads(jstate.opt_g["grads"], grads["g"])
    check_updates(jstate.opt_d["grads"], jstate.params_d,
                  before["d"], dict(model.net_d.named_parameters()), 2e-5)
    check_updates(jstate.opt_g["grads"], jstate.params_g_train,
                  before["g"], dict(model.net_g.named_parameters()), 2e-5)
    check_ema(jstate, model, 2e-5)


def test_fused_step_past_milestone_with_latent_d_and_open_fix_matches_jax():
    """Step 3 (past the first milestone: ModSize 64, both SAMM scales),
    fused, with the latent discriminator on (skip_latent_g false: its
    update and l_latent_g) and fix: [] (the generator and the encoder
    trainable). The encoder is frozen by freeze_encoder in both
    frameworks: its gradients are zero, the generator's are not."""
    case = Case(micro_e4e_opt(skip_latent_g=False, fix_and_grad={"fix": [], "grad": []}),
                seed=10)
    assert case.jm.schedule_at(3) == (10, 64)
    jstate, jlogs, model, logs, grads, before = case.run(3)
    assert {"l_latent_d", "l_latent_g"} <= set(logs)
    check_logs(jlogs, logs)
    buffers = dict(model.net_g.named_buffers())
    check_grads(jstate.opt_g["grads"], grads["g"], buffers)
    check_grads(jstate.opt_d["grads"], grads["d"])
    check_grads(jstate.opt_d2["grads"], grads["d2"])
    enc = [g for k, g in grads["g"].items() if k.startswith("encoder.")]
    assert enc and not any(g.any() for g in enc)
    assert any(g.any() for k, g in grads["g"].items() if k.startswith("generator."))
    for which, mod in (("d", model.net_d), ("d2", model.net_d2)):
        check_updates(getattr(jstate, f"opt_{which}")["grads"], getattr(jstate, f"params_{which}"),
                      before[which], dict(mod.named_parameters()), 2e-5)
    check_updates(jstate.opt_g["grads"], jstate.params_g_train, before["g"],
                  dict(model.net_g.named_parameters()), 2e-5, buffers)
    check_ema(jstate, model, 2e-5)


def test_fused_and_split_steps_agree():
    """The two programs compute the same step: on the same state, noise and
    z, fused_step: false runs D, latent D and G as three phases (the G
    forward recomputed) and gives the same logs and updates."""
    opt = micro_e4e_opt(skip_latent_g=False)
    outs = []
    for fused in (True, False):
        o = copy.deepcopy(opt)
        o["train"]["fused_step"] = fused
        model = OODFaceGANModel(o, device="cpu", seed=3)
        model.cri_id.facenet = init_weights(ArcFaceBackbone(num_layers=4), 4).requires_grad_(False)
        rs = np.random.RandomState(4)
        batch = {"gt": (0.5 * rs.randn(B, K, SIZE, SIZE, 3)).astype(np.float32),
                 "lq_size": rs.rand(B, K).astype(np.float32)}
        g = torch.Generator().manual_seed(5)
        noise = model.net_g.generator.make_noise(B * K, g, torch.device("cpu"))
        logs = model.train_step(batch, 1, noise=noise, z=torch.randn(B * K, 512, generator=g))
        outs.append((logs, {k: v.detach().clone() for k, v in model.net_g.state_dict().items()},
                     {k: v.detach().clone() for k, v in model.net_d2.state_dict().items()}))
    (l1, g1, d1), (l2, g2, d2) = outs
    assert set(l1) == set(l2)
    for k in l1:
        assert abs(float(l1[k]) - float(l2[k])) <= 1e-5 * max(abs(float(l1[k])), 1e-6), k
    for a, b in ((g1, g2), (d1, d2)):
        for k in a:
            assert torch.allclose(a[k], b[k], rtol=0, atol=1e-6), k


# ------------------------------------------------------------ construction

def test_model_builds_from_e4e_face_yml():
    """The config's fix list leaves the SAMM blocks and the 1x1 adapters
    trainable; the optimizer groups, betas and the latent D's lr follow
    JAX; without a card, asking for cuda raises."""
    opt = micro_e4e_opt()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OODFaceGANModel(copy.deepcopy(opt))
    model = OODFaceGANModel(copy.deepcopy(opt), device="cpu")
    assert model.train_g and all(k.startswith(("feats_conv.", "modulation."))
                                 for k in model.train_g)
    assert all(not p.requires_grad for k, p in model.net_g.named_parameters()
               if k not in model.train_g)
    assert set(model.opt_g) == {"encoder"}
    r = 99999999 / 100000000
    assert model.opt_g["encoder"][1].b1 == 0.0 ** r
    assert model.opt_g["encoder"][1].b2 == 0.99 ** r
    assert model.opt_d2.lr(0) == 2e-5            # optim_d's lr, the reference quirk
    assert model.schedule_at(0) == (10, 32) and model.schedule_at(3) == (10, 64)
    assert all(not p.requires_grad for p in model.cri_perceptual.parameters())
    assert all(not p.requires_grad for p in model.cri_id.parameters())


def test_model_option_errors():
    bad = micro_e4e_opt()
    bad["train"]["pixx_opt"] = {"type": "MSELoss"}
    with pytest.raises(ValueError, match="pixx_opt"):
        OODFaceGANModel(bad, device="cpu")
    # stage: WTraining runs (stage 0: the encoder's one W for every layer)
    wtrain = micro_e4e_opt()
    wtrain["network_g"]["stage"] = "WTraining"
    model = OODFaceGANModel(wtrain, device="cpu")
    assert model.schedule_at(0)[0] == 0
    lats = model.infer(np.zeros((1, SIZE, SIZE, 3), np.float32), step=0)["lats"]
    assert torch.equal(lats - model.net_g.avg_latent, (lats - model.net_g.avg_latent)[:, :1]
                       .expand_as(lats))
    # a bfloat16 arch does not train: JAX's own bfloat16 train step raises
    # in the gradient of AlignNet's conv, so its SAMM island has no reference
    bf16 = micro_e4e_opt()
    bf16["network_g"]["dtype"] = "bfloat16"
    with pytest.raises(NotImplementedError, match="float32"):
        OODFaceGANModel(bf16, device="cpu")


@pytest.mark.parametrize("yml", ["E4E_Face.yml", "ReStyle_Face.yml", "FeatureStyle_Face.yml"])
def test_chip_smoke_trains_the_shipped_config(yml):
    """chip_smoke.py (which runs where PyYAML may be absent) carries each
    options/train/*.yml's model and train sections as a dict: the same
    dict."""
    import chip_smoke
    opt = yaml.safe_load((ROOT / "options/train" / yml).read_text())
    assert chip_smoke.shipped_train_opt(yml) == {k: opt[k] for k in
                                                 ("is_mimo", "network_g", "network_d",
                                                  "network_d2", "train")}


@pytest.mark.parametrize("step", [0, 2, 3, 6, 7, 100])
def test_progressive_schedule_matches_jax(step):
    kw = dict(style_cnt=18, initial_stage=18, progressive_mod_size=[32, 64, 128, 256],
              progressive_stage_steps=j_ood.default_stage_steps(2, 4, 18))
    assert p_ood.progressive_schedule(step, **kw) == j_ood.progressive_schedule(step, **kw)
    assert p_ood.default_stage_steps(2, 4, 18) == j_ood.default_stage_steps(2, 4, 18)


def test_freeze_encoder_stops_the_encoder_gradient():
    """encode(freeze_encoder=True) detaches the encoder's latents and
    features (JAX's stop_gradient); with False the encoder gets a
    gradient. The W+ offsets and the adapters get one either way."""
    model = OODFaceGANModel(micro_e4e_opt(fix_and_grad={"fix": [], "grad": []}), device="cpu")
    arch = model.net_g
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, SIZE, SIZE).astype(np.float32))
    for freeze in (True, False):
        arch.zero_grad()
        lats, feats = arch.encode(x, freeze_encoder=freeze)
        (lats.sum() + sum(f.sum() for f in feats)).backward()
        enc = [p.grad for p in arch.encoder.parameters()]
        assert all(g is None for g in enc) == freeze
        assert arch.feats_conv[0].weight.grad is not None


def test_infer_with_and_without_ema():
    model = OODFaceGANModel(micro_e4e_opt(), device="cpu")
    x = np.random.RandomState(1).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    noise = model.net_g.generator.make_noise(1, torch.Generator().manual_seed(0),
                                             torch.device("cpu"))
    a = model.infer(x, noise=noise)["image"]
    for p in model.ema.values():
        p.add_(0.01)
    b = model.infer(x, noise=noise, ema=True)["image"]
    c = model.infer(x, noise=noise)["image"]
    assert a.shape == (1, SIZE, SIZE, 3)
    assert torch.equal(a, c) and not torch.equal(a, b)
    k = next(iter(model.ema))
    assert torch.equal(model.eval_params(ema=True)[k], model.ema[k])


# ------------------------------------------------------------ optimizers

@pytest.mark.parametrize("kind", ["adam_beta1_0", "adam", "sgd", "sgd_momentum"])
def test_optimizer_matches_optax(kind):
    """Five updates on seeded gradients (one of them None, a zero gradient
    in optax), with a MultiStepLR schedule of the update count; the
    parameters within 1e-6 relative of optax's."""
    rs = np.random.RandomState(0)
    params = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    sched_j = j_ood.multistep_lr(1e-2, 2, 0.5)
    sched_p = multistep_lr(1e-2, 2, 0.5)
    r = 4 / 5
    optim_type, kw = {"adam_beta1_0": ("Adam", {"betas": (0.0 ** r, 0.99 ** r)}),
                      "adam": ("Adam", {"betas": (0.9, 0.999)}),
                      "sgd": ("SGD", {}), "sgd_momentum": ("SGD", {"momentum": 0.9})}[kind]
    tx = j_make_optimizer(optim_type, sched_j, **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = make_optimizer(optim_type, tp, sched_p, **kw)
    for i in range(5):
        grads = [rs.randn(*p.shape).astype(np.float32) for p in params]
        if i == 2:
            grads[1] = np.zeros_like(grads[1])
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(grads[0]), None if i == 2 else torch.from_numpy(grads[1])])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_clip_by_global_norm_matches_optax():
    rs = np.random.RandomState(1)
    grads = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in grads))
    for max_norm in (norm * 2, norm / 3):
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        got = clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    same = clip_by_global_norm([torch.from_numpy(g) for g in grads], norm * 2)
    assert all(torch.equal(a, torch.from_numpy(g)) for a, g in zip(same, grads))


def test_schedules_match_jax():
    for milestones in (100, [10, 20], None):
        j, p = j_ood.multistep_lr(1.0, milestones, 0.5), multistep_lr(1.0, milestones, 0.5)
        for count in (0, 5, 10, 19, 20, 100, 250):
            assert abs(p(count) - float(j(count))) <= 1e-7
    warm = linear_warmup(multistep_lr(2.0, None, 1.0), 4)
    assert [warm(c) for c in range(6)] == [0.5, 1.0, 1.5, 2.0, 2.0, 2.0]
    assert linear_warmup(multistep_lr(2.0, None, 1.0), -1)(0) == 2.0
