"""The trainer options no shipped config uses, against the JAX package on
the CPU: the progressive encoder stages (a numbered `stage`, `WTraining`),
the Ranger optimizer and the CosineAnnealingRestartLR schedule, each alone
and together in a micro E4E train step (tests/test_torch_train.py's
case).

Tolerances: the encoders within 1e-4 of max|ref| (the module bound);
Ranger's parameters within 1e-6 of their max|ref| at every step; the
schedule within 1e-6 relative; the train steps as tests/test_torch_train.py
holds them (losses 1e-4 relative, gradients 1e-3 of max|ref|), with
Ranger's updates, which scale with the gradient (its first steps are
momentum SGD: -lr mu_hat), within 2e-3 lr of the leaf's gradient scale,
twice the gradients' own bound (centralization subtracts a mean of the
same error)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import fill_params, init_shapes, jax_tree, load_port, max_rel_err, nchw, nhwc
from torch_parity import release_freed_memory  # noqa: F401 (autouse)
from test_torch_train import NOISE_FLOOR, Case, check_grads, check_logs, micro_e4e_opt

from ood_gan_inversion_tpu.models import build_model as j_build_model
from ood_gan_inversion_tpu.models import ood_model as j_ood
from ood_gan_inversion_tpu.models import optim as j_optim
from ood_gan_inversion_tpu.nn.encoders.e4e import Encoder4Editing as JEncoder
from ood_gan_inversion_tpu_torch.convert import flatten_tree, jax_first_axis, port_key, port_value
from ood_gan_inversion_tpu_torch.models.optim import (cosine_annealing_restart_lr, linear_warmup,
                                                      make_optimizer, multistep_lr)
from ood_gan_inversion_tpu_torch.nn.encoders.e4e import Encoder4Editing

ENCODER_RTOL = 1e-4
RANGER_RTOL = 1e-6
SCHED_RTOL = 1e-6


# ------------------------------------------------------------ encoder stages

def test_encoder4editing_stages_match_jax():
    """At stage 0 (WTraining), 3 (four heads, the fourth on the FPN's 32px
    map) and Inference: the first stage + 1 style heads active, the
    others' deltas zero; 4-layer trunk, 10 styles."""
    jenc = JEncoder(num_layers=4, mode="ir_se", stylegan_size=64)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    flat = fill_params(init_shapes(jenc, jnp.asarray(x)), seed=4)
    enc = load_port(Encoder4Editing(4, "ir_se", 64), flat, "encoder/")
    jfwd = jax.jit(lambda p, xx, stage: jenc.apply({"params": p}, xx, stage=stage),
                   static_argnums=2)
    for stage in (0, 3, 18):
        w_ref, feats_ref = jfwd(jax_tree(flat), jnp.asarray(x), stage)
        with torch.no_grad():
            w, feats = enc(nchw(x), stage)
        assert max_rel_err(w.numpy(), w_ref) < ENCODER_RTOL, stage
        for f, r in zip(feats, feats_ref):
            assert max_rel_err(nhwc(f), r) < ENCODER_RTOL, stage
        active = min(stage + 1, 10)
        assert torch.equal(w[:, active:], w[:, :1].expand(-1, 10 - active, -1)), stage


# ------------------------------------------------------------ Ranger

def test_ranger_matches_optax():
    """13 updates of a conv kernel, a linear weight and a bias (JAX layouts
    HWIO, (in, out); the port's OIHW, (out, in)) on seeded gradients,
    under a MultiStepLR schedule: RAdam's unrectified steps (rho < 5: 1
    and 2) and rectified ones, lookahead syncs at 6 and 12, gradient
    centralization over JAX's layout."""
    rs = np.random.RandomState(0)
    jparams = {"conv/weight": rs.randn(3, 3, 4, 5).astype(np.float32),
               "fc/weight": rs.randn(6, 7).astype(np.float32),
               "fc/bias": rs.randn(7).astype(np.float32)}
    names = list(jparams)
    tx = j_optim.make_optimizer("Ranger", j_ood.multistep_lr(1e-2, 5, 0.5))
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    state = tx.init(jp)
    tp = [port_value(k, v).clone() for k, v in jparams.items()]
    opt = make_optimizer("Ranger", tp, multistep_lr(1e-2, 5, 0.5),
                         gc_axis=[jax_first_axis(port_key(k), p.ndim) for k, p in zip(names, tp)])
    for step in range(13):
        grads = {k: rs.randn(*v.shape).astype(np.float32) for k, v in jparams.items()}
        upd, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([port_value(k, g) for k, g in grads.items()])
        for k, p in zip(names, tp):
            ref = port_value(k, jp[k]).numpy()
            err = np.abs(p.numpy() - ref).max() / np.abs(ref).max()
            assert err <= RANGER_RTOL, (step, k, err)
    assert opt.count == 13


def test_ranger_reads_jax_defaults():
    """ranger_betas (not betas) and eps 1e-5, as JAX's make_optimizer."""
    p = [torch.zeros(3)]
    r = make_optimizer("Ranger", p, 1e-3, betas=(0.0, 0.99))
    assert (r.b1, r.b2, r.eps, r.K, r.ALPHA) == (0.95, 0.999, 1e-5, 6, 0.5)
    r = make_optimizer("Ranger", p, 1e-3, ranger_betas=(0.9, 0.99), eps=1e-6)
    assert (r.b1, r.b2, r.eps) == (0.9, 0.99, 1e-6)


# ------------------------------------------------------------ cosine restart

PERIODS, WEIGHTS, ETA_MIN = [6, 10, 14], [1.0, 0.5, 0.25], 1e-6
BOUNDARY_STEPS = sorted({s + d for s in np.cumsum([0] + PERIODS) for d in (-1, 0, 1) if s + d >= 0})


def test_cosine_annealing_restart_matches_jax():
    j = j_optim.cosine_annealing_restart_lr(2e-4, PERIODS, WEIGHTS, ETA_MIN)
    p = cosine_annealing_restart_lr(2e-4, PERIODS, WEIGHTS, ETA_MIN)
    for s in BOUNDARY_STEPS + [3, 100]:
        ref = float(j(s))
        assert abs(p(s) - ref) <= SCHED_RTOL * abs(ref), (s, p(s), ref)
    with pytest.raises(ValueError):
        cosine_annealing_restart_lr(1.0, [2, 3], [1.0])


def test_cosine_annealing_restart_with_warmup_matches_jax():
    """JAX's warm-up wraps the schedule inside the model's optimizer
    (`_build_optimizers`): its lr is read from an SGD update of a unit
    gradient, count by count."""
    opt = micro_e4e_opt(warmup_iter=4, scheduler={"type": "CosineAnnealingRestartLR",
                                                  "periods": PERIODS,
                                                  "restart_weights": WEIGHTS,
                                                  "eta_min": ETA_MIN},
                        optim_d={"type": "SGD", "lr": 2e-4})
    tx = j_build_model(copy.deepcopy(opt)).tx_d()
    w = {"w": jnp.zeros(1)}
    state = tx.init(w)
    update = jax.jit(tx.update)
    p = linear_warmup(cosine_annealing_restart_lr(2e-4, PERIODS, WEIGHTS, ETA_MIN), 4)
    for s in range(max(BOUNDARY_STEPS) + 1):
        upd, state = update({"w": jnp.ones(1)}, state, w)
        if s in BOUNDARY_STEPS or s < 5:
            ref = -float(upd["w"][0])
            assert abs(p(s) - ref) <= SCHED_RTOL * abs(ref), (s, p(s), ref)


# ------------------------------------------------------------ Ranger + cosine in a step

def check_ranger_updates(jgrads, jnew, before, after, lr):
    """Each trainable leaf's move against JAX's: a Ranger step moves it by
    lr times its centralized, rectified moment, so within 2e-3 lr of the
    leaf's gradient scale (max(its max|g|, NOISE_FLOOR x the net's
    largest)) plus two float32 steps of the parameter."""
    jg = flatten_tree(jgrads)
    top = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    checked = 0
    for jk, v in flatten_tree(jnew).items():
        k = port_key(jk)
        if k not in after:
            continue
        old = before[k].numpy()
        d_ref = port_value(jk, v).numpy() - old
        d_got = after[k].detach().numpy() - old
        scale = max(float(np.abs(np.asarray(jg[jk])).max()), NOISE_FLOOR * top)
        tol = 2e-3 * lr * scale + 2 * np.spacing(np.abs(old))
        assert (np.abs(d_got - d_ref) <= tol).all(), (jk, np.abs(d_got - d_ref).max(), lr * scale)
        checked += 1
    assert checked


def test_wtraining_ranger_cosine_restart_train_step_matches_jax():
    """A fused step (step 1) of E4E_Face.yml at micro size at stage
    WTraining (the encoder's stage 0: one W for every layer), with Ranger
    for G and D and the cosine restart with a warm-up: the losses, the
    gradients and each optimizer's move against JAX's. Each of the three
    generator groups has a leaf (SAMM and adapters; the first toRGB, by a
    `grad` entry; delta_latent, by optim_delta_latent): JAX's Ranger cannot
    step an empty group (its lookahead unzips an empty list), and with the
    shipped fix list the generator and overfit groups are empty."""
    sched = {"type": "CosineAnnealingRestartLR", "periods": [2, 4],
             "restart_weights": [1.0, 0.5], "eta_min": 1e-7}
    opt = micro_e4e_opt(optim_g={"type": "Ranger", "lr": 2e-5},
                        optim_d={"type": "Ranger", "lr": 2e-5}, scheduler=sched,
                        warmup_iter=3,
                        fix_and_grad={"fix": ["generator", "encoder"], "grad": ["to_rgb1"]})
    opt["network_g"].update(optim_delta_latent=True, stage="WTraining")
    case = Case(opt, seed=30)
    assert case.jm.schedule_at(1) == (0, 32)
    jstate, jlogs, model, logs, grads, before = case.run(1)
    assert model.schedule_at(1) == (0, 32)
    assert type(model.opt_d).__name__ == "Ranger" and set(model.opt_g) == {
        "encoder", "generator", "overfit"}
    lr = model.opt_d.lr(0)
    assert lr == pytest.approx(2e-5 / 3, rel=1e-6)            # count 0: warm-up 1/3
    check_logs(jlogs, logs)
    check_grads(jstate.opt_d["grads"], grads["d"])
    check_grads(jstate.opt_g["grads"], grads["g"], dict(model.net_g.named_buffers()))
    check_ranger_updates(jstate.opt_d["grads"], jstate.params_d, before["d"],
                         dict(model.net_d.named_parameters()), lr)
    check_ranger_updates(jstate.opt_g["grads"], jstate.params_g_train, before["g"],
                         dict(model.net_g.named_parameters()), lr)
