"""Shared cases of the ReStyle and FeatureStyle train-step tests
(tests/test_torch_train_restyle.py, tests/test_torch_train_featurestyle.py):
the family's shipped options/train/*.yml cut to micro size, JAX's model
and TrainState on a seeded tree (tests/test_torch_families.py:arch_flat),
and JAX's noise pinned.

JAX's ReStyle and FeatureStyle forwards take no noise argument: every
NoiseInjection draws from the 'noise' rng. Here each of JAX's G hooks
(`_forward`, `_encode`, `_decode_samm`) runs its arch under
`flax.linen.intercept_methods`, which hands each NoiseInjection that would
draw the next tensor of the port's noise, in call order (so `make_rng` is
never reached; JAX's `_encode` applies ReStyle's encode without a 'noise'
rng and would raise without it). ReStyle's JAX encode decodes its average
image once at batch 1 and tiles it; the port decodes it per sample, here
with that batch-1 noise tiled."""

import copy
import math
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from test_torch_families import arch_flat
from test_torch_train import (B, K, LOSS_RTOL, SIZE, Case, capture, check_ema, check_grads,
                              check_logs, check_updates, equal_lr_fill, fill_params, unflatten)

from ood_gan_inversion_tpu.models import build_model
from ood_gan_inversion_tpu.nn.irse import ArcFaceBackbone as JArcFace
from ood_gan_inversion_tpu.nn.stylegan2 import NoiseInjection as JNoiseInjection

ROOT = pathlib.Path(__file__).resolve().parent.parent


def micro_family_opt(yml, arch_cfg, **train):
    """options/train/<yml> at micro size: the arch as `arch_cfg` gives it
    (tests/test_torch_families.py's RESTYLE / FEATURESTYLE), ModSize 32
    then 64 after step 2, the discriminators narrowed as
    tests/test_torch_train.py narrows E4E's; `train` overrides."""
    opt = yaml.safe_load((ROOT / "options/train" / yml).read_text())
    opt["network_g"].update(arch_cfg, progressiveModSize=[32, 64], progressiveStart=2,
                            progressiveStep=4)
    opt["network_d"].update(out_size=SIZE, channel_multiplier=1, narrow=0.25)
    opt["network_d2"].update(chn=10, n_mlp=2)
    opt["train"].update(train)
    return opt


def feeding(noise):
    """(iterator, context): inside the context every JAX NoiseInjection
    call that would draw gets the iterator's next tensor instead."""
    it = iter(noise)

    def feed(next_fun, args, kwargs, context):
        if isinstance(context.module, JNoiseInjection) and context.method_name == "__call__":
            if kwargs.get("noise", args[1] if len(args) > 1 else None) is None:
                return next_fun(args[0], noise=next(it))
        return next_fun(*args, **kwargs)

    return it, fnn.intercept_methods(feed)


def fed(noise, fn):
    """fn() with `noise` fed in call order; every tensor must be used."""
    it, ctx = feeding(noise)
    with ctx:
        out = fn()
    assert next(it, None) is None
    return out


class FamilyCase(Case):
    """Case (tests/test_torch_train.py) for a family's options `opt`:
    `jarch` its JAX arch class, `arch_cfg` the arch's micro keys (its
    seeded tree is arch_flat's), `decodes` the number of decodes in its
    encode (ReStyle: enc_cycle; FeatureStyle: 0)."""

    def __init__(self, opt, seed, jarch, arch_cfg, decodes):
        self.opt = opt
        jm = build_model(copy.deepcopy(opt))
        jm.cri_id.facenet = JArcFace(num_layers=4)
        for name in ("tx_g", "tx_d", "tx_d2"):
            setattr(jm, name, (lambda f: lambda: capture(f()))(getattr(jm, name)))
        # the generator's tree is arch_flat's; the other nets' shapes as
        # JAX's _init_net_params builds them
        x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
        lats = jnp.zeros((1, jm.style_cnt, jm.net_g.style_dim))
        shapes = jax.eval_shape(lambda r: {
            "d": jm.net_d.init(r, x)["params"], "d2": jm.net_d2.init(r, lats)["params"],
            "loss": {"vgg": jm.cri_perceptual.init(r, x.shape), "id": jm.cri_id.init(r)}},
            jax.random.PRNGKey(0))
        nets = {"g": unflatten(arch_flat(jarch, arch_cfg, seed)),
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
        # (b, 1, s, s) per generator layer: conv1 at 4px, then two per stage
        sizes = [4] + [2 ** (3 + j // 2) for j in range(2 * int(math.log2(SIZE)) - 4)]

        def draw(b):
            return [rs.randn(b, 1, s, s).astype(np.float32) for s in sizes]

        # JAX's draws (NCHW), in its call order: the encoder's decodes (the
        # first at batch 1 for ReStyle's average image), then the final one
        jenc = [t for d in range(decodes) for t in draw(1 if d == 0 else B * K)]
        jdec = draw(B * K)
        self.noise = [np.repeat(t, B * K, axis=0) if t.shape[0] == 1 else t
                      for t in jenc] + jdec
        self.cot = (rs.randn(B * K, SIZE, SIZE, 3) / SIZE).astype(np.float32)
        jenc, jdec = ([jnp.asarray(t.transpose(0, 2, 3, 1)) for t in ts] for ts in (jenc, jdec))
        net_t = type(jm.net_g)
        jm._forward = lambda pg, x, rng, mod_size, stage, train=True: fed(
            jenc + jdec, lambda: jm.net_g.apply({"params": pg}, x, mod_size=mod_size,
                                                stage=stage, train=train))
        jm._encode = lambda pg, x, stage: fed(
            jenc, lambda: jm.net_g.apply({"params": pg}, x, stage=stage, method=net_t.encode))
        jm._decode_samm = lambda pg, lats, feats_c, x, rng, mod_size: fed(
            jdec, lambda: jm.net_g.apply({"params": pg}, lats, feats_c, x, mod_size,
                                         method=net_t.decode_samm, train=True))
        jm._path_cot = lambda rng, shape, dtype: jnp.asarray(self.cot)


LR = 2e-5          # the shipped files' optim_g / optim_d lr


def jax_d_grads_on(case, fake):
    """JAX's D-phase gradient (no R1) of the case's state on the batch and
    the NHWC `fake`."""
    jm, gt = case.jm, jnp.asarray(case.batch["gt"].reshape((-1,) + case.batch["gt"].shape[2:]))

    def loss(pd):
        return (jm.cri_gan(jm.net_d.apply({"params": pd}, gt)[0], True, is_disc=True)
                + jm.cri_gan(jm.net_d.apply({"params": pd}, fake)[0], False, is_disc=True))

    return jax.jit(jax.grad(loss))(case.state.params_d)


def check_step(case, step, keys=(), d_on_port_fake=False):
    """One step of `case` in both frameworks: the logged losses (which
    hold `keys`), the D and G gradients and updates, the EMA and, at a
    path-regularized step, the path mean; frozen generator parameters bit
    for bit. d_on_port_fake: JAX's D gradient is taken on the port's fake
    (the D phase held on the same input; the fake itself is held by the
    losses)."""
    fakes = []
    if d_on_port_fake:
        port = case.port

        def recording_port():
            model = port()
            forward = model._forward

            def keep(*a, **kw):
                out = forward(*a, **kw)
                fakes.append(out["image"].detach().numpy().copy())
                return out

            model._forward = keep
            return model

        case.port = recording_port
    try:
        jstate, jlogs, model, logs, grads, before = case.run(step)
    finally:
        case.__dict__.pop("port", None)
    assert set(keys) <= set(logs)
    check_logs(jlogs, logs)
    check_grads(jax_d_grads_on(case, jnp.asarray(fakes[0])) if d_on_port_fake
                else jstate.opt_d["grads"], grads["d"])
    check_updates(jstate.opt_d["grads"], jstate.params_d, before["d"],
                  dict(model.net_d.named_parameters()), LR)
    check_grads(jstate.opt_g["grads"], grads["g"])
    assert set(grads["g"]) == {k for k in grads["g"]
                               if k.startswith(("feats_conv.", "modulation."))}
    check_updates(jstate.opt_g["grads"], jstate.params_g_train, before["g"],
                  dict(model.net_g.named_parameters()), LR)
    check_ema(jstate, model, LR)
    if "path_length" in logs:
        assert abs(float(model.mean_path_length) - float(jstate.mean_path_length)) <= \
            LOSS_RTOL * abs(float(jstate.mean_path_length))
    for k, p in model.net_g.named_parameters():
        if k not in model.train_g:
            assert torch.equal(p, before["g"][k]), k
    return logs
