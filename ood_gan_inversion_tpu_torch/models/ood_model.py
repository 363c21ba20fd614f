"""OOD face-GAN training model (counterpart of models/ood_model.py): the
discriminator, latent-discriminator and generator updates of one train
step, as JAX's `OODFaceGANModel.train_step` runs them.

The model is a plain object holding `nn.Module`s on one device (`cuda`
unless the caller asks for another): the arch `net_g`, the discriminators
`net_d` and `net_d2`, and the loss nets inside `cri_perceptual` and
`cri_id`. JAX's TrainState becomes attributes: the parameters live in the
modules, `ema` holds the EMA of the trainable generator parameters,
`mean_path_length` the path regularizer's running mean, and each
optimizer its own moments and update count.

  * fix_and_grad: a generator parameter is trainable unless a `fix`
    substring is in its name and no `grad` substring is (JAX's `_match` on
    the port's names, which keep the JAX module names). `avg_latent` is
    always fixed, `delta_latent` unless `optim_delta_latent`. Trainable
    parameters require grad, the others do not; gradients are taken for
    the trainable ones only.
  * `train_step(batch, step)` derives the curriculum (stage, ModSize) and
    the cadence flags from `step` and runs one of two programs, as JAX
    does: the split phases (D, latent D, then G; the path-length
    regularizer needs them) or the fused step (one G forward whose graph
    is kept, the D and latent-D updates on its detached outputs, then the
    G losses against the updated discriminators, backpropagated through
    the kept graph).
  * The adversarial G terms score detached outputs unless
    `g_gan_live_grad` (the reference's gradient-dead G-GAN terms).
  * Noise: a train step draws one noise list from the model's
    `torch.Generator` unless the caller passes `noise=` (the arch's
    `make_noise` list: ReStyle's holds its encoder's enc_cycle decodes
    too, and the phases hand `encode` that share), and every phase of the
    step reads it, as the fused step's one forward does (JAX folds a key
    per phase); the path regularizer's cotangent (`path_cot=`) and the
    latent D's z (`z=`) are drawn when None too. A test passes JAX's
    draws to hold the two step for step.
  * Every shipped family trains (E4E, ReStyle, FeatureStyle), at any
    progressive `stage` (`WTraining` is 0), with Adam, SGD or Ranger and
    MultiStepLR or CosineAnnealingRestartLR, each with JAX's warm-up. A
    bfloat16 arch does not train: JAX's own bfloat16 train step fails, so
    its float32 SAMM island has no reference to hold a port to.

On the card the SAMM warp-blend of every G forward runs the CUDA kernel
(B1); its gradient comes from its plain twin (`ops/cuda_call.py`), twice
under the path regularizer's create_graph.

Data parallel (one process per card under torch.distributed, parallel/
dist.py): each rank holds a replica of the whole state and its shard of
the global batch, and together the ranks take the global batch's step, as
JAX's mesh-sharded step does. The batch-coupled pieces are global: the
discriminator's stddev groups (ops/stats.py), the area hinge
(losses/mask_loss.py), the path regularizer's mean and its running mean
(losses/gan_loss.py), the `path_batch_ok` gate, the gradients (averaged
before the clip, so the clip's norm is the global batch's) and the logs
(averaged). Every other loss is a batch mean, which the gradient average
makes global. The step's draws are the global batch's, from the same
generator on every rank, each rank keeping its rows: an N-rank step takes
the one-process step's draws, and `state_dict()` is the same on every rank.

Banded (parallel/spatial.py): `train_step` called inside
`spatial.banding(mesh, Replicas(model.net_g, model.device), min_h)` runs
every decode of the step, the path regularizer's double backward
included, with its >= min_h generator stages banded over the mesh's slots;
a band on another device computes with the trained parameters moved into
the graph, so its gradients reach them. Under a process group each rank
bands its own rows: ranks x slots, JAX's ("data", "sp") mesh. JAX reaches
this only by calling its train_step inside `spatial_sharding`, and so does
the port: no option of `run_train` bands.
"""

import contextlib
import logging
import math

import numpy as np
import torch

from ..archs import arch_options, build_network
from ..archs.ood_e4e import nhwc_outputs
from ..device import resolve_device
from ..losses import GANLoss, build_loss, path_regularize_stats, r1_penalty_fn
from ..losses.id_loss import IDLoss
from ..losses.mask_loss import MaskLoss
from ..losses.perceptual import PerceptualLoss
from ..nn.layers import init_weights
from ..convert import jax_first_axis
from ..parallel import dist
from .optim import (clip_by_global_norm, cosine_annealing_restart_lr, linear_warmup,
                    make_optimizer, multistep_lr)

logger = logging.getLogger("ood_gan_inversion_tpu_torch")

# train.* keys this model consumes (or the pipeline reads around it)
_KNOWN_TRAIN_KEYS = {
    "gan_opt", "pix_opt", "id_opt", "perceptual_opt", "mask_opt",
    "latent_reg_opt", "optim_g", "optim_d", "optim_d2", "scheduler",
    "total_iter", "warmup_iter", "startup_iter", "fix_and_grad",
    "skip_latent_g", "skip_gen_g", "which_gt", "grad_clip_norm",
    "r1_reg_weight", "path_reg_weight", "path_batch_shrink",
    "net_d_reg_every", "net_g_reg_every", "remat", "ema_decay",
    "fused_step", "g_gan_live_grad", "ldm_opt",
}
# accepted by the reference model but inert there too
_INERT_TRAIN_KEYS = {
    "latent_opt", "clip_opt", "contextual_opt", "aug_opt",
    "mixing_prob", "net_d_iters", "net_d_init_iters",
}


def validate_train_opt(train_opt: dict):
    """Unknown `*_opt` keys raise (a misspelt loss would vanish silently);
    other unknown keys and the reference's dead hooks warn."""
    for k in train_opt:
        if k in _KNOWN_TRAIN_KEYS:
            continue
        if k in _INERT_TRAIN_KEYS:
            logger.warning("train.%s is accepted but inert (dead hook in the "
                           "reference too)", k)
            continue
        if k.endswith("_opt"):
            raise ValueError(
                f"unknown loss option train.{k} -- supported: "
                f"{sorted(x for x in _KNOWN_TRAIN_KEYS if x.endswith('_opt'))}"
                f" (inert reference hooks: {sorted(_INERT_TRAIN_KEYS)})")
        logger.warning("unrecognized train.%s is ignored", k)


def _match(key: str, needles) -> bool:
    return any(n in key for n in needles)


def progressive_schedule(step: int, *, style_cnt: int, initial_stage: int,
                         progressive_mod_size, progressive_stage_steps):
    """(encoder stage, ModSize) at `step`: each milestone passed (step >
    milestone) moves one stage and one ModSize on."""
    crossings = sum(1 for m in sorted(progressive_stage_steps) if step > m)
    stage = min(initial_stage + crossings, style_cnt)
    pms = list(progressive_mod_size)
    if not pms:
        return stage, 0
    return stage, pms[min(crossings, len(pms) - 1)]


def default_stage_steps(start: int, step: int, style_cnt: int):
    return [start + step * i for i in range(style_cnt)]


def _group(name: str) -> str:
    """The optimizer group of a trainable generator parameter."""
    if "generator" in name:
        return "generator"
    if "delta_latent" in name:
        return "overfit"
    return "encoder"


class OODFaceGANModel:
    def __init__(self, opt: dict, device="cuda", seed: int = 0):
        """opt: the experiment option dict (network_g, network_d,
        network_d2, train; `is_train` False for a test run, which holds no
        trainable parameter). The weights are drawn from `seed` (JAX's
        initializers, nn/layers.py); load trained ones with
        `convert.load_jax_train_state`."""
        self.device = resolve_device(device)
        # float32 as the config computes it: no TF32 in cuDNN or cuBLAS
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.is_mimo = opt.get("is_mimo", False)
        train_opt = opt.get("train", {})
        validate_train_opt(train_opt)

        narch = opt["network_g"]
        for k in ("aug_alignment", "aug_inputcolor"):
            if narch.get(k):
                logger.warning("network_g.%s is non-functional in the reference "
                               "and inert here", k)
        with torch.device(self.device):
            self.net_g = build_network(arch_options(narch))
            self.net_d = build_network(opt["network_d"]) if "network_d" in opt else None
            self.net_d2 = build_network(opt["network_d2"]) if "network_d2" in opt else None
        if dist.world_size() > 1:
            for name in ("pix_opt", "ldm_opt", "latent_reg_opt", "id_opt"):
                o = train_opt.get(name) or {}
                if "sum" in (o.get("reduction"), o.get("reduce")):
                    # a batch sum's gradient is not the mean of the ranks'
                    raise NotImplementedError(f"train.{name}: a summed loss under data "
                                              "parallelism (the gradient average makes "
                                              "batch means global, not sums)")
        if self.net_g.dtype != torch.float32:
            # JAX's own bfloat16 train step raises in the gradient of
            # AlignNet's conv (ROADMAP C): there is no reference to hold a
            # port of its float32 SAMM island to
            raise NotImplementedError(
                "training runs float32 only: JAX's bfloat16 train step fails (TypeError in "
                "the gradient of AlignNet's conv), so its SAMM island has no reference")

        # --- curriculum ---------------------------------------------------
        self.style_cnt = int(math.log2(narch.get("out_size", 1024))) * 2 - 2
        stage_name = narch.get("stage", "Inference")
        stage_map = {"Inference": self.style_cnt, "WTraining": 0}
        self.initial_stage = stage_map.get(
            stage_name, int(stage_name) if str(stage_name).isdigit() else self.style_cnt)
        self.progressive_mod_size = narch.get("progressiveModSize", [32, 64, 128, 256])
        if narch.get("ModSize", None):
            self.progressive_mod_size = [narch["ModSize"]]
        steps = narch.get("progressiveStageSteps", None)
        if steps is None:
            steps = default_stage_steps(narch.get("progressiveStart", 20000),
                                        narch.get("progressiveStep", 2000),
                                        self.style_cnt)
        self.progressive_stage_steps = steps

        # --- losses ---------------------------------------------------------
        def args(name):
            return {k: v for k, v in train_opt[name].items() if k != "type"}

        with torch.device(self.device):
            self.cri_gan = GANLoss(**args("gan_opt")) if "gan_opt" in train_opt else None
            self.cri_pix = build_loss(train_opt["pix_opt"]) if "pix_opt" in train_opt else None
            self.cri_id = IDLoss(**args("id_opt")) if "id_opt" in train_opt else None
            self.cri_perceptual = (PerceptualLoss(**args("perceptual_opt"))
                                   if "perceptual_opt" in train_opt else None)
            self.cri_mask = MaskLoss(**args("mask_opt")) if "mask_opt" in train_opt else None
            self.cri_latent_reg = (build_loss(train_opt["latent_reg_opt"])
                                   if "latent_reg_opt" in train_opt else None)
            # ldm_opt: any registered loss applied to (fake, gt)
            self.cri_ldm = build_loss(train_opt["ldm_opt"]) if "ldm_opt" in train_opt else None

        self.skip_latent_g = train_opt.get("skip_latent_g", True)
        self.skip_gen_g = train_opt.get("skip_gen_g", False)
        self.r1_reg_weight = train_opt.get("r1_reg_weight", 10)
        self.path_reg_weight = train_opt.get("path_reg_weight", 2)
        # the reference gates path regularization on batch > 1; with
        # path_batch_shrink set it runs at any batch size
        self.path_batch_shrink = train_opt.get("path_batch_shrink", None)
        self._warned_path_reg = False
        self.net_d_reg_every = train_opt.get("net_d_reg_every", 16)
        self.net_g_reg_every = train_opt.get("net_g_reg_every", 4)
        self.grad_clip_norm = train_opt.get("grad_clip_norm", 999.0)
        self.which_gt = train_opt.get("which_gt", "gt")
        self.g_gan_live_grad = train_opt.get("g_gan_live_grad", False)
        # train.remat is accepted and changes nothing: in JAX it only trades
        # memory for time (jax.checkpoint of the loss nets, to fit one v5e's
        # 16 GB), and the 1024px step peaks at ~22 GiB of an 80 GB H100
        # without it (PERF.md)
        self.fused_step = train_opt.get("fused_step", True)
        self.ema_decay = 0.5 ** (32 / (10 * 1000))

        fix = list(train_opt.get("fix_and_grad", {}).get("fix", []) or [])
        grad = list(train_opt.get("fix_and_grad", {}).get("grad", []) or [])
        fix.append("avg_latent")
        if not narch.get("optim_delta_latent", False):
            fix.append("delta_latent")
        self.fix_list, self.grad_list = fix, grad

        # --- weights: one seed per net, every net on the device -----------
        for i, net in enumerate((self.net_g, self.net_d, self.net_d2,
                                 self.cri_perceptual, self.cri_id)):
            if net is not None:
                init_weights(net, seed + i)
        for net in (self.cri_perceptual, self.cri_id):
            if net is not None:
                net.eval().requires_grad_(False)
        # a test run (is_train False, as parse_options sets it) trains nothing:
        # no trainable parameter, so no EMA and no optimizer state
        is_train = opt.get("is_train", True)
        self.train_g = {}
        for name, p in self.net_g.named_parameters():
            trainable = is_train and (not _match(name, fix) or _match(name, grad))
            p.requires_grad_(trainable)
            if trainable:
                self.train_g[name] = p
        self.ema = {k: p.detach().clone() for k, p in self.train_g.items()}
        self.mean_path_length = torch.zeros((), device=self.device)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        if is_train:
            self._build_optimizers(train_opt)
        else:
            self.opt_g, self.opt_d, self.opt_d2 = {}, None, None

    # ------------------------------------------------------------------
    def _build_optimizers(self, train_opt):
        og = train_opt.get("optim_g", {"lr": 2e-5})
        od = train_opt.get("optim_d", {"lr": 2e-5})
        od2 = train_opt.get("optim_d2", {"lr": 2e-6})
        sched = train_opt.get("scheduler", {}) or {}
        sched_type = sched.get("type", "MultiStepLR")
        if sched_type not in ("MultiStepLR", "MultiStepRestartLR", "CosineAnnealingRestartLR"):
            raise NotImplementedError(f"scheduler {sched_type}")
        warmup = train_opt.get("warmup_iter", -1)

        def lr_schedule(base_lr):
            if sched_type == "CosineAnnealingRestartLR":
                base = cosine_annealing_restart_lr(
                    base_lr, sched.get("periods", [250000]), sched.get("restart_weights"),
                    sched.get("eta_min", 0.0))
            else:
                base = multistep_lr(base_lr, sched.get("milestones", None),
                                    sched.get("gamma", 1.0))
            return linear_warmup(base, warmup)

        def optimizer(which, named, lr, betas):
            """JAX passes an optimizer its type, lr and betas only (Ranger
            then takes its defaults); Ranger also gets each parameter's
            layout axis for its gradient centralization."""
            return make_optimizer(which.get("type", "Adam"), [p for _, p in named], lr,
                                  betas=betas,
                                  gc_axis=[jax_first_axis(n, p.ndim) for n, p in named])

        reg_ratio = self.net_g_reg_every / (self.net_g_reg_every + 1)
        betas = (0.0 ** reg_ratio, 0.99 ** reg_ratio)
        lr_g = og.get("lr", 2e-5)
        lr_of = {"encoder": lr_g, "generator": lr_g * og.get("generator_lr_decay", 0.1),
                 "overfit": lr_g * og.get("overfit_lr_decay", 1.0)}
        names = {g: [k for k in self.train_g if _group(k) == g] for g in lr_of}
        self.opt_g = {g: (ks, optimizer(og, [(k, self.train_g[k]) for k in ks],
                                        lr_schedule(lr_of[g]), betas))
                      for g, ks in names.items() if ks}
        d_reg_ratio = self.net_d_reg_every / (self.net_d_reg_every + 1)
        d_betas = (0.0 ** d_reg_ratio, 0.99 ** d_reg_ratio)
        if od2.get("lr") is not None and od2.get("lr") != od.get("lr", 2e-5):
            # the reference builds the latent D's param group with optim_d's lr
            logger.warning("optim_d2.lr=%s is ignored (latent D trains at "
                           "optim_d.lr=%s, reference param-group quirk)",
                           od2.get("lr"), od.get("lr", 2e-5))
        self.opt_d = self.opt_d2 = None
        if self.net_d is not None:
            self.opt_d = optimizer(od, list(self.net_d.named_parameters()),
                                   lr_schedule(od.get("lr", 2e-5)), d_betas)
        if self.net_d2 is not None:
            self.opt_d2 = optimizer(od2, list(self.net_d2.named_parameters()),
                                    lr_schedule(od.get("lr", 2e-5)), d_betas)

    def _grads(self, loss, params):
        """Gradients of `loss` w.r.t. params, zero where it does not reach
        one (JAX's gradient there), averaged over the ranks."""
        grads = (torch.autograd.grad(loss, params, allow_unused=True)
                 if loss.requires_grad else [None] * len(params))
        return dist.average_gradients(
            [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])

    def _update(self, optimizer, net, loss):
        """One step of a discriminator, its gradients clipped by their
        global norm."""
        params = list(net.parameters())
        optimizer.step(clip_by_global_norm(self._grads(loss, params), self.grad_clip_norm))

    def _update_g(self, loss):
        """The generator's step (each optimizer group on its parameters,
        after one clip over all of them), then the EMA."""
        grads = self._grads(loss, list(self.train_g.values()))
        by_name = dict(zip(self.train_g, clip_by_global_norm(grads, self.grad_clip_norm)))
        for names, optimizer in self.opt_g.values():
            optimizer.step([by_name[k] for k in names])
        with torch.no_grad():
            ema, new = list(self.ema.values()), list(self.train_g.values())
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - self.ema_decay))

    # ------------------------------------------------------------------
    def schedule_at(self, step: int):
        return progressive_schedule(
            step, style_cnt=self.style_cnt, initial_stage=self.initial_stage,
            progressive_mod_size=self.progressive_mod_size,
            progressive_stage_steps=self.progressive_stage_steps)

    def _forward(self, x, mod_size, stage, noise):
        """The arch on NHWC x; NHWC outputs."""
        return self.net_g(x, mod_size=mod_size, stage=stage,
                          noise=noise)

    def _d_losses(self, gt, fake, do_r1):
        real_pred, _ = self.net_d(gt)
        fake_pred, _ = self.net_d(fake)
        l_d = (self.cri_gan(real_pred, True, is_disc=True)
               + self.cri_gan(fake_pred, False, is_disc=True))
        aux = {"l_d": l_d, "real_score": real_pred.mean(), "fake_score": fake_pred.mean()}
        if do_r1:
            r1 = r1_penalty_fn(lambda im: self.net_d(im)[0], gt)
            aux["l_d_r1"] = self.r1_reg_weight / 2 * r1 * self.net_d_reg_every
            l_d = l_d + aux["l_d_r1"]
        return l_d, aux

    def _d2_losses(self, real_lats, fake_lats, do_r1):
        real_pred, _ = self.net_d2(real_lats)
        fake_pred, _ = self.net_d2(fake_lats)
        loss = (self.cri_gan(real_pred, True, is_disc=True)
                + self.cri_gan(fake_pred, False, is_disc=True))
        aux = {"l_latent_d": loss, "real_latent_score": real_pred.mean(),
               "fake_latent_score": fake_pred.mean()}
        if do_r1:
            r1 = r1_penalty_fn(lambda lt: self.net_d2(lt)[0], real_lats)
            aux["l_latent_d_r1"] = self.r1_reg_weight / 2 * r1 * self.net_d_reg_every
            loss = loss + aux["l_latent_d_r1"]
        return loss, aux

    def _real_latents(self, n, z):
        """Style-MLP latents of this rank's rows of the global batch's z
        (drawn for the global batch when None), no grad."""
        if z is None:
            z = torch.randn((n * dist.world_size(), self.net_g.style_dim),
                            generator=self.rng, device=self.device)
        with torch.no_grad():
            return self.net_g.random_latents(dist.local_rows(torch.as_tensor(
                z, device=self.device)))

    def _g_losses(self, out, gt, batch, do_g_gan, do_lat_gan, total=None):
        """(total, logs) of the generator's losses on the NHWC output dict
        `out` against the ground truth gt (also the input), with the
        discriminators as they are now, added to `total` when given."""
        fake = out["image"]
        b, k = batch[self.which_gt].shape[:2]
        if total is None:
            total = torch.zeros((), device=self.device)
        aux = {}
        sg = (lambda t: t) if self.g_gan_live_grad else (lambda t: t.detach())
        if do_g_gan:
            aux["l_g"] = self.cri_gan(self.net_d(sg(fake))[0], True, is_disc=False)
            total = total + aux["l_g"]
        if do_lat_gan:
            aux["l_latent_g"] = self.cri_gan(self.net_d2(sg(out["lats"]))[0], True,
                                             is_disc=False)
            total = total + aux["l_latent_g"]
        if self.cri_id is not None:
            shape5 = (b, k) + tuple(fake.shape[1:])
            l_id, l_ref = self.cri_id(fake.reshape(shape5), gt.reshape(shape5),
                                      gt.reshape(shape5), mimo_id=self.is_mimo,
                                      score=batch.get("lq_size"))
            aux["l_id_target"] = l_id
            total = total + l_id + l_ref
        if self.cri_ldm is not None:        # reference order: id -> ldm -> pix
            aux["l_ldm"] = self.cri_ldm(fake, gt)
            total = total + aux["l_ldm"]
        if self.cri_pix is not None:
            aux["l_pix"] = self.cri_pix(fake, gt)
            total = total + aux["l_pix"]
        if self.cri_perceptual is not None:
            with torch.no_grad():       # the ground truth's features carry no grad
                gfeat = self.cri_perceptual.features(gt)
            l_p, l_s = self.cri_perceptual.compare(self.cri_perceptual.features(fake), gfeat)
            if l_p is not None:
                aux["l_percep"] = l_p
                total = total + l_p
            if l_s is not None:
                aux["l_style"] = l_s
                total = total + l_s
        if self.cri_latent_reg is not None:
            dl = self.net_g.delta_latent
            aux["l_latent_reg"] = self.cri_latent_reg(dl, torch.zeros_like(dl))
            total = total + aux["l_latent_reg"]
        if self.cri_mask is not None and out["aligns"]:
            aux["l_bin"], aux["l_area"] = self.cri_mask(out["aligns"])
            total = total + aux["l_bin"] + aux["l_area"]
        aux["l_total"] = total
        return total, aux

    # ------------------------------------------------------------------
    def _d_phase(self, x, mod_size, stage, do_r1, noise):
        with torch.no_grad():
            fake = self._forward(x, mod_size, stage, noise)["image"]
        l_d, aux = self._d_losses(x, fake, do_r1)
        self._update(self.opt_d, self.net_d, l_d)
        return aux

    def _d2_phase(self, x, stage, do_r1, z, noise):
        enc_noise, _ = self.net_g.split_noise(noise)
        with torch.no_grad():
            enc_lats, _ = self.net_g.encode(x.permute(0, 3, 1, 2), stage=stage, noise=enc_noise)
        loss, aux = self._d2_losses(self._real_latents(x.shape[0], z), enc_lats, do_r1)
        self._update(self.opt_d2, self.net_d2, loss)
        return aux

    def _fused_phase(self, batch, x, mod_size, stage, do_d, do_d2, do_r1_d, do_r1_d2,
                     noise, z):
        """One G forward with its graph kept; the D and latent-D updates on
        its detached outputs; the G losses against the updated
        discriminators, backpropagated through the kept graph; the EMA."""
        out = self._forward(x, mod_size, stage, noise)
        logs = {}
        if do_d:
            l_d, aux = self._d_losses(x, out["image"].detach(), do_r1_d)
            self._update(self.opt_d, self.net_d, l_d)
            logs.update(aux)
        if do_d2:
            loss, aux = self._d2_losses(self._real_latents(x.shape[0], z),
                                        out["lats"].detach(), do_r1_d2)
            self._update(self.opt_d2, self.net_d2, loss)
            logs.update(aux)
        total, aux = self._g_losses(out, x, batch, do_d, do_d2)
        self._update_g(total)
        logs.update(aux)
        return logs

    def _g_phase(self, batch, x, mod_size, stage, do_g_gan, do_lat_gan, do_path_reg,
                 noise, path_cot):
        aux, total = {}, None
        if do_path_reg:
            # path-length regularization: the decode's vjp w.r.t. the W+
            # latents, kept in the graph so that its penalty differentiates
            xc = x.permute(0, 3, 1, 2)
            enc_noise, dec_noise = self.net_g.split_noise(noise)
            lats, feats_c = self.net_g.encode(xc, stage=stage, noise=enc_noise)
            if not lats.requires_grad:
                lats = lats.detach().requires_grad_()
            # feats_c is what encode hands its decode (FeatureStyle: the
            # adapted features and the content)
            out = nhwc_outputs(self.net_g.decode_samm(lats, feats_c, xc, mod_size, dec_noise))
            fake = out["image"]
            if path_cot is None:
                path_cot = torch.randn((fake.shape[0] * dist.world_size(),) + fake.shape[1:],
                                       generator=self.rng, device=self.device) / math.sqrt(
                                           fake.shape[1] * fake.shape[2])
            path_cot = dist.local_rows(torch.as_tensor(path_cot, device=self.device))
            (grad_lats,) = torch.autograd.grad(fake, lats, path_cot, create_graph=True)
            l_path, aux["path_length"], new_mpl = path_regularize_stats(
                grad_lats, self.mean_path_length)
            aux["l_g_path"] = total = self.path_reg_weight * self.net_g_reg_every * l_path
        else:
            out = self._forward(x, mod_size, stage, noise)
        total, g_aux = self._g_losses(out, x, batch, do_g_gan, do_lat_gan, total)
        self._update_g(total)
        if do_path_reg:
            self.mean_path_length = new_mpl
        return {**aux, **g_aux}

    # ------------------------------------------------------------------
    def train_step(self, batch, step: int, noise=None, path_cot=None, z=None):
        """One train step at `step` (the curriculum and the regularizers'
        cadence read it). batch: {which_gt: (B, K, H, W, 3) NHWC in [-1, 1],
        'lq_size': (B, K) scores for the MIMO identity loss}, tensors or
        arrays. noise: the per-layer (B*K, 1, h, w) noise list of every G
        forward of the step (the arch's `make_noise` list: ReStyle's holds
        its encoder's decodes too, and its latent-D phase encodes with
        them), one list for all of the step's phases; path_cot: (B*K, H,
        W, 3); z: (B*K, style_dim). Each is drawn from the model's
        generator when None. Under a process group `batch` is this rank's
        shard, and noise, path_cot and z (given or drawn) are the global
        batch's, of which each rank takes its rows. Returns the logged
        losses (the global batch's), 0-d tensors on the device (no host
        sync)."""
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                    device=self.device)
                 for k, v in batch.items() if k in (self.which_gt, "lq_size")}
        stage, mod_size = self.schedule_at(step)
        do_d = self.cri_gan is not None and not self.skip_gen_g
        do_d2 = (self.cri_gan is not None and not self.skip_latent_g
                 and self.net_d2 is not None)
        do_r1_d = do_d and step % self.net_d_reg_every == 0
        do_r1_d2 = do_d2 and step % self.net_d_reg_every == 0
        gt5 = batch[self.which_gt]
        local_n = gt5.shape[0] * gt5.shape[1]
        batch_n = local_n * dist.world_size()             # the global batch
        path_batch_ok = batch_n > 1 or self.path_batch_shrink is not None
        do_path_reg = (self.cri_gan is not None and path_batch_ok
                       and step % self.net_g_reg_every == 0)
        if (self.cri_gan is not None and not path_batch_ok
                and self.net_g_reg_every < 10 ** 6 and not self._warned_path_reg):
            logger.warning("batch size 1 without train.path_batch_shrink: path-length "
                           "regularization will never run (reference gate); set "
                           "path_batch_shrink to enable")
            self._warned_path_reg = True
        x = gt5.reshape((-1,) + tuple(gt5.shape[2:]))
        if noise is None:                           # one draw for every phase
            noise = self.net_g.make_noise(batch_n, self.rng, self.device)
        noise = [dist.local_rows(torch.as_tensor(t, device=self.device)) for t in noise]

        if self.fused_step and not do_path_reg and (do_d or do_d2):
            logs = self._fused_phase(batch, x, mod_size, stage, do_d, do_d2, do_r1_d,
                                     do_r1_d2, noise, z)
        else:
            logs = {}
            if do_d:
                logs.update(self._d_phase(x, mod_size, stage, do_r1_d, noise))
            if do_d2:
                logs.update(self._d2_phase(x, stage, do_r1_d2, z, noise))
            logs.update(self._g_phase(batch, x, mod_size, stage, do_d, do_d2,
                                      do_path_reg, noise, path_cot))
        return dist.reduce_logs({k: v.detach() for k, v in logs.items()})

    # ------------------------------------------------------------------
    @property
    def batch_keys(self):
        """The batch entries `train_step` reads."""
        return (self.which_gt, "lq_size")

    def make_noise(self, batch: int, generator: torch.Generator):
        """The noise of one G forward at `batch` (the arch's `make_noise`),
        drawn from `generator` (e.g. validation's own)."""
        return self.net_g.make_noise(batch, generator, self.device)

    def _nets(self):
        return {"net_g": self.net_g, "net_d": self.net_d, "net_d2": self.net_d2,
                "cri_perceptual": self.cri_perceptual, "cri_id": self.cri_id}

    def _optimizers(self):
        opts = {f"opt_g.{g}": o for g, (_, o) in self.opt_g.items()}
        return {**opts, "opt_d": self.opt_d, "opt_d2": self.opt_d2}

    def state_dict(self):
        """The whole training state, device tensors by reference: every
        net's state_dict (the frozen loss nets too), the EMA, each
        optimizer's moments and update count, the path regularizer's
        running mean and the state of the model's generator `rng`."""
        return {"nets": {k: m.state_dict() for k, m in self._nets().items() if m is not None},
                "ema": dict(self.ema),
                "optimizers": {k: o.state_dict() for k, o in self._optimizers().items()
                               if o is not None},
                "mean_path_length": self.mean_path_length,
                "rng": self.rng.get_state()}

    @torch.no_grad()
    def load_state_dict(self, state):
        """Restores `state_dict()`'s output (from any device) in place;
        every net strictly, and every entry must be there."""
        nets = {k: m for k, m in self._nets().items() if m is not None}
        opts = {k: o for k, o in self._optimizers().items() if o is not None}
        if set(state["nets"]) != set(nets) or set(state["optimizers"]) != set(opts):
            raise ValueError(f"the state holds nets {sorted(state['nets'])} and optimizers "
                             f"{sorted(state['optimizers'])}; the model has {sorted(nets)} "
                             f"and {sorted(opts)}")
        if set(state["ema"]) != set(self.ema):
            raise ValueError("the state's EMA is not over the model's trainable parameters")
        for k, m in nets.items():
            m.load_state_dict(state["nets"][k], strict=True)
        for k, v in state["ema"].items():
            self.ema[k].copy_(v)
        for k, o in opts.items():
            o.load_state_dict(state["optimizers"][k])
        self.mean_path_length = state["mean_path_length"].to(self.device).clone()
        self.rng.set_state(state["rng"].cpu())

    def eval_params(self, ema: bool = False):
        """net_g's state_dict, the trainable entries from the EMA when
        `ema`."""
        state = dict(self.net_g.state_dict())
        if ema:
            state.update(self.ema)
        return state

    @contextlib.contextmanager
    def _ema_weights(self):
        """The EMA in the trainable parameters for the duration."""
        with torch.no_grad():
            saved = {k: p.detach().clone() for k, p in self.train_g.items()}
            for k, p in self.train_g.items():
                p.copy_(self.ema[k])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in self.train_g.items():
                    p.copy_(saved[k])

    def infer(self, x, step=None, ema: bool = False, noise=None):
        """The arch's NHWC outputs for NHWC x at the curriculum of `step`
        (the last one when None), with the current or the EMA weights."""
        stage, mod_size = self.schedule_at(step if step is not None else 10 ** 9)
        x = torch.as_tensor(x, device=self.device)
        with torch.no_grad(), (self._ema_weights() if ema else contextlib.nullcontext()):
            return self._forward(x, mod_size, stage, noise)
