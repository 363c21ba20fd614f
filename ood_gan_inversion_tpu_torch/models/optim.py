"""Optimizers and learning-rate schedules of the trainer (counterpart of
models/optim.py and of the schedules in models/ood_model.py), written out
as optax computes them so that the port's updates are JAX's:

  * Adam is optax `scale_by_adam` then `scale_by_schedule(-lr)`:
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
    update = -lr(count) * mu_hat / (sqrt(nu_hat) + eps), with the bias
    corrections of step count + 1. torch.optim.Adam divides in another
    order and skips parameters without a gradient; optax counts those as
    a zero gradient, and so does this one.
  * SGD is optax `trace(momentum)` (if any) then `scale_by_schedule(-lr)`.
  * Ranger is JAX's `ranger` as its trainer builds it: gradient
    centralization, optax `scale_by_radam` (rectification threshold 5),
    `scale_by_schedule(-lr)`, all inside `lookahead_flat` (slow weights
    pulled half of the way to the fast ones every 6 updates, the fast
    weights set to them). Its scalars (the bias corrections, RAdam's rho
    and r) are computed in float32 as optax computes them: at b2 = 0.999
    rho is a difference of two numbers near 2000, so its float32 rounding
    decides the first rectified steps.
  * A schedule reads each optimizer's own count of updates, starting at 0,
    like optax's `scale_by_schedule`, not the train step.
  * `clip_by_global_norm` scales by max_norm / norm only when the global
    norm reaches max_norm (optax's rule; torch's clip_grad_norm_ adds 1e-6
    to the norm).

The schedules: MultiStepLR and CosineAnnealingRestartLR (BasicSR's, as
JAX's `cosine_annealing_restart_lr` computes it in float32), each with an
optional linear warm-up.
"""

import math

import numpy as np
import torch


def multistep_lr(base_lr: float, milestones, gamma: float):
    """torch MultiStepLR as a schedule of the update count. An int
    milestone means 'decay every milestones steps' (the shipped YAML gives
    a scalar); a list decays at each milestone."""
    if milestones is None:
        return lambda count: base_lr
    if isinstance(milestones, (int, float)):
        period = int(milestones)
        return lambda count: base_lr * gamma ** (count // period)
    ms = sorted(int(m) for m in milestones)
    return lambda count: base_lr * gamma ** sum(count >= m for m in ms)


def cosine_annealing_restart_lr(base_lr: float, periods, restart_weights=None,
                                eta_min: float = 0.0):
    """BasicSR's CosineAnnealingRestartLR as a schedule of the update
    count: within period i (from the sum of the periods before it) the lr
    falls from eta_min + w_i (base_lr - eta_min) to eta_min along half a
    cosine; past the last period it stays at eta_min. Float32 arithmetic
    in JAX's order (near a period's end 1 + cos(pi t) is a difference of
    numbers near 1, so the float32 rounding is part of the schedule)."""
    restart_weights = list(restart_weights or [1.0] * len(periods))
    if len(restart_weights) != len(periods):
        raise ValueError("periods and restart_weights must have the same length")
    f32 = np.float32
    cum = np.cumsum([0] + list(periods))
    span = f32(base_lr - eta_min)           # a Python float, rounded to float32 once
    pi = f32(math.pi)

    def schedule(count):
        step = f32(count)
        idx = min(int(np.searchsorted(cum[1:].astype(f32), step, side="right")),
                  len(periods) - 1)
        t = min(max((step - f32(cum[idx])) / f32(periods[idx]), f32(0.0)), f32(1.0))
        cos = f32(math.cos(float(pi * t)))
        return float(f32(eta_min) + f32(restart_weights[idx]) * f32(0.5) * span
                     * (f32(1.0) + cos))

    return schedule


def linear_warmup(schedule, warmup_iter: int):
    """schedule(count) * min(1, (count + 1) / warmup_iter) when warmup_iter
    > 0, else the schedule as it is."""
    if not warmup_iter or warmup_iter <= 0:
        return schedule
    return lambda count: schedule(count) * min(1.0, (count + 1.0) / warmup_iter)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(g / norm) * max_norm for every gradient when their global norm is at
    least max_norm, else the gradients as they are (divided and multiplied
    by 1: exact). The test stays on the device; nothing waits for it."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    return torch._foreach_mul(torch._foreach_div(grads, torch.where(keep, one, norm)),
                              torch.where(keep, one, one * max_norm))


def _load_moments(what, dst, src):
    """Copies a saved list of per-parameter tensors into dst, in place."""
    if len(dst) != len(src) or any(d.shape != t.shape for d, t in zip(dst, src)):
        raise ValueError(f"{what}: the saved state does not fit the parameters")
    for d, t in zip(dst, src):
        d.copy_(t)


class Adam:
    """Adam over a list of parameters, updated in place by `step(grads)`."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda count, v=lr: v)
        self.b1, self.b2 = betas
        self.eps = eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self):
        """The moments and the update count (the parameters are the
        model's)."""
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state):
        _load_moments("Adam", self.mu, state["mu"])
        _load_moments("Adam", self.nu, state["nu"])
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, grads):
        """grads: one tensor (or None, a zero gradient) per parameter."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - b2))
        lr = self.lr(self.count)
        self.count += 1
        # the bias corrections in float32, as optax computes them: at b2 =
        # 0.999, 1 - b2 in float32 is 1.3e-5 off its double value
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
        mu_hat = torch._foreach_div(self.mu, bc1)
        nu_hat = torch._foreach_div(self.nu, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -lr)
        torch._foreach_add_(self.params, upd)


class SGD:
    """SGD with optax's trace momentum: t = g + momentum * t; p -= lr t."""

    def __init__(self, params, lr, momentum=0.0):
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda count, v=lr: v)
        self.momentum = momentum
        self.count = 0
        self.trace = [torch.zeros_like(p) for p in self.params] if momentum else None

    def state_dict(self):
        return {"count": self.count,
                "trace": None if self.trace is None else list(self.trace)}

    @torch.no_grad()
    def load_state_dict(self, state):
        if (state["trace"] is None) != (self.trace is None):
            raise ValueError("SGD: the state's momentum does not match the optimizer's")
        if self.trace is not None:
            _load_moments("SGD", self.trace, state["trace"])
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, grads):
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if self.trace is not None:
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, grads)
            grads = self.trace
        lr = self.lr(self.count)
        self.count += 1
        torch._foreach_add_(self.params, torch._foreach_mul(grads, -lr))


class Ranger:
    """Ranger over a list of parameters, updated in place by `step(grads)`.
    JAX's trainer gives it only an lr (make_optimizer's ranger_betas and
    eps are its defaults there); the knobs it never sets keep `ranger`'s
    defaults, fixed here: lookahead every K = 6 updates with
    ALPHA 0.5, gradient centralization on, no weight decay. gc_axis: per
    parameter, the axis that gradient centralization keeps (the others are
    averaged out, as JAX's are over all axes but its layout's first;
    `convert.jax_first_axis` gives it), 0 by default. The slow weights are
    the parameters as the first step finds them (the reference's Ranger
    keeps them from its first step too)."""

    K, ALPHA = 6, 0.5

    def __init__(self, params, lr, betas=(0.95, 0.999), eps=1e-5, gc_axis=None):
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda count, v=lr: v)
        self.b1, self.b2 = betas
        self.eps = eps
        self.gc_axis = list(gc_axis) if gc_axis is not None else [0] * len(self.params)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.slow = None

    def state_dict(self):
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu),
                "slow": None if self.slow is None else list(self.slow)}

    @torch.no_grad()
    def load_state_dict(self, state):
        _load_moments("Ranger", self.mu, state["mu"])
        _load_moments("Ranger", self.nu, state["nu"])
        if state["slow"] is None:
            self.slow = None
        else:
            self.slow = [torch.empty_like(p) for p in self.params]
            _load_moments("Ranger", self.slow, state["slow"])
        self.count = int(state["count"])

    def _centralized(self, grads):
        out = []
        for g, a in zip(grads, self.gc_axis):
            if g.ndim >= 2:
                g = g - g.mean(dim=tuple(d for d in range(g.ndim) if d != a), keepdim=True)
            out.append(g)
        return out

    def _radam_scalars(self, count):
        """(1 - b1^t, 1 - b2^t, rho_t, r_t) in float32, optax's order."""
        f32 = np.float32
        b1t, b2t = f32(self.b1) ** f32(count), f32(self.b2) ** f32(count)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1.0) - b2t)
        with np.errstate(invalid="ignore"):
            r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                        / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        return f32(1.0) - b1t, f32(1.0) - b2t, ro, r

    @torch.no_grad()
    def step(self, grads):
        grads = self._centralized([torch.zeros_like(p) if g is None else g
                                   for p, g in zip(self.params, grads)])
        if self.slow is None:
            self.slow = [p.detach().clone() for p in self.params]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - b2))
        lr = self.lr(self.count)
        self.count += 1
        bc1, bc2, ro, r = self._radam_scalars(self.count)
        upd = torch._foreach_div(self.mu, float(bc1))
        if ro >= 5.0:                       # rectified: r mu_hat / (sqrt(nu_hat) + eps)
            denom = torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(self.nu, float(bc2))), self.eps)
            upd = torch._foreach_div(torch._foreach_mul(upd, float(r)), denom)
        torch._foreach_mul_(upd, -lr)
        if self.count % self.K:
            torch._foreach_add_(self.params, upd)
            return
        # a lookahead sync: slow += alpha (fast - slow); the parameters move
        # by (slow - p), JAX's emitted update
        fast = torch._foreach_add(self.params, upd)
        torch._foreach_add_(self.slow, torch._foreach_mul(torch._foreach_sub(fast, self.slow),
                                                          self.ALPHA))
        torch._foreach_add_(self.params, torch._foreach_sub(self.slow, self.params))


def make_optimizer(optim_type: str, params, lr, betas=(0.9, 0.999), **kwargs):
    """The optimizer of a YAML `optim_*` type: Adam, SGD or Ranger (which
    reads `ranger_betas`, default (0.95, 0.999), not `betas`, and `eps`
    1e-5 by default, as JAX's make_optimizer does; `gc_axis` as Ranger
    takes it)."""
    if optim_type == "Adam":
        return Adam(params, lr, betas, kwargs.get("eps", 1e-8))
    if optim_type == "SGD":
        return SGD(params, lr, kwargs.get("momentum", 0.0))
    if optim_type == "Ranger":
        return Ranger(params, lr, betas=tuple(kwargs.get("ranger_betas", (0.95, 0.999))),
                      eps=kwargs.get("eps", 1e-5), gc_axis=kwargs.get("gc_axis"))
    raise NotImplementedError(f"optimizer {optim_type}")
