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
  * A schedule reads each optimizer's own count of updates, starting at 0,
    like optax's `scale_by_schedule`, not the train step.
  * `clip_by_global_norm` scales by max_norm / norm only when the global
    norm reaches max_norm (optax's rule; torch's clip_grad_norm_ adds 1e-6
    to the norm).

Ranger and the cosine-restart schedule are not ported (no shipped config
uses them).
"""

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


def make_optimizer(optim_type: str, params, lr, betas=(0.9, 0.999), **kwargs):
    """The optimizer of a YAML `optim_*` type: Adam or SGD."""
    if optim_type == "Adam":
        return Adam(params, lr, betas, kwargs.get("eps", 1e-8))
    if optim_type == "SGD":
        return SGD(params, lr, kwargs.get("momentum", 0.0))
    if optim_type == "Ranger":
        raise NotImplementedError("optimizer Ranger is not ported yet (ROADMAP A7)")
    raise NotImplementedError(f"optimizer {optim_type}")
