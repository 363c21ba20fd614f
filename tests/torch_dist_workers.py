"""Worker functions of the port's multi-process tests
(tests/test_torch_parallel.py), run on gloo ranks by
`ood_gan_inversion_tpu_torch.parallel.dryrun.Ranks` (spawned processes, a
FileStore rendezvous, a hard time limit), one rank alone being the
one-process reference.

This module imports no JAX, so that the spawned ranks do not load it.
"""

import contextlib
import copy
import logging

import numpy as np
import torch

from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
from ood_gan_inversion_tpu_torch.parallel import Replicas, dist, make_mesh, spatial

CPU = torch.device("cpu")
NETS = ("net_g", "net_d", "net_d2")


def _rows(a):
    return dist.local_rows(torch.from_numpy(np.ascontiguousarray(a)))


def take_step(case):
    """One train step of a port model on the case's state, as this rank
    takes it. case: {"opt", "state" (a path of OODFaceGANModel.state_dict()),
    "step", "batch" (the global batch, numpy), "noise" (the global
    per-layer list, NCHW), "cot", "z" (global, or None: drawn), and
    optionally "sp": (slots, min_h), the step then taken inside
    `spatial.banding` over a mesh of those slots}. Returns
    the logs, the gradients the optimizers were given ({net: {name:
    tensor}}, averaged over the ranks), those parameters after the step,
    the path mean, and every rank's checksum of its nets' state."""
    model = OODFaceGANModel(copy.deepcopy(case["opt"]), device="cpu")
    model.load_state_dict(torch.load(case["state"], weights_only=True))
    dist.broadcast_state(model, CPU)
    names = {id(p): (net, n) for net in NETS if getattr(model, net) is not None
             for n, p in getattr(model, net).named_parameters()}
    grads = {}
    inner = model._grads

    def record(loss, params):
        out = inner(loss, params)
        for p, g in zip(params, out):
            net, n = names[id(p)]
            grads.setdefault(net, {})[n] = g.detach().clone()
        return out

    model._grads = record
    opt = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    sp = case.get("sp")
    banding = (spatial.banding(make_mesh(sp[0], axes=("sp",)), Replicas(model.net_g, CPU), sp[1])
               if sp else contextlib.nullcontext())
    with banding:
        logs = model.train_step({k: _rows(v) for k, v in case["batch"].items()}, case["step"],
                                noise=None if case["noise"] is None
                                else [opt(n) for n in case["noise"]],
                                path_cot=opt(case["cot"]), z=opt(case["z"]))
    # the trainable parameters only (those the optimizers were given): the
    # frozen encoder's full-width style heads would multiply what every
    # rank sends back
    after = {net: {k: p.detach().clone() for k, p in getattr(model, net).named_parameters()
                   if k in grads.get(net, {})}
             for net in NETS if getattr(model, net) is not None}
    return {"logs": {k: float(v) for k, v in logs.items()}, "grads": grads, "after": after,
            "mpl": float(model.mean_path_length),
            "checksums": dist.replica_checksums(
                [t for net in NETS if getattr(model, net) is not None
                 for t in getattr(model, net).state_dict().values()], CPU)}


def take_steps(cases):
    return [take_step(c) for c in cases]


def two_ranks(cases, pipeline_args):
    """A 2-rank group's runs, one after another: take_steps(cases),
    collectives(), broadcast(cases[0]), pipeline(*pipeline_args)."""
    return {"steps": take_steps(cases), "collectives": collectives(),
            "broadcast": broadcast(cases[0]), "pipeline": pipeline(*pipeline_args)}


def _perturbations(model):
    """{kind: a function that moves that part of the training state}."""
    def add(t):
        return lambda: t.add_(1.0)

    def count():
        model.opt_d.count += 3

    return {"weights": add(next(iter(model.train_g.values())).data),
            "discriminator": add(next(model.net_d.parameters()).data),
            "ema": add(next(iter(model.ema.values()))),
            "moments": add(model.opt_d.mu[0]),
            "count": count,
            "path mean": add(model.mean_path_length),
            "rng": lambda: torch.randn(1, generator=model.rng)}


@torch.no_grad()
def broadcast(case):
    """broadcast_state, one part of the state at a time: the case's state
    loaded on both ranks; for each kind of entry, rank 1 moves it, the
    replicas' check runs, then the broadcast. Returns {kind: (whether the
    check passed before the broadcast, whether this rank's whole state is
    then the loaded one bit for bit, the checksums after)}."""
    model = OODFaceGANModel(copy.deepcopy(case["opt"]), device="cpu")
    model.load_state_dict(torch.load(case["state"], weights_only=True))
    ref = [t.clone() for t in dist._tensor_leaves(model.state_dict())]
    ref_counts = dist._counts(model)
    out = {}
    for kind, move in _perturbations(model).items():
        if dist.rank() == 1:
            move()
        try:
            dist.check_replicas(model, CPU)
            agreed = True
        except RuntimeError:
            agreed = False
        dist.broadcast_state(model, CPU)
        state = dist._tensor_leaves(model.state_dict())
        same = dist._counts(model) == ref_counts and len(state) == len(ref) and all(
            torch.equal(a, b) for a, b in zip(state, ref))
        out[kind] = (agreed, same, dist.check_replicas(model, CPU))
    return out


def collectives():
    """The collectives on this rank, at rank r holding x_r = r + 1 + the
    arange: (all_reduce_sum, its gradient and its gradient's gradient;
    gather_batch and the gradient of a loss through it; global_mean;
    average_gradients; reduce_logs; the checksums of equal and of differing
    tensors)."""
    r, n = dist.rank(), dist.world_size()
    x = (torch.arange(3, dtype=torch.float64) + r + 1).requires_grad_()
    y = dist.all_reduce_sum(x * x)
    (g,) = torch.autograd.grad(y.sum() * (r + 1), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), x)
    rows = x.reshape(1, 3)
    full = dist.gather_batch(rows)
    (gr,) = torch.autograd.grad((full * torch.arange(1, n + 1, dtype=torch.float64)[:, None]
                                 ).square().sum(), x)
    return {"sum": y.detach(), "grad": g.detach(), "gradgrad": gg, "gathered": full.detach(),
            "gather_grad": gr, "mean": dist.global_mean(x.detach()),
            "avg": dist.average_gradients([x.detach() * 2, torch.ones(2) * r]),
            "logs": dist.reduce_logs({"b": torch.tensor(float(r)), "a": torch.tensor(2.0)}),
            "same": dist.replica_checksums([torch.ones(5), torch.zeros(3, dtype=torch.int32)],
                                           CPU),
            "differ": dist.replica_checksums([torch.ones(5) + r], CPU)}


def pipeline(args_run, args_resume, args_wrong, root, batch, step):
    """train_pipeline on this rank: a run, the next step on `batch` (the
    global batch) from its final state, then a run of `args_resume`
    (--auto_resume) and the same step from the state it resumed; then a
    run of `args_wrong`, which must raise. Returns the files this rank's
    checkpoint writer wrote, the iteration resumed from, both steps' logs,
    whether the two states after the step are bit for bit one, the
    replicas' checksums, the root logger's log files and the error of the
    wrong run."""
    from ood_gan_inversion_tpu_torch.train import train_pipeline
    from ood_gan_inversion_tpu_torch.utils import checkpoint as ckpt
    from ood_gan_inversion_tpu_torch.utils.logger import get_root_logger

    writes = []
    save_file = ckpt.save_file

    def spy(tree, path, retry=3):
        writes.append(path)
        return save_file(tree, path, retry)

    ckpt.save_file = spy
    local = {k: _rows(v) for k, v in batch.items()}
    run = train_pipeline(root, args_run)
    logs_a = run.model.train_step(local, step)
    state_a = [t.clone() for t in dist._tensor_leaves(run.model.state_dict())]
    del run
    dist.barrier()
    resumed = train_pipeline(root, args_resume)
    logs_b = resumed.model.train_step(local, step)
    state_b = dist._tensor_leaves(resumed.model.state_dict())
    error = None
    try:
        train_pipeline(root, args_wrong)
    except ValueError as e:
        error = str(e)
    return {"writes": writes, "resumed_from": resumed.start_iter,
            "log_files": [h.baseFilename for h in get_root_logger().handlers
                          if isinstance(h, logging.FileHandler)],
            "logs": ({k: float(v) for k, v in logs_a.items()},
                     {k: float(v) for k, v in logs_b.items()}),
            "bitwise": len(state_a) == len(state_b) and all(
                torch.equal(a, b) for a, b in zip(state_a, state_b)),
            "checksums": dist.check_replicas(resumed.model, CPU), "error": error}
