"""The port's data-parallel training (parallel/dist.py, models/ood_model.py
under a process group, train.py on several ranks) on gloo processes on the CPU, against JAX's mesh-sharded train step and
against the port's own one-process step.

The model is tests/test_parallel.py's `_tiny_opt` (32px, ModSize 32,
cycle_align 1, the 4-layer IR-SE trunk, GAN, MSE and mask losses) with
the generator and the discriminator at narrow 0.25, at a global batch of
4. JAX runs its step on a 2-device mesh of the test session's virtual CPU
devices, the port on 2 gloo processes of 2 samples each; both from the
same seeded weights (JAX's TrainState loaded into the port through the
bridge) and the same global noise, path cotangent and z (JAX's noise fed
to its forward as tests/test_torch_train.py feeds it). The cases: step 0
with `net_d_reg_every = net_g_reg_every = 1` (R1 in the D phase, the
path regularizer in the G phase) and a fused step. The reg case also runs
banded (parallel/spatial.py, min_h 16: the 16px stage banded, its output
gathered into the 32px SAMM stage, whose output is banded again): on the
2 ranks with 2 CPU slots each, the port's counterpart of JAX's hybrid
("data", "sp") (2, 2) mesh step (tests/test_parallel.py), and in one
process on the slots ["cpu", "cpu:0"], a second device whose bands must
send their gradients to the trained parameters.

Tolerances:
  * against JAX: every logged loss within 1e-4 relative (LOSS_RTOL; the
    area hinge within 1e-4 of the terms it subtracts, loss_weight x the
    area target, as the case puts the target near the mask's mean); every
    gradient within 1e-3 of its leaf's max|ref| (GRAD_RTOL, with
    tests/test_torch_train.py's floor for leaves whose exact gradient is
    0); every trainable parameter's update within 1e-3 of the max|update|
    (lr, Adam's first step with beta1 = 0) where the gradient decides its
    sign, as tests/test_torch_train.py:check_updates holds it (elsewhere
    an update is +-lr by float32 noise in both frameworks);
  * the n-rank step against the one-process step on the global batch
    (only the split of the batch's sums differs): logs within 1e-5
    relative (1e-6 absolute for the D scores, means of unit-scale terms
    that cancel), gradients within 1e-4 of their leaf's max, updates
    within 1e-4 of the max|update| where the gradient decides the sign;
  * the replicas bit for bit.
Every multi-process run has a hard time limit; its ranks are killed and
the test fails when it is exceeded."""

import copy
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from test_parallel import _tiny_opt
from test_torch_train import capture, equal_lr_fill, unflatten
from torch_parity import fill_params

from ood_gan_inversion_tpu.models import build_model
from ood_gan_inversion_tpu.parallel import (make_mesh, replicate_sharding, shard_batch,
                                            spatial_sharding)
from ood_gan_inversion_tpu_torch.convert import flatten_tree, load_jax_train_state, port_key, \
    port_value
from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
from ood_gan_inversion_tpu_torch.parallel import dist
from ood_gan_inversion_tpu_torch.parallel.dryrun import Ranks
from ood_gan_inversion_tpu_torch.train import num_devices

LOSS_RTOL, GRAD_RTOL, NOISE_FLOOR = 1e-4, 1e-3, 1e-3
FLOOR = GRAD_RTOL * NOISE_FLOOR
SELF_RTOL, SELF_ATOL = 1e-5, 1e-6
LR = 2e-5
B, SIZE = 4, 32
LIMIT_S = 240          # a multi-process run's hard limit
SP_MIN_H = 16          # the banded cases' min_h (tests/test_parallel.py's hybrid case)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def tiny_opt(**train):
    opt = _tiny_opt()
    opt["network_g"]["narrow"] = 0.25
    opt["network_d"]["narrow"] = 0.25
    opt["train"].update(train)
    return opt


def draws(seed):
    """The global batch, the per-layer noise (NCHW), the path cotangent
    (rank 1's rows 3x rank 0's: the ranks' path lengths differ) and z."""
    rs = np.random.RandomState(seed)
    batch = {"gt": (0.5 * rs.randn(B, 1, SIZE, SIZE, 3)).astype(np.float32),
             "lq_size": rs.rand(B, 1).astype(np.float32)}
    sizes = [4, 8, 8, 16, 16, 32, 32]
    noise = [rs.randn(B, 1, s, s).astype(np.float32) for s in sizes]
    cot = (rs.randn(B, SIZE, SIZE, 3) / SIZE).astype(np.float32)
    cot[B // 2:] *= 3.0
    z = rs.randn(B, 512).astype(np.float32)
    return batch, noise, cot, z


def jax_model(opt, noise, cot):
    """JAX's model for opt with its noise and path cotangent pinned and its
    gradients captured (tests/test_torch_train.py:Case)."""
    jm = build_model(copy.deepcopy(opt))
    for name in ("tx_g", "tx_d", "tx_d2"):
        setattr(jm, name, (lambda f: lambda: capture(f()))(getattr(jm, name)))
    jnoise = [jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise]
    net_t = type(jm.net_g)
    jm._forward = lambda pg, x, rng, mod_size, stage, train=True: jm.net_g.apply(
        {"params": pg}, x, mod_size=mod_size, stage=stage, train=train, noise=jnoise)
    jm._decode_samm = lambda pg, lats, feats_c, x, rng, mod_size: jm.net_g.apply(
        {"params": pg}, lats, feats_c, x, mod_size, method=net_t.decode_samm, train=True,
        noise=jnoise)
    jm._path_cot = lambda rng, shape, dtype: jnp.asarray(cot)
    return jm


def jax_state(jm, seed):
    shapes = jax.eval_shape(lambda r: jm._init_net_params(r, (B, SIZE, SIZE, 3)),
                            jax.random.PRNGKey(0))
    return jm._state_from_net_params({
        "g": unflatten(fill_params(shapes["g"], seed)),
        "d": unflatten(equal_lr_fill(shapes["d"], seed + 1)),
        "d2": unflatten(equal_lr_fill(shapes["d2"], seed + 2)), "loss": {}})


def port_model(opt, state):
    model = OODFaceGANModel(copy.deepcopy(opt), device="cpu")
    load_jax_train_state(model, state)
    return model


def mask_means(opt, state, batch, noise):
    """The 32px alpha's mean over each rank's two samples, from the port's
    forward on the initial state."""
    model = port_model(opt, state)
    x = torch.from_numpy(batch["gt"].reshape(B, SIZE, SIZE, 3))
    with torch.no_grad():
        out = model.net_g(x, mod_size=32, noise=[torch.from_numpy(n) for n in noise])
    m = out["aligns"][1][..., 2].reshape(2, -1).mean(dim=1)
    return float(m[0]), float(m[1])


def pipeline_args(d, exp):
    """workers.pipeline's arguments: micro_debug.yml narrowed, on the CPU,
    over 8 train and 1 validation seeded 64px PNGs written to d, 2
    iterations into exp; the same with --auto_resume; with the file's
    num_devices 1; the repo root; a global batch of 4 and step 3."""
    import cv2
    rs = np.random.RandomState(0)
    for sub, n in (("train", 8), ("val", 1)):
        (d / sub).mkdir()
        for i in range(n):
            cv2.imwrite(str(d / sub / f"{i}.png"), (rs.rand(64, 64, 3) * 255).astype(np.uint8))
    base = ["--opt", "options/train/micro_debug.yml", "--device", "cpu", "--force_yml",
            f"datasets:train:dataroot_gt={d}/train", f"datasets:val:dataroot_gt={d}/val",
            f"path:experiments_root={exp}", "train:total_iter=2",
            "datasets:train:num_worker_per_gpu=1", "network_g:narrow=0.25",
            "network_g:encoder_num_layers=4", "network_g:n_mlp=2", "network_d:narrow=0.25"]
    run = base + ["num_devices=2"]
    batch = {"gt": (0.5 * rs.randn(4, 1, 64, 64, 3)).astype(np.float32),
             "lq_size": rs.rand(4, 1).astype(np.float32)}
    return run, run + ["--auto_resume"], base, str(ROOT), batch, 3


def rows(case, r, n):
    """The case as rank r of n would see it alone: its shard of the global
    batch and of the draws, as a one-process batch."""
    b = B // n
    sl = slice(r * b, (r + 1) * b)
    return dict(case, batch={k: v[sl] for k, v in case["batch"].items()},
                noise=[t[sl] for t in case["noise"]], cot=case["cot"][sl], z=case["z"][sl])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the module's tests, the spawned ones started first so
    that they overlap JAX's steps:
      * "cases": {name: case for the workers}: "reg", step 0 with both
        regularizers every step (the area target set between the two
        ranks' mask means, so the hinge is active on one rank only), and
        "fused", a fused step 1; one seeded state for both;
      * "jax": {name: (JAX's state after, its logs)}, each step on a
        2-device mesh, and "hybrid", the reg case on a ("data", "sp")
        (2, 2) mesh inside spatial_sharding(min_h 16);
      * "two": both cases, then the reg case banded over 2 CPU slots per
        rank ("hybrid"), on 2 gloo ranks, [rank 0's, rank 1's]; the same
        ranks then run "collectives" (workers.collectives), "broadcast"
        (workers.broadcast) and "pipeline" (workers.pipeline,
        pipeline_args), "pipeline_exp" its experiment directory;
      * "four": the reg case on 4 ranks (1 sample each), rank 0's;
      * "one": both cases' one-process steps on the global batch, then the
        reg case on each of 2 shards alone, then the reg case banded over
        the slots ["cpu", "cpu:0"];
      * "means": the 2 ranks' mask means."""
    d = tmp_path_factory.mktemp("torch_parallel")
    batch, noise, cot, _ = draws(3)
    opts = {"reg": tiny_opt(net_d_reg_every=1, net_g_reg_every=1), "fused": tiny_opt()}
    state = jax_state(jax_model(opts["fused"], noise, cot), seed=20)
    means = mask_means(opts["fused"], state, batch, noise)
    lo, hi = sorted(means)
    opts["reg"]["train"]["mask_opt"]["loss_func"]["area"] = {"32": lo + 0.25 * (hi - lo)}
    path = str(d / "state.pt")
    torch.save(port_model(opts["fused"], state).state_dict(), path)
    rngs, cases = {}, {}
    for name, step in (("reg", 0), ("fused", 1)):
        rngs[name] = jax.random.PRNGKey(step + 7)
        z = np.asarray(jax.random.normal(jax.random.fold_in(rngs[name], 3), (B, 512)))
        cases[name] = {"opt": opts[name], "state": path, "step": step, "batch": batch,
                       "noise": noise, "cot": cot, "z": z}
    both = [cases["reg"], cases["fused"]]
    hybrid = dict(cases["reg"], sp=(["cpu", "cpu"], SP_MIN_H))
    banded = dict(cases["reg"], sp=(["cpu", "cpu:0"], SP_MIN_H))
    exp = str(d / "exp")
    started = {"two": Ranks(workers.two_ranks, 2, (both + [hybrid], pipeline_args(d, exp)),
                            workdir=d / "two"),
               "four": Ranks(workers.take_steps, 4, ([cases["reg"]],), workdir=d / "four"),
               "one": Ranks(workers.take_steps, 1,
                            (both + [rows(cases["reg"], r, 2) for r in range(2)] + [banded],),
                            workdir=d / "one")}
    mesh = make_mesh(jax.devices()[:2])
    out = {"cases": cases, "means": means, "jax": {}}
    for name in ("reg", "fused"):
        # the jitted phases donate the state they are given: a copy each
        jstate = jax.device_put(jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), state),
                                replicate_sharding(mesh))
        jm = jax_model(opts[name], noise, cot)
        new, logs = jm.train_step(jstate, shard_batch(batch, mesh), rngs[name],
                                  cases[name]["step"])
        out["jax"][name] = (new, {k: float(v) for k, v in logs.items()})
    mesh2d = make_mesh(jax.devices()[:4], axes=("data", "sp"), shape=(2, 2))
    jstate = jax.device_put(jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), state),
                            replicate_sharding(mesh2d))
    jm = jax_model(opts["reg"], noise, cot)
    with spatial_sharding(mesh2d, min_h=SP_MIN_H):
        new, logs = jm.train_step(jstate, shard_batch(batch, mesh2d), rngs["reg"], 0)
    out["jax"]["hybrid"] = (new, {k: float(v) for k, v in logs.items()})
    got = {k: r.join(LIMIT_S) for k, r in started.items()}
    out.update(two=[r["steps"] for r in got["two"]], four=got["four"][0], one=got["one"][0],
               collectives=[r["collectives"] for r in got["two"]],
               broadcast=[r["broadcast"] for r in got["two"]],
               pipeline=[r["pipeline"] for r in got["two"]], pipeline_exp=exp)
    yield out
    shutil.rmtree(d, ignore_errors=True)        # the pipeline's checkpoints


def area_scale(case):
    """The size of the terms whose difference l_area is: loss_weight x the
    area target (the mask's mean is about the target)."""
    mask = case["opt"]["train"]["mask_opt"]
    return mask["loss_weight"] * max(mask["loss_func"]["area"].values())


def check_logs(got, ref, rtol, atol=0.0, area=0.0):
    """Each log within rtol of its reference (plus atol); l_area within
    rtol of max(|ref|, area), the size of the terms its hinge subtracts."""
    assert set(got) == set(ref)
    for k, v in got.items():
        scale = max(abs(ref[k]), area) if k == "l_area" else abs(ref[k])
        assert abs(v - ref[k]) <= rtol * scale + atol, (k, v, ref[k])


def check_grads(got, ref, rtol):
    """{name: grad} against {name: ref grad}: each leaf within rtol of its
    max|ref|, or within FLOOR of the net's largest gradient where that is
    more (leaves whose exact gradient is 0 hold float32 noise)."""
    top = max(float(v.abs().max()) for v in ref.values())
    assert set(got) == set(ref)
    for k, r in ref.items():
        bound = max(rtol * float(r.abs().max()), FLOOR * top)
        assert float((got[k] - r).abs().max()) <= bound, (k, float((got[k] - r).abs().max()))


def check_updates(after, ref_after, before, grads, tol):
    """Each parameter's move against the reference's where its gradient
    decides the sign: within tol x lr (plus two float32 steps); every move
    at most lr."""
    top = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        old = before[k]
        d_got, d_ref = after[k] - old, ref_after[k] - old
        assert float(d_got.abs().max()) <= LR * (1 + 1e-3) + 4 * float(
            np.spacing(np.float32(old.abs().max()))), k
        sure = (g.abs() > 2e-3 * max(float(g.abs().max()), NOISE_FLOOR * top)) & (g.abs() > 1e-6)
        bound = tol * LR + 2 * torch.from_numpy(np.spacing(old.abs().numpy()))
        assert bool(((d_got - d_ref).abs() <= bound)[sure].all()), k


def jax_grads(jstate, which):
    return {port_key(jk): port_value(jk, v)
            for jk, v in flatten_tree(getattr(jstate, f"opt_{which}")["grads"]).items()}


def jax_after(jnew, which):
    tree = jnew.params_g_train if which == "g" else getattr(jnew, f"params_{which}")
    return {port_key(jk): port_value(jk, v) for jk, v in flatten_tree(tree).items()}


def before_of(case):
    model = OODFaceGANModel(copy.deepcopy(case["opt"]), device="cpu")
    model.load_state_dict(torch.load(case["state"], weights_only=True))
    return {w: {k: p.detach() for k, p in net.named_parameters()}
            for w, net in (("g", model.net_g), ("d", model.net_d))}


@pytest.mark.parametrize("name", ["reg", "fused"])
def test_two_rank_step_matches_jax_mesh_step(runs, name):
    """The 2-rank step against JAX's 2-device mesh step: the logs, the
    averaged gradients, the updates; the path mean; both replicas bit for
    bit."""
    i = ("reg", "fused").index(name)
    case = runs["cases"][name]
    jnew, jlogs = runs["jax"][name]
    r0, r1 = runs["two"][0][i], runs["two"][1][i]
    if name == "reg":
        assert {"l_d_r1", "l_g_path", "path_length", "l_area"} <= set(r0["logs"])
        assert abs(r0["mpl"] - float(jnew.mean_path_length)) <= LOSS_RTOL * abs(
            float(jnew.mean_path_length))
    else:
        assert "l_d_r1" not in r0["logs"] and "l_g_path" not in r0["logs"]
    check_logs(r0["logs"], jlogs, LOSS_RTOL, area=area_scale(case))
    before = before_of(case)
    for net, which in (("net_g", "g"), ("net_d", "d")):
        check_grads(r0["grads"][net], jax_grads(jnew, which), GRAD_RTOL)
        check_updates(r0["after"][net], jax_after(jnew, which), before[which],
                      r0["grads"][net], 1e-3)
    assert r0["logs"] == r1["logs"]
    assert r0["checksums"] == r1["checksums"] and len(set(r0["checksums"])) == 1
    for net in r0["after"]:
        for k, v in r0["after"][net].items():
            assert torch.equal(v, r1["after"][net][k]), (net, k)
        for k, v in r0["grads"].get(net, {}).items():
            assert torch.equal(v, r1["grads"][net][k]), (net, k)


def test_per_rank_statistics_would_fail(runs):
    """The reg case is built so that the test above can see each
    batch-coupled piece: the stddev groups span the ranks (one group of 4
    over a global batch of 4, 2 per rank), the area hinge is active on one
    rank and not the other, and the ranks' path lengths differ. The same
    step computed per rank (each rank's shard as its own one-process batch,
    logs and gradients averaged) misses JAX's D gradients (stddev) by more
    than GRAD_RTOL and its l_area (hinge) and l_g_path (path mean) by more
    than LOSS_RTOL."""
    case = runs["cases"]["reg"]
    jnew, jlogs = runs["jax"]["reg"]
    assert min(B, 4) > B // 2                      # the stddev group spans both ranks
    area = case["opt"]["train"]["mask_opt"]["loss_func"]["area"]["32"]
    assert min(runs["means"]) < area < max(runs["means"])   # active on one rank only
    per_rank = runs["one"][2:4]
    for k in ("l_area", "l_g_path"):
        mean = (per_rank[0]["logs"][k] + per_rank[1]["logs"][k]) / 2
        scale = max(abs(jlogs[k]), area_scale(case)) if k == "l_area" else abs(jlogs[k])
        assert abs(mean - jlogs[k]) > LOSS_RTOL * scale, (k, mean, jlogs[k])
    d_grads = {k: (per_rank[0]["grads"]["net_d"][k] + per_rank[1]["grads"]["net_d"][k]) / 2
               for k in per_rank[0]["grads"]["net_d"]}
    with pytest.raises(AssertionError):
        check_grads(d_grads, jax_grads(jnew, "d"), GRAD_RTOL)


@pytest.mark.parametrize("n", [2, 4])
def test_n_rank_step_equals_one_process_step(runs, n):
    """n ranks against the one-process step on the global batch. At n = 4
    a rank holds 1 sample, and the path regularizer still runs: its gate
    reads the global batch."""
    got_runs = runs["two"][0] if n == 2 else [runs["four"][0]]
    if n == 4:
        assert "l_g_path" in got_runs[0]["logs"]
    for got, ref, name in zip(got_runs, runs["one"], ("reg", "fused")):
        case = runs["cases"][name]
        check_logs(got["logs"], ref["logs"], SELF_RTOL, SELF_ATOL, area_scale(case))
        assert abs(got["mpl"] - ref["mpl"]) <= SELF_RTOL * abs(ref["mpl"])
        before = before_of(case)
        for net, which in (("net_g", "g"), ("net_d", "d")):
            check_grads(got["grads"][net], ref["grads"][net], 1e-4)
            check_updates(got["after"][net], ref["after"][net], before[which],
                          ref["grads"][net], 1e-4)
        assert len(set(got["checksums"])) == 1


def test_collectives_on_two_ranks(runs):
    """all_reduce_sum and its first and second derivatives, gather_batch and
    the gradient through it, global_mean, the gradient average, the logs'
    reduction and the checksums, on 2 ranks; and the identity without a
    group."""
    r0, r1 = runs["collectives"]
    x = [torch.arange(3, dtype=torch.float64) + r + 1 for r in range(2)]
    for r, got in enumerate((r0, r1)):
        assert torch.equal(got["sum"], x[0] ** 2 + x[1] ** 2)
        # d/dx_r of sum_q (q + 1) * sum(all_reduce(x * x)) = 2 x_r * (1 + 2)
        assert torch.equal(got["grad"], 6 * x[r])
        assert torch.equal(got["gradgrad"], torch.full((3,), 6.0, dtype=torch.float64))
        assert torch.equal(got["gathered"], torch.stack(x))
        # each rank's loss sum_i (i + 1)^2 gathered_i^2; the gradient of both
        # ranks' losses at x_r: 2 * 2 * (r + 1)^2 x_r
        assert torch.equal(got["gather_grad"], 4 * (r + 1) ** 2 * x[r])
        assert float(got["mean"]) == 2.5
        assert torch.equal(got["avg"][0], x[0] + x[1])
        assert torch.equal(got["avg"][1], torch.full((2,), 0.5))
        assert {k: float(v) for k, v in got["logs"].items()} == {"a": 2.0, "b": 0.5}
        assert got["same"][0] == got["same"][1]
        assert got["differ"][0] != got["differ"][1]
    # without a process group every collective is the identity
    t = torch.randn(2, 3)
    assert dist.world_size() == 1 and dist.rank() == 0 and dist.is_main()
    assert dist.all_reduce_sum(t) is t and dist.gather_batch(t) is t
    assert dist.local_rows(t) is t and dist.average_gradients([t])[0] is t
    assert torch.equal(dist.global_mean(t), t.mean())


def test_broadcast_state_makes_the_replicas_agree(runs):
    """broadcast_state on 2 ranks, one part of the state at a time: rank 1
    moves a trainable G weight, a D weight, the EMA, an optimizer moment,
    an optimizer's update count, the path mean or the generator's state;
    the replicas' check then fails, and after the broadcast both ranks hold
    the loaded state bit for bit, counts included, and the check passes."""
    r0, r1 = runs["broadcast"]
    assert list(r0) == ["weights", "discriminator", "ema", "moments", "count", "path mean",
                        "rng"]
    for kind in r0:
        for r in (r0, r1):
            agreed, same, sums = r[kind]
            assert not agreed, kind
            assert same, kind
            assert len(set(sums)) == 1, kind
        assert r0[kind][2] == r1[kind][2]


def test_train_pipeline_on_two_ranks(runs):
    """train_pipeline on 2 ranks over micro_debug.yml (narrowed, 2
    iterations at 2 samples per rank, a save and a validation at the end):
    only rank 0 writes checkpoints and a log file; --auto_resume on both
    ranks resumes iteration 2, and the next step on one batch from the
    resumed state equals the uninterrupted run's bit for bit; the replicas
    agree; num_devices 1 against a world of 2 raises."""
    r0, r1 = runs["pipeline"]
    exp = runs["pipeline_exp"]
    assert r0["writes"] and not r1["writes"]
    assert all(w.startswith(exp) for w in r0["writes"])
    assert r0["log_files"] and not r1["log_files"]
    assert r0["resumed_from"] == r1["resumed_from"] == 2
    for r in (r0, r1):
        assert r["logs"][0] == r["logs"][1] and r["bitwise"]
        assert len(set(r["checksums"])) == 1
        assert "num_devices 1 but the world size is 2" in r["error"]
    assert r0["logs"] == r1["logs"]
    assert num_devices({}) == 1 and num_devices({"num_devices": 1}) == 1
    with pytest.raises(ValueError, match="num_devices 2 but the world size is 1"):
        num_devices({"num_devices": 2})


def test_hybrid_step_matches_jax_2d_mesh_step(runs):
    """The reg case on 2 ranks x 2 CPU slots (each rank banding its rows'
    decodes at min_h 16, step 0: R1 and the path regularizer's double
    backward through the bands) against JAX's step on the ("data", "sp")
    (2, 2) mesh inside spatial_sharding: the logs, the path mean, the
    averaged gradients and the updates, at the 2-rank case's tolerances
    (and, as the one-process comparisons hold them, the D scores, means of
    unit-scale terms that cancel, within SELF_ATOL absolute: the bands
    move the image by float32 rounding); the replicas bit for bit."""
    case = runs["cases"]["reg"]
    jnew, jlogs = runs["jax"]["hybrid"]
    r0, r1 = runs["two"][0][2], runs["two"][1][2]
    assert {"l_d_r1", "l_g_path", "path_length", "l_area"} <= set(r0["logs"])
    check_logs(r0["logs"], jlogs, LOSS_RTOL, SELF_ATOL, area=area_scale(case))
    assert abs(r0["mpl"] - float(jnew.mean_path_length)) <= LOSS_RTOL * abs(
        float(jnew.mean_path_length))
    before = before_of(case)
    for net, which in (("net_g", "g"), ("net_d", "d")):
        check_grads(r0["grads"][net], jax_grads(jnew, which), GRAD_RTOL)
        check_updates(r0["after"][net], jax_after(jnew, which), before[which],
                      r0["grads"][net], 1e-3)
    assert r0["logs"] == r1["logs"]
    assert r0["checksums"] == r1["checksums"] and len(set(r0["checksums"])) == 1


def test_banded_step_equals_unbanded_step(runs):
    """The reg case banded in one process over the slots ["cpu", "cpu:0"]
    (the second a distinct device, whose bands compute with the trained
    parameters moved into the graph) against the unbanded one-process step:
    only the bands' sums differ."""
    case = runs["cases"]["reg"]
    got, ref = runs["one"][4], runs["one"][0]
    check_logs(got["logs"], ref["logs"], SELF_RTOL, SELF_ATOL, area_scale(case))
    assert abs(got["mpl"] - ref["mpl"]) <= SELF_RTOL * abs(ref["mpl"])
    before = before_of(case)
    for net, which in (("net_g", "g"), ("net_d", "d")):
        check_grads(got["grads"][net], ref["grads"][net], 1e-4)
        check_updates(got["after"][net], ref["after"][net], before[which],
                      ref["grads"][net], 1e-4)
