"""The port's training entry point (train.py, run_train.py, models/
validation.py, utils/checkpoint.py, the model's state_dict) and its CLIs
on the CPU, against the JAX package where both run: validation on stub
models, `load_pretrained` on a JAX parameter tree, and the batches the
loop hands `train_step` against JAX's loader.

The pipeline runs options/train/micro_debug.yml (64px) narrowed as
tests/test_torch_train.py narrows its model (narrow 0.25, a 4-layer
encoder trunk, n_mlp 2) on synthetic PNGs, with LPIPS added to its PSNR
and SSIM. Tolerances: validation results equal JAX's (PSNR, SSIM: the
same numpy and OpenCV arithmetic), LPIPS within 1e-5 relative (bridged
parameters); loaded weights, batches, restored states and the step taken
from them are bit for bit."""

import copy
import os
import os.path as osp
import shutil
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from torch_parity import fill_params, jax_tree

from ood_gan_inversion_tpu.data import build_dataloader as j_build_dataloader
from ood_gan_inversion_tpu.data import build_dataset as j_build_dataset
from ood_gan_inversion_tpu.metrics import lpips as j_lpips_metric
from ood_gan_inversion_tpu.models import build_model as j_build_model
from ood_gan_inversion_tpu.models import validation as j_validation
from ood_gan_inversion_tpu.models.ood_model import merge_params
from ood_gan_inversion_tpu.nn.lpips import LPIPS as JLPIPS
from ood_gan_inversion_tpu.train import load_pretrained as j_load_pretrained
from ood_gan_inversion_tpu.utils.options import parse_options as j_parse_options
from ood_gan_inversion_tpu_torch.convert import flatten_tree, from_jax_params, load_jax_train_state
from ood_gan_inversion_tpu_torch.data import build_dataloader, build_dataset
from ood_gan_inversion_tpu_torch.metrics import LPIPSModel
from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
from ood_gan_inversion_tpu_torch.models import validation as p_validation
from ood_gan_inversion_tpu_torch.models.optim import make_optimizer
from ood_gan_inversion_tpu_torch.run_inversion import run_inversion
from ood_gan_inversion_tpu_torch.train import load_pretrained, train_pipeline
from ood_gan_inversion_tpu_torch.utils import checkpoint as ckpt
from ood_gan_inversion_tpu_torch.utils.options import load_yaml, parse_options

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
LPIPS_RTOL = 1e-5
MICRO = ["network_g:narrow=0.25", "network_g:encoder_num_layers=4", "network_g:n_mlp=2",
         "network_d:narrow=0.25"]
LPIPS_METRIC = ["val:metrics:lpips:type=calculate_lpips", "val:metrics:lpips:crop_border=2",
                "val:metrics:lpips:better=lower"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """6 train and 2 val seeded 64px PNGs."""
    d = tmp_path_factory.mktemp("torch_pipeline")
    rs = np.random.RandomState(0)
    for sub, n in (("train", 6), ("val", 2)):
        os.makedirs(d / sub)
        for i in range(n):
            cv2.imwrite(str(d / sub / f"{i}.png"), (rs.rand(64, 64, 3) * 255).astype(np.uint8))
    return d


def pipeline_args(data, exp, total, *extra):
    """The command line of the JAX package's pipeline test (micro_debug.yml:
    its debug name sets val_freq 8, save_checkpoint_freq 8, print_freq 1),
    narrowed, on the CPU, with LPIPS, a seeded hflip draw and one loader
    thread."""
    return ["--opt", "options/train/micro_debug.yml", "--device", "cpu", "--force_yml",
            f"datasets:train:dataroot_gt={data}/train", f"datasets:val:dataroot_gt={data}/val",
            f"path:experiments_root={exp}", f"train:total_iter={total}", "val:val_freq=4",
            "logger:save_checkpoint_freq=4", "datasets:train:random_seed=5",
            "datasets:train:num_worker_per_gpu=1", *MICRO, *LPIPS_METRIC, *extra]


def state_equal(a, b, path="state"):
    """Asserts two state_dict trees equal, tensor by tensor, bit for bit."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            state_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            state_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.fixture
def scratch(tmp_path):
    """tmp_path, removed after the test: a training state of the micro
    model takes ~0.57 GB, its generator's weights ~0.5 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def first_run(data, tmp_path_factory):
    """4 iterations with validation at 2 and 4 and the save at 4 (a name
    without the debug prefix, which would set val_freq 8)."""
    exp = tmp_path_factory.mktemp("first_run") / "exp"
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        args = pipeline_args(data, exp, 4, "name=micro_run", "val:val_freq=2")
        run = train_pipeline(str(exp.parent), args=args)
    finally:
        os.chdir(cwd)
    yield args, exp, run
    shutil.rmtree(exp.parent, ignore_errors=True)


def test_train_pipeline_trains_validates_saves_and_resumes(first_run, scratch, monkeypatch):
    monkeypatch.chdir(ROOT)
    args, exp, run = first_run
    assert (run.start_iter, run.current_iter) == (0, 4)
    assert osp.isfile(exp / "training_states" / "state_4.pth")
    assert osp.isfile(exp / "models" / "net_4.pth")
    assert not osp.exists(exp / "models" / "delta_lat_4.pth")     # delta_latent is frozen
    weights = torch.load(exp / "models" / "net_4.pth", weights_only=True)
    assert set(weights) == {"params", "params_ema", "params_d", "params_d2"}
    assert set(weights["params"]) == set(run.model.train_g)
    assert set(run.val_results) == {"psnr", "ssim", "lpips"}
    assert all(np.isfinite(v) for v in run.val_results.values())
    assert len(run.val_seconds) == 3                      # at 2, at 4, and after the loop
    for name in ("0", "1"):
        assert sorted(os.listdir(exp / "visualization" / name)) == [
            f"{name}_{it}{suffix}.jpg" for it in (2, 4) for suffix in ("", "_masks")]
    assert osp.isfile(exp / "micro_debug.yml")
    # resume from 4 to 6, in a copy of the experiment (its checkpoints
    # linked: a save replaces a file and never writes into one)
    resumed = scratch / "exp"
    shutil.copytree(exp, resumed, copy_function=lambda src, dst: (
        os.link(src, dst) if src.endswith(".pth") else shutil.copy2(src, dst)))
    args2 = ["--auto_resume"] + [a.replace("total_iter=4", "total_iter=6").replace(
        str(exp), str(resumed)) for a in args]
    run2 = train_pipeline(str(scratch), args=args2)
    assert (run2.start_iter, run2.current_iter) == (4, 6)
    assert osp.isfile(resumed / "training_states" / "state_6.pth")
    assert sum(o.count for _, o in run2.model.opt_g.values()) == 6 * len(run2.model.opt_g)
    assert run2.model.opt_d.count == 6


def test_auto_resume_restores_the_state_and_the_next_step_bit_for_bit(first_run, monkeypatch):
    monkeypatch.chdir(ROOT)
    args, exp, run = first_run
    saved = torch.load(exp / "training_states" / "state_4.pth", weights_only=True)
    state_equal(saved, run.model.state_dict())
    opt, _ = parse_options(str(exp.parent), True, args)
    restored = OODFaceGANModel(opt, device="cpu", seed=123)
    assert ckpt.resume_training_state(restored, str(exp / "training_states")) == 4
    state_equal(restored.state_dict(), saved)
    assert restored.opt_d.count == 4 and restored.rng.get_state().equal(saved["rng"])
    # the next step, on one batch, from the restored and the uninterrupted state
    rs = np.random.RandomState(7)
    batch = {"gt": rs.uniform(-1, 1, (2, 1, 64, 64, 3)).astype(np.float32),
             "lq_size": np.full((2, 1), 64.0, np.float32)}
    logs_a = run.model.train_step(batch, 5)
    logs_b = restored.train_step(batch, 5)
    state_equal(logs_a, logs_b)
    state_equal(run.model.state_dict(), restored.state_dict())


def test_loop_hands_train_step_the_batches_of_jax_loader(data, scratch, monkeypatch):
    monkeypatch.chdir(ROOT)
    seen = []

    def record(self, batch, step, **kw):
        seen.append((step, {k: v.clone() for k, v in batch.items()}))
        return {}

    monkeypatch.setattr(OODFaceGANModel, "train_step", record)
    args = pipeline_args(data, scratch / "exp", 14, "logger:profile_iters=3")
    train_pipeline(str(scratch), args=args)
    assert osp.getsize(scratch / "exp" / "profile" / "trace.json") > 0
    jopt, _ = j_parse_options(str(scratch), True, [a for a in args if a not in ("--device",
                                                                                 "cpu")])
    ds_opt = jopt["datasets"]["train"]
    ref = []
    for resumed in (False, True):
        loader = j_build_dataloader(j_build_dataset(ds_opt), ds_opt, seed=jopt["manual_seed"])
        assert len(loader) == 12
        epoch, batches = 0, []
        while len(batches) < (2 if resumed else 14):
            loader.sampler.set_epoch(epoch)
            batches += list(loader)
            epoch += 1
        ref += batches[:2 if resumed else 14]
        if not resumed:
            # resumed at 14: the sampler starts again at epoch 0 with a fresh dataset
            args = ["--auto_resume"] + [a.replace("total_iter=14", "total_iter=16")
                                        for a in args]
            train_pipeline(str(scratch), args=args)
    assert [s for s, _ in seen] == list(range(1, 17))
    for (step, got), want in zip(seen, ref):
        assert set(got) == {"gt", "lq_size"}
        np.testing.assert_array_equal(got["gt"].numpy(), want["gt"], err_msg=str(step))
        np.testing.assert_array_equal(got["lq_size"].numpy(), want["lq_size"])


def test_validation_leaves_the_training_run_unchanged(data, first_run, scratch, monkeypatch):
    """The first run validated at 2; a run without validation in the loop
    reaches its saved state at 4."""
    monkeypatch.chdir(ROOT)
    args = pipeline_args(data, scratch / "exp", 4, "name=micro_val",
                         "val:val_freq=~", "logger:print_freq=1")
    run = train_pipeline(str(scratch), args=args)
    assert len(run.val_seconds) == 1                      # only after the loop
    saved = torch.load(first_run[1] / "training_states" / "state_4.pth", weights_only=True)
    state_equal(run.model.state_dict(), saved)


def test_run_train_refuses_to_fall_back_to_the_cpu(data, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(ROOT)
    from ood_gan_inversion_tpu_torch import run_train
    args = [a for a in pipeline_args(data, tmp_path / "exp", 1) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_train.main(args)


@pytest.mark.parametrize("kind", ["Adam", "SGD", "SGD momentum", "Ranger"])
def test_optimizer_state_round_trip(kind):
    """An optimizer restored from another's state_dict after 4 steps takes
    the same next 8 steps, bit for bit (Ranger's lookahead syncs at 6 and
    12 read the restored slow weights); a state for other parameters is
    refused."""
    rs = np.random.RandomState(0)
    params = [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((3, 4), (5,))]
    grads = [[torch.from_numpy(rs.randn(*p.shape).astype(np.float32)) for p in params]
             for _ in range(12)]
    kw = {"momentum": 0.9} if kind == "SGD momentum" else {}
    a = make_optimizer(kind.split()[0], [p.clone() for p in params], 1e-2, **kw)
    for g in grads[:4]:
        a.step(g)
    b = make_optimizer(kind.split()[0], [p.clone() for p in a.params], 1e-2, **kw)
    b.load_state_dict(ckpt.to_cpu(a.state_dict()))
    for g in grads[4:]:
        a.step(g)
        b.step(g)
    assert a.count == b.count == 12
    state_equal(a.params, b.params)
    other = make_optimizer(kind.split()[0], [torch.zeros(2)], 1e-2, **kw)
    if kind != "SGD":
        with pytest.raises(ValueError):
            other.load_state_dict(a.state_dict())


# --- validation against JAX on stub models ------------------------------------------------
@pytest.fixture(scope="module")
def lpips_pair():
    """One seeded LPIPS parameter set in both metric singletons (reset
    afterwards)."""
    x = jax.numpy.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda r: JLPIPS().init(r, x, x), jax.random.PRNGKey(0))["params"]
    flat = fill_params(shapes, seed=5)
    for i in range(5):
        flat[f"lin{i}"] = np.abs(flat[f"lin{i}"]) + 0.01
    j_lpips_metric.LPIPSModel.instance(params={"params": jax_tree(flat)})
    LPIPSModel.instance(params=from_jax_params(flat, "lpips")[0], device="cpu")
    yield
    j_lpips_metric.LPIPSModel._instance = None
    LPIPSModel._instance = None


def stub_outputs(x):
    """A fixed function of the input: the 'inversion' and two alpha maps."""
    rs = np.random.RandomState(int(abs(x).sum() * 1000) % 2 ** 31)
    image = np.tanh(0.9 * x + 0.05 * rs.randn(*x.shape)).astype(np.float32)
    aligns = {k: rs.uniform(-0.2, 1.2, (x.shape[0], s, s, 3)).astype(np.float32)
              for k, s in ((1, 32), (2, 48))}
    return image, aligns


class JaxStub:
    def infer(self, state, x, rng, step=None, ema=False):
        image, aligns = stub_outputs(np.asarray(x))
        return {"image": image, "aligns": aligns}


class PortStub:
    device = torch.device("cpu")

    def make_noise(self, batch, generator):
        return None

    def infer(self, x, step=None, ema=False, noise=None):
        image, aligns = stub_outputs(x.numpy())
        return {"image": torch.from_numpy(image),
                "aligns": {k: torch.from_numpy(v) for k, v in aligns.items()}}


@pytest.mark.parametrize("k", [1, 2])
def test_run_validation_matches_jax(data, tmp_path, lpips_pair, k):
    ds = {"type": "Face_Dataset", "dataroot_gt": str(data / "train"), "mode": "mix_id",
          "max_length": k, "random_seed": 2, "phase": "val"}
    metrics = {"lpips": {"type": "calculate_lpips", "crop_border": 2, "better": "lower"},
               "psnr": {"type": "calculate_psnr", "crop_border": 2, "test_y_channel": True,
                        "better": "higher"},
               "ssim": {"type": "calculate_ssim", "crop_border": 2, "test_y_channel": True}}
    results, trackers = [], []
    for side, stub, mod, build_ds, build_dl in (
            ("port", PortStub(), p_validation, build_dataset, build_dataloader),
            ("jax", JaxStub(), j_validation, j_build_dataset, j_build_dataloader)):
        opt = {"manual_seed": 0, "path": {"visualization": str(tmp_path / side)},
               "val": {"save_img": True, "save_lq_and_gt": True, "metrics": metrics}}
        loader = build_dl(build_ds(ds), ds, is_train=False)
        tracker = mod.BestMetricTracker(metrics)
        args = (loader, opt, 40) if side == "port" else (None, loader, opt, 40)
        for _ in range(2):
            results.append(mod.run_validation(stub, *args, tracker=tracker))
        trackers.append(tracker.records)
    assert set(results[0]) == set(results[2]) == set(metrics)
    for got, ref in ((results[0], results[2]), (results[1], results[3])):
        assert got["psnr"] == ref["psnr"] and got["ssim"] == ref["ssim"]
        assert abs(got["lpips"] - ref["lpips"]) <= LPIPS_RTOL * abs(ref["lpips"])
    assert trackers[0].keys() == trackers[1].keys()
    for name in trackers[0]:
        assert trackers[0][name]["iter"] == trackers[1][name]["iter"] == 40
    files = [sorted(osp.relpath(osp.join(r, f), tmp_path / side)
                    for r, _, fs in os.walk(tmp_path / side) for f in fs)
             for side in ("port", "jax")]
    assert files[0] == files[1] and len(files[0]) == (18 if k == 1 else 15)
    for f in files[0]:
        assert open(tmp_path / "port" / f, "rb").read() == open(tmp_path / "jax" / f, "rb").read()


def test_best_metric_tracker_and_mask_strip_match_jax():
    metrics = {"psnr": {"better": "higher"}, "lpips": {"better": "lower"}, "x": {}}
    mine, theirs = p_validation.BestMetricTracker(metrics), j_validation.BestMetricTracker(metrics)
    rs = np.random.RandomState(0)
    for it in range(12):
        for name in metrics:
            v = float(rs.choice([0.5, 1.0, 1.5]))
            assert mine.update(name, v, it) == theirs.update(name, v, it)
    assert mine.records == theirs.records
    aligns = {k: rs.uniform(-0.3, 1.3, (2, s, s, 3)).astype(np.float32)
              for k, s in ((3, 32), (1, 48), (2, 100), (4, 256))}
    np.testing.assert_array_equal(p_validation.mask_strip(aligns), j_validation.mask_strip(aligns))
    assert p_validation.mask_strip({}) is None


# --- load_pretrained ------------------------------------------------------------------------
def micro_opt():
    """micro_debug.yml's model, narrowed as the pipeline's."""
    opt = load_yaml(open(osp.join(ROOT, "options/train/micro_debug.yml")))
    opt["network_g"].update(narrow=0.25, encoder_num_layers=4, n_mlp=2)
    opt["network_d"].update(narrow=0.25)
    return opt


@pytest.fixture(scope="module")
def jax_case():
    """JAX's model and a TrainState of seeded numpy fills (no flax init),
    and a second fill of every net to load from files."""
    opt = micro_opt()
    jm = j_build_model(copy.deepcopy(opt))
    shapes = jax.eval_shape(lambda r: jm._init_net_params(r, (2, 64, 64, 3)),
                            jax.random.PRNGKey(0))
    nets = {n: fill_params(shapes[n], i) for i, n in enumerate(("g", "d", "d2"))}
    state = jm._state_from_net_params({**{n: jax_tree(v) for n, v in nets.items()},
                                       "loss": {}})
    files = {n: fill_params(shapes[n], 10 + i) for i, n in enumerate(("g", "d", "d2"))}
    return opt, jm, state, files


def port_from(opt, state):
    model = OODFaceGANModel(copy.deepcopy(opt), device="cpu", seed=7)
    load_jax_train_state(model, state)
    return model


def assert_net_equals_jax(module, jax_params, net):
    want, leftovers = from_jax_params(flatten_tree(jax_params), net)
    assert leftovers == []
    state_equal(dict(module.state_dict()), want)


@pytest.mark.parametrize("strict", [True, False])
def test_load_pretrained_matches_jax(jax_case, scratch, strict):
    opt, jm, state, files = jax_case
    flat = dict(files["g"])
    if not strict:
        for k in sorted(flat)[3:6]:
            del flat[k]
        flat["bogus/leaf"] = np.zeros(3, np.float32)
    path = str(scratch / "g.npz")
    np.savez(path, **flat)
    jstate = j_load_pretrained(jm, state, path, "g", strict=strict)
    model = port_from(opt, state)
    load_pretrained(model, path, "g", strict=strict)
    assert_net_equals_jax(model.net_g, merge_params(jstate.params_g_train,
                                                    jstate.params_g_frozen), "g")
    # the EMA restarts from the loaded trainable parameters, in both
    for k, p in model.train_g.items():
        assert torch.equal(model.ema[k], p)
    ema, train = flatten_tree(jstate.ema_train), flatten_tree(jstate.params_g_train)
    assert set(ema) == set(train) and all(np.array_equal(ema[k], train[k]) for k in ema)
    for which, field in (("d", "params_d"), ("d2", "params_d2")):
        p = str(scratch / f"{which}.npz")
        np.savez(p, **files[which])
        jstate = j_load_pretrained(jm, jstate, p, which, strict=strict)
        load_pretrained(model, p, which, strict=strict)
        assert_net_equals_jax(getattr(model, f"net_{which}"), getattr(jstate, field), which)


def test_load_pretrained_strict_errors_match_jax(jax_case, tmp_path):
    opt, jm, state, files = jax_case
    model = port_from(opt, state)
    missing = dict(files["d"])
    del missing[sorted(missing)[0]]
    np.savez(tmp_path / "missing.npz", **missing)
    shaped = dict(files["d"])
    k = sorted(shaped)[0]
    shaped[k] = np.zeros((1,) + shaped[k].shape, np.float32)
    np.savez(tmp_path / "shaped.npz", **shaped)
    for name, err in (("missing", KeyError), ("shaped", ValueError)):
        path = str(tmp_path / f"{name}.npz")
        with pytest.raises(err):
            j_load_pretrained(jm, state, path, "d", strict=True)
        with pytest.raises(err):
            load_pretrained(model, path, "d", strict=True)
    # non-strict: the mismatched leaf keeps its value, as in JAX
    jstate = j_load_pretrained(jm, state, str(tmp_path / "shaped.npz"), "d", strict=False)
    load_pretrained(model, str(tmp_path / "shaped.npz"), "d", strict=False)
    assert_net_equals_jax(model.net_d, jstate.params_d, "d")
    with pytest.raises(ValueError, match="npz"):
        load_pretrained(model, str(tmp_path / "orbax_dir"), "g")


# --- the CLIs ---------------------------------------------------------------------------------
def test_run_inversion_on_two_pngs(data, tmp_path):
    opt = load_yaml(open(osp.join(ROOT, "options/test/E4E_Face_test.yml")))
    opt["network_g"].update(out_size=64, channel_multiplier=1, narrow=0.125,
                            encoder_num_layers=4, ModSize=64)
    opt["datasets"] = {"test": {"dataroot_gt": str(data / "val")}}
    report = run_inversion(opt, str(tmp_path / "out"), device="cpu")
    assert report["images"] == 2 and report["sec_per_img"] > 0
    for i in range(2):
        inv = cv2.imread(str(tmp_path / "out" / "inversion" / f"{i}.png"), cv2.IMREAD_UNCHANGED)
        assert inv.shape == (64, 64, 3) and inv.dtype == np.uint8
        masks = sorted(os.listdir(tmp_path / "out" / "masks"))
        assert f"{i}_1.png" in masks and f"{i}_2.png" in masks


def test_entry_points_import_no_jax():
    """Importing the port's training entry point, its data, metric and
    checkpoint modules and its other CLIs loads no JAX module."""
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import ood_gan_inversion_tpu_torch.run_train, ood_gan_inversion_tpu_torch.train\n"
            "import ood_gan_inversion_tpu_torch.run_inversion, ood_gan_inversion_tpu_torch.run_serve\n"
            "import ood_gan_inversion_tpu_torch.data, ood_gan_inversion_tpu_torch.metrics\n"
            "import ood_gan_inversion_tpu_torch.models.validation\n"
            "import ood_gan_inversion_tpu_torch.utils.checkpoint\n"
            "new = set(sys.modules) - before\n"
            "print(sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'ood_gan_inversion_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.strip() == "[]", out.stdout
