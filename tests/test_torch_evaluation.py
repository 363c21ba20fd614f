"""The port's evaluation entry points against the JAX package on the CPU:
`test.test_pipeline` (what `python -m ood_gan_inversion_tpu_torch.run_test`
runs) on a micro copy of each shipped options/test/*.yml, and the metrics
report of `run_inversion`.

Micro copies: the shipped file with its dataroot, results root, weights
and identity model path overridden, and the model cut to 64px,
channel_multiplier 1, narrow 0.125 (a 4-layer E4E trunk; ReStyle's and
FeatureStyle's JAX archs build their 50-layer encoders whatever the
size), ReStyle at enc_cycle 2 (the file's 5 only repeats the same
refinement). Both sides read the same PNGs, the same `.npz` of a seeded
JAX generator tree (`pretrain_network_g`, noise strengths 0, so the two
frameworks' noise draws do not enter) and the same seeded LPIPS and
ArcFace weights in their metric singletons. JAX's model state is built
from the same seeded tree instead of a flax init, and the `.npz` replaces
every generator leaf on both sides.

Tolerances: every metric within 1e-4 relative of JAX's (the inversions
agree to ~1e-5 of their range, and a few uint8 pixels may round the
other way), LPIPS within 1e-5 absolute; the same test sets, metric
names, images and dump files, the dumps within 2 levels of JAX's."""

import copy
import os
import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import fill_params, jax_tree

from ood_gan_inversion_tpu import infer as j_infer
from ood_gan_inversion_tpu import test as j_test
from ood_gan_inversion_tpu.metrics import identity as j_identity
from ood_gan_inversion_tpu.metrics import lpips as j_lpips_metric
from ood_gan_inversion_tpu.models import build_model as j_build_model
from ood_gan_inversion_tpu.models.ood_model import OODFaceGANModel as JModel
from ood_gan_inversion_tpu.nn.irse import ArcFaceBackbone as JArcFace
from ood_gan_inversion_tpu.nn.lpips import LPIPS as JLPIPS
from ood_gan_inversion_tpu.utils.options import parse_options as j_parse_options
from ood_gan_inversion_tpu_torch import test as p_test
from ood_gan_inversion_tpu_torch.convert import from_jax_params
from ood_gan_inversion_tpu_torch.metrics import IdentityModel, LPIPSModel
from ood_gan_inversion_tpu_torch.run_inversion import run_inversion
from ood_gan_inversion_tpu_torch.utils.options import load_yaml

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
METRIC_RTOL = 1e-4
LPIPS_ATOL = 1e-5
DUMP_LEVELS = 2
MISSING_ID = "checkpoints/absent/model_ir_se50.pth"
MICRO = {"E4E": ["network_g:encoder_num_layers=4"],
         "ReStyle": ["network_g:enc_cycle=2"],
         "FeatureStyle": []}


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Two seeded 64px PNGs: smooth colour fields with a little noise."""
    d = tmp_path_factory.mktemp("eval_pngs")
    rs = np.random.RandomState(0)
    for i in range(2):
        field = cv2.resize(rs.rand(8, 8, 3).astype(np.float32), (64, 64))
        img = np.clip(field * 255 + rs.randn(64, 64, 3) * 6, 0, 255).astype(np.uint8)
        cv2.imwrite(str(d / f"{i}.png"), img)
    return d


@pytest.fixture(scope="module")
def metric_nets():
    """One seeded LPIPS and one seeded ArcFace parameter set in both
    frameworks' metric singletons (reset afterwards)."""
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda r: JLPIPS().init(r, x, x), jax.random.PRNGKey(0))["params"]
    lp = fill_params(shapes, seed=5)
    for i in range(5):
        lp[f"lin{i}"] = np.abs(lp[f"lin{i}"]) + 0.01
    shapes = jax.eval_shape(lambda r: JArcFace(50).init(r, jnp.zeros((1, 112, 112, 3))),
                            jax.random.PRNGKey(0))["params"]
    arc = fill_params(shapes, seed=6)
    j_lpips_metric.LPIPSModel.instance(params={"params": jax_tree(lp)})
    LPIPSModel.instance(params=from_jax_params(lp, "lpips")[0], device="cpu")
    j_identity._IDModel._instance = j_identity._IDModel({"params": jax_tree(arc)})
    IdentityModel.instance(params=from_jax_params(arc, "id")[0], device="cpu")
    yield arc
    j_lpips_metric.LPIPSModel._instance = None
    LPIPSModel._instance = None
    j_identity._IDModel._instance = j_identity._IDModel._instance_path = None
    IdentityModel._instance = IdentityModel._instance_path = None


def overrides(family, data, results, weights):
    return ["--force_yml", f"datasets:test_1:dataroot_gt={data}", "datasets:test_1:gt_size=64",
            "network_g:out_size=64", "network_g:channel_multiplier=1", "network_g:narrow=0.125",
            *MICRO[family], f"path:pretrain_network_g={weights}", f"path:results_root={results}",
            f"val:metrics:identity:model_path={MISSING_ID}"]


def generator_npz(args, path, seed):
    """A seeded JAX generator tree for the model `args` describe, noise
    strengths 0, written as the flattened .npz `load_pretrained` reads."""
    opt, _ = j_parse_options(ROOT, is_train=False, args=args)
    jm = j_build_model(opt)
    shapes = jax.eval_shape(lambda r: jm._init_net_params(r, (1, 64, 64, 3)),
                            jax.random.PRNGKey(0))["g"]
    flat = fill_params(shapes, seed)
    for k in flat:
        if k.endswith("/noise/weight"):
            flat[k] = np.zeros_like(flat[k])
    assert from_jax_params(flat)[1] == []
    np.savez(path, **flat)
    return flat


@pytest.fixture(scope="module")
def e4e_weights(pngs, tmp_path_factory):
    """One seeded E4E generator tree and its .npz, for the E4E pipeline case
    and the run_inversion report."""
    d = tmp_path_factory.mktemp("e4e_weights")
    path = str(d / "g.npz")
    args = ["--opt", osp.join(ROOT, "options/test/E4E_Face_test.yml"),
            *overrides("E4E", pngs, d, path)]
    return path, generator_npz(args, path, seed=10)


def seeded_init(monkeypatch, flat):
    """JAX's model state built from the seeded generator tree `flat`, not
    from a flax init (load_pretrained then merges the same values)."""
    monkeypatch.setattr(JModel, "init_state", lambda self, *a, **k: self._state_from_net_params(
        {"g": jax_tree(flat), "d": {}, "d2": {}, "loss": {}}))


def dumps(root):
    return sorted(osp.relpath(osp.join(r, f), root) for r, _, fs in os.walk(root) for f in fs
                  if f.endswith(".jpg"))


def assert_metrics_match(got, ref):
    assert set(got) == set(ref)
    for name, r in ref.items():
        tol = LPIPS_ATOL if name == "lpips" else METRIC_RTOL * abs(r)
        assert np.isfinite(got[name]) and abs(got[name] - r) <= tol, (name, got[name], r)


@pytest.mark.parametrize("family", ["E4E", "ReStyle", "FeatureStyle"])
def test_test_pipeline_matches_jax(family, pngs, metric_nets, tmp_path, monkeypatch, request):
    yml = f"options/test/{family}_Face_test.yml"
    weights, flat = (request.getfixturevalue("e4e_weights") if family == "E4E"
                     else (str(tmp_path / "g.npz"), None))
    sides = {}
    for side in ("jax", "port"):
        args = ["--opt", osp.join(ROOT, yml),
                *overrides(family, pngs, tmp_path / side, weights)]
        if side == "jax":
            seeded_init(monkeypatch, flat or generator_npz(args, weights, seed=10))
            sides[side] = j_test.test_pipeline(ROOT, args=args)
        else:
            sides[side] = p_test.test_pipeline(ROOT, args=args + ["--device", "cpu"])
    got, ref = sides["port"], sides["jax"]
    assert set(got) == set(ref) == {"CelebAHQ"}
    assert set(ref["CelebAHQ"]) == {"psnr", "ssim", "lpips", "identity"}
    assert_metrics_match(got["CelebAHQ"], ref["CelebAHQ"])
    files = dumps(tmp_path / "port")
    assert files == dumps(tmp_path / "jax") and len(files) == 4     # image and masks, x2
    for f in files:
        a = cv2.imread(str(tmp_path / "port" / f)).astype(int)
        b = cv2.imread(str(tmp_path / "jax" / f)).astype(int)
        assert np.abs(a - b).max() <= DUMP_LEVELS, f


def test_run_inversion_report_matches_jax(pngs, metric_nets, e4e_weights, tmp_path):
    weights, flat = e4e_weights
    args = ["--opt", osp.join(ROOT, "options/test/E4E_Face_test.yml"),
            *overrides("E4E", pngs, tmp_path, weights)]
    opt, _ = j_parse_options(ROOT, is_train=False, args=args)
    ref = j_infer.run_inversion(copy.deepcopy(opt), str(tmp_path / "jax"),
                                params=jax_tree(flat))
    got = run_inversion(copy.deepcopy(opt), str(tmp_path / "port"),
                        params=from_jax_params(flat)[0], device="cpu")
    assert got["images"] == ref["images"] == 2 and got["sec_per_img"] > 0
    assert_metrics_match({k: v for k, v in got.items() if k not in ("images", "sec_per_img")},
                         {k: v for k, v in ref.items() if k not in ("images", "sec_per_img")})
    for sub in ("inversion", "masks"):
        assert sorted(os.listdir(tmp_path / "port" / sub)) == \
            sorted(os.listdir(tmp_path / "jax" / sub))


def test_run_test_refuses_to_fall_back_to_the_cpu(pngs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from ood_gan_inversion_tpu_torch import run_test
    args = ["--opt", osp.join(ROOT, "options/test/E4E_Face_test.yml"),
            *overrides("E4E", pngs, tmp_path, "~")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_test.main(args)


def test_shipped_test_configs_name_the_ported_archs():
    from ood_gan_inversion_tpu_torch.archs import _ARCHS
    for family in MICRO:
        opt = load_yaml(open(osp.join(ROOT, f"options/test/{family}_Face_test.yml")))
        assert opt["network_g"]["type"] in _ARCHS
        assert opt["network_g"]["encoder"] == family
