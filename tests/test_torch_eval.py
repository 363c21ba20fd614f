"""The port's evaluation metrics and their helpers against the JAX package
on the CPU: the identity metric (metrics/identity.py, with the reference
`model_ir_se50.pth` reader `convert.from_reference_irse50`), MATLAB's
bicubic resize and the crop / flip augmentations (data/transforms.py),
NIQE (metrics/niqe.py), FID's Inception net (nn/inception.py, bridged by
`convert.from_jax_params(flat, "inception")`) and the Frechet distance
(metrics/fid.py).

Tolerances: identity within 1e-5 absolute of JAX's score (float32
IR-SE-50 convolutions in another order); the torch state_dict reader bit
for bit against the JAX converter followed by the bridge; `imresize`
within 1e-10 absolute (the same float64 products); crops and
augmentations equal; NIQE within 1e-8 relative (the same float64 numpy
and scipy arithmetic); Inception features within 1e-4 of max|ref|
(float32, ~95 convolutions); the Frechet distance and FID within 1e-8
relative."""

import importlib.util
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import fill_params, jax_tree, max_rel_err

from ood_gan_inversion_tpu.data import transforms as JT
from ood_gan_inversion_tpu.metrics import fid as j_fid
from ood_gan_inversion_tpu.metrics import identity as j_identity
from ood_gan_inversion_tpu.metrics import niqe as j_niqe
from ood_gan_inversion_tpu.nn.inception import InceptionV3FID as JInception
from ood_gan_inversion_tpu.nn.irse import ArcFaceBackbone as JArcFace
from ood_gan_inversion_tpu_torch.convert import from_jax_params, from_reference_irse50
from ood_gan_inversion_tpu_torch.data import transforms as PT
from ood_gan_inversion_tpu_torch.metrics import IdentityModel
from ood_gan_inversion_tpu_torch.metrics import fid as p_fid
from ood_gan_inversion_tpu_torch.metrics import identity as p_identity
from ood_gan_inversion_tpu_torch.metrics import niqe as p_niqe
from ood_gan_inversion_tpu_torch.nn.inception import InceptionV3FID
from ood_gan_inversion_tpu_torch.nn.irse import ArcFaceBackbone, get_blocks

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
ID_ATOL = 1e-5
RESIZE_ATOL = 1e-10
NIQE_RTOL = 1e-8
INCEPTION_RTOL = 1e-4
FID_RTOL = 1e-8


def reference_irse50_state_dict(seed, affine_out=False):
    """A seeded state_dict with the reference `model_ir_se50.pth`'s names
    and shapes: `input_layer` (conv, BN, PReLU), 24 `body` units
    (`shortcut_layer` conv + BN where the width changes, `res_layer` BN,
    conv, PReLU, conv, BN, SE), `output_layer` (BN2d, -, -, Linear,
    BatchNorm1d, without affine parameters in the IR-SE-50 file)."""
    rs = np.random.RandomState(seed)
    sd = {}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def conv(k, o, i, ks):
        sd[k] = t(rs.randn(o, i, ks, ks) / np.sqrt(i * ks * ks))

    def bn(k, c, affine=True):
        if affine:
            sd[f"{k}.weight"] = t(1.0 + 0.1 * rs.randn(c))
            sd[f"{k}.bias"] = t(0.1 * rs.randn(c))
        sd[f"{k}.running_mean"] = t(0.1 * rs.randn(c))
        sd[f"{k}.running_var"] = t(rs.uniform(0.5, 1.5, c))
        sd[f"{k}.num_batches_tracked"] = torch.tensor(7)

    conv("input_layer.0.weight", 64, 3, 3)
    bn("input_layer.1", 64)
    sd["input_layer.2.weight"] = t(0.25 + 0.05 * rs.randn(64))
    units = [u for block in get_blocks(50) for u in block]
    for i, (cin, depth, _) in enumerate(units):
        b = f"body.{i}"
        if cin != depth:
            conv(f"{b}.shortcut_layer.0.weight", depth, cin, 1)
            bn(f"{b}.shortcut_layer.1", depth)
        bn(f"{b}.res_layer.0", cin)
        conv(f"{b}.res_layer.1.weight", depth, cin, 3)
        sd[f"{b}.res_layer.2.weight"] = t(0.25 + 0.05 * rs.randn(depth))
        conv(f"{b}.res_layer.3.weight", depth, depth, 3)
        bn(f"{b}.res_layer.4", depth)
        conv(f"{b}.res_layer.5.fc1.weight", depth // 16, depth, 1)
        conv(f"{b}.res_layer.5.fc2.weight", depth, depth // 16, 1)
    bn("output_layer.0", 512)
    sd["output_layer.3.weight"] = t(0.01 * rs.randn(512, 512 * 49))
    sd["output_layer.3.bias"] = t(0.1 * rs.randn(512))
    bn("output_layer.4", 512, affine=affine_out)
    return sd


def jax_converter():
    path = osp.join(ROOT, "tools", "convert_torch_weights.py")
    spec = importlib.util.spec_from_file_location("_convert_torch_weights", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("affine_out", [False, True])
def test_reference_irse50_reader_matches_jax_converter(affine_out):
    """The IR-SE-50 file's output BatchNorm1d has no affine parameters;
    JAX's converter reads `output_layer.4.weight` before its fallback, so
    it is given the file with weight 1 and bias 0 written in, which is
    what the port's reader fills in."""
    sd = reference_irse50_state_dict(0, affine_out)
    filled = dict(sd)
    if not affine_out:
        filled["output_layer.4.weight"] = torch.ones(512)
        filled["output_layer.4.bias"] = torch.zeros(512)
    flat, leftovers = jax_converter().convert_irse50_backbone(filled)
    assert leftovers == []
    want, left = from_jax_params(flat, "id")
    assert left == []
    got = from_reference_irse50(sd)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ArcFaceBackbone().load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="no ArcFace counterpart"):
        from_reference_irse50({**sd, "fc.weight": torch.zeros(2, 2)})


@pytest.fixture(scope="module")
def arcface_flat():
    """One seeded ArcFace parameter set, installed in both metric
    singletons (reset afterwards)."""
    shapes = jax.eval_shape(lambda r: JArcFace(50).init(r, jnp.zeros((1, 112, 112, 3))),
                            jax.random.PRNGKey(0))["params"]
    flat = fill_params(shapes, seed=4)
    j_identity._IDModel._instance = j_identity._IDModel({"params": jax_tree(flat)})
    IdentityModel.instance(params=from_jax_params(flat, "id")[0], device="cpu")
    yield flat
    j_identity._IDModel._instance = j_identity._IDModel._instance_path = None
    IdentityModel._instance = IdentityModel._instance_path = None


def identity_pairs():
    """uint8 BGR pairs: noise against a perturbed copy at 64px, a smooth
    field against a shifted copy at 256px (the face crop runs from 256px
    up), and equal images."""
    rs = np.random.RandomState(1)
    a = rs.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rs.randint(-40, 41, a.shape), 0, 255).astype(np.uint8)
    y, x = np.mgrid[0:256, 0:256]
    c = np.stack([(y + x) % 256, (2 * y) % 256, (3 * x) % 256], -1).astype(np.uint8)
    return [("noise", a, b), ("smooth", c, np.roll(c, 7, axis=1)), ("equal", a, a)]


@pytest.mark.parametrize("pair", identity_pairs(), ids=lambda p: p[0])
def test_calculate_identity_matches_jax(arcface_flat, pair):
    _, a, b = pair
    missing = "checkpoints/absent/model_ir_se50.pth"
    ref = j_identity.calculate_identity(a, b, crop_border=2, model_path=missing)
    got = p_identity.calculate_identity(a, b, crop_border=2, model_path=missing, device="cpu")
    assert abs(got - ref) <= ID_ATOL, (got, ref)
    # crop_border and test_y_channel are ignored, as in the reference
    assert p_identity.calculate_identity(a, b, crop_border=0, test_y_channel=True,
                                         device="cpu") == got


def test_calculate_identity_reads_model_ir_se50(arcface_flat, tmp_path):
    """A model_path that exists is read through `from_reference_irse50`
    (held against JAX's converter above) and scores as those weights do."""
    path = str(tmp_path / "model_ir_se50.pth")
    sd = reference_irse50_state_dict(2)
    torch.save(sd, path)
    _, a, b = identity_pairs()[0]
    try:
        got = p_identity.calculate_identity(a, b, model_path=path, device="cpu")
        assert IdentityModel._instance_path == path
        assert p_identity.calculate_identity(a, b, model_path=path, device="cpu") == got
        IdentityModel.instance(params=from_reference_irse50(sd), device="cpu")
        assert p_identity.calculate_identity(a, b, device="cpu") == got
    finally:        # back to the fixture's weights for the other tests
        IdentityModel.instance(params=from_jax_params(arcface_flat, "id")[0], device="cpu")
    assert IdentityModel._instance_path is None


def test_identity_metric_warns_once_for_a_missing_file(arcface_flat, caplog):
    _, a, b = identity_pairs()[0]
    path = "checkpoints/absent/other_ir_se50.pth"
    with caplog.at_level("WARNING", logger="ood_gan_inversion_tpu_torch"):
        for _ in range(2):
            p_identity.calculate_identity(a, b, model_path=path, device="cpu")
    assert [r.message for r in caplog.records].count(
        f"identity metric: {path} not found; scoring with seeded ArcFace weights") == 1


# --- data/transforms.py ------------------------------------------------------------------
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("scale", [0.25, 0.5, 0.7, 1.3, 2.0])
def test_imresize_matches_jax(scale, antialias):
    img = np.random.RandomState(0).rand(37, 29, 3)
    ref = JT.imresize(img, scale, antialiasing=antialias)
    got = PT.imresize(img, scale, antialiasing=antialias)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                               rtol=0, atol=RESIZE_ATOL)
    np.testing.assert_allclose(PT._resize_matrix(37, ref.shape[0], scale, antialias),
                               JT._resize_matrix(37, ref.shape[0], scale, antialias),
                               rtol=0, atol=RESIZE_ATOL)


def test_imresize_grayscale_matches_jax():
    img = np.random.RandomState(1).rand(41, 33).astype(np.float32)
    ref, got = JT.imresize(img, 0.5), PT.imresize(img, 0.5)
    assert got.ndim == 2 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_ATOL)


def test_mod_crop_and_paired_random_crop_match_jax():
    img = np.arange(7 * 9 * 3, dtype=np.float32).reshape(7, 9, 3)
    np.testing.assert_array_equal(PT.mod_crop(img, 4), JT.mod_crop(img, 4))
    np.testing.assert_array_equal(PT.mod_crop(img[..., 0], 3), JT.mod_crop(img[..., 0], 3))
    with pytest.raises(ValueError):
        PT.mod_crop(img[None], 4)
    rs = np.random.RandomState(2)
    gts = [rs.rand(48, 40, 3) for _ in range(2)]
    lqs = [rs.rand(12, 10, 3) for _ in range(2)]
    for seed in range(4):
        got = PT.paired_random_crop(gts, lqs, 16, 4, rng=np.random.default_rng(seed))
        ref = JT.paired_random_crop(gts, lqs, 16, 4, rng=np.random.default_rng(seed))
        for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(g, r)
    one = PT.paired_random_crop(gts[0], lqs[0], 16, 4, rng=np.random.default_rng(0))
    assert one[0].shape == (16, 16, 3) and one[1].shape == (4, 4, 3)
    with pytest.raises(ValueError, match="Scale mismatches"):
        PT.paired_random_crop(gts[0], lqs[0], 16, 3)
    with pytest.raises(ValueError, match="smaller than patch size"):
        PT.paired_random_crop(gts[0], lqs[0], 64, 4)


class PinnedDraws:
    """A numpy Generator stand-in whose `random()` returns given values."""

    def __init__(self, values):
        self.values = list(values)

    def random(self):
        return self.values.pop(0)


@pytest.mark.parametrize("draws", [(0.1, 0.9, 0.9), (0.9, 0.1, 0.9), (0.9, 0.9, 0.1),
                                   (0.1, 0.1, 0.1)])
def test_augment_with_pinned_draws_matches_jax(draws):
    rs = np.random.RandomState(3)
    imgs = [rs.rand(6, 8, 3), rs.rand(6, 8)]
    flows = [rs.randn(6, 8, 2)]
    got = PT.augment(imgs, True, True, flows=flows, return_status=True, rng=PinnedDraws(draws))
    ref = JT.augment(imgs, True, True, flows=flows, return_status=True, rng=PinnedDraws(draws))
    assert got[2] == ref[2] == tuple(d < 0.5 for d in draws)
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(g, r)
    single = PT.augment(imgs[0], hflip=True, rotation=False, rng=PinnedDraws(draws))
    np.testing.assert_array_equal(
        single, JT.augment(imgs[0], hflip=True, rotation=False, rng=PinnedDraws(draws)))


# --- NIQE --------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    """A synthetic pristine model (mean, positive-definite covariance,
    the default window) in an .npz, as the reference's file holds it."""
    rs = np.random.RandomState(5)
    a = rs.randn(36, 36)
    path = str(tmp_path_factory.mktemp("niqe") / "pris.npz")
    np.savez(path, mu_pris_param=rs.rand(1, 36), cov_pris_param=a @ a.T / 36 + np.eye(36),
             gaussian_window=j_niqe.default_gaussian_window())
    return path


def test_niqe_score_matches_jax(pristine):
    p = np.load(pristine)
    img = np.random.RandomState(6).rand(200, 290) * 255
    args = (np.ravel(p["mu_pris_param"]), p["cov_pris_param"], p["gaussian_window"])
    ref = j_niqe.niqe_score(img, *args)
    got = p_niqe.niqe_score(img, *args)
    assert np.isfinite(ref) and abs(got - ref) <= NIQE_RTOL * abs(ref)
    np.testing.assert_array_equal(p_niqe.default_gaussian_window(),
                                  j_niqe.default_gaussian_window())


@pytest.mark.parametrize("kind", ["bgr", "gray"])
def test_calculate_niqe_matches_jax(pristine, kind):
    rs = np.random.RandomState(7)
    y, x = np.mgrid[0:196, 0:200]
    img = np.clip(np.stack([x, y, x + y], -1) * 0.6 + rs.randn(196, 200, 3) * 12, 0, 255)
    img = img.astype(np.uint8) if kind == "bgr" else img[..., 0].astype(np.uint8)
    ref = j_niqe.calculate_niqe(img, crop_border=2, pris_params_path=pristine)
    got = p_niqe.calculate_niqe(img, crop_border=2, pris_params_path=pristine)
    assert abs(got - ref) <= NIQE_RTOL * abs(ref), (got, ref)
    with pytest.raises(ValueError, match="pris_params_path"):
        p_niqe.calculate_niqe(img)


# --- FID ---------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def inception_pair():
    """JAX's InceptionV3FID on a seeded tree and the port's net holding
    the same through the bridge."""
    shapes = jax.eval_shape(lambda r: JInception().init(r, jnp.zeros((1, 299, 299, 3))),
                            jax.random.PRNGKey(0))["params"]
    flat = fill_params(shapes, seed=8)
    state, leftovers = from_jax_params(flat, "inception")
    assert leftovers == []
    net = InceptionV3FID()
    net.load_state_dict(state, strict=True)
    assert "Mixed_5b.branch5x5_1.bn.running_var" in state
    japply = jax.jit(lambda p, x: JInception().apply({"params": p}, x))
    return jax_tree(flat), japply, net.eval()


@pytest.mark.parametrize("size", [299, 160])
def test_inception_features_match_jax(inception_pair, size):
    params, japply, net = inception_pair
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    ref = np.asarray(japply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 2048)
    assert max_rel_err(got, ref) <= INCEPTION_RTOL


def test_frechet_distance_and_calculate_fid_match_jax():
    rs = np.random.RandomState(9)
    f1 = rs.randn(80, 16)
    f2 = 0.8 * rs.randn(70, 16) + 0.3
    for a, b in ((f1, f2), (f2, f1), (f1, f1)):
        sa, sb = j_fid.feature_stats(a), j_fid.feature_stats(b)
        for got, ref in zip(p_fid.feature_stats(a), sa):
            np.testing.assert_array_equal(got, ref)
        ref = j_fid.frechet_distance(*sa, *sb)
        got = p_fid.frechet_distance(*sa, *sb)
        assert abs(got - ref) <= FID_RTOL * max(abs(ref), 1e-12), (got, ref)
    ref = j_fid.calculate_fid(feats1=f1, feats2=f2)
    assert abs(p_fid.calculate_fid(feats1=f1, feats2=f2) - ref) <= FID_RTOL * ref
    stats = (p_fid.feature_stats(f1), p_fid.feature_stats(f2))
    assert abs(p_fid.calculate_fid(stats1=stats[0], stats2=stats[1]) - ref) <= FID_RTOL * ref
    batches = [torch.from_numpy(f1[i:i + 20]) for i in range(0, 80, 20)]
    np.testing.assert_array_equal(p_fid.extract_features(batches, lambda t: t * 2), f1 * 2)
