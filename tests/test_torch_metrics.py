"""The port's metrics (metrics/psnr_ssim.py, metrics/lpips.py with
nn/lpips.py, metrics/__init__.py:calculate_metric, and its dispatch of
the identity, FID and NIQE metrics that tests/test_torch_eval.py holds)
against the JAX package on the CPU, on seeded uint8 images.

Tolerances: PSNR within 1e-10 relative (the same numpy arithmetic);
SSIM within 1e-6 (OpenCV's filter2D in both). LPIPS, with JAX's
parameters through the weights bridge, within 1e-5 relative of JAX's
`calculate_lpips` (float32 convolutions in another order)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import fill_params, jax_tree

from ood_gan_inversion_tpu.metrics import calculate_metric as j_calculate_metric
from ood_gan_inversion_tpu.metrics import identity as j_identity
from ood_gan_inversion_tpu.metrics import lpips as j_lpips_metric
from ood_gan_inversion_tpu.metrics import psnr_ssim as J
from ood_gan_inversion_tpu.nn.irse import ArcFaceBackbone as JArcFace
from ood_gan_inversion_tpu.nn.lpips import LPIPS as JLPIPS
from ood_gan_inversion_tpu_torch.convert import from_jax_params
from ood_gan_inversion_tpu_torch.metrics import IdentityModel, LPIPSModel, calculate_metric
from ood_gan_inversion_tpu_torch.metrics import psnr_ssim as P
from ood_gan_inversion_tpu_torch.nn.layers import init_weights
from ood_gan_inversion_tpu_torch.nn.lpips import ALEX_LAYOUT, LPIPS

PSNR_RTOL = 1e-10
SSIM_ATOL = 1e-6
LPIPS_RTOL = 1e-5


def image_pairs():
    """(name, img, img2): uint8 BGR pairs: noise against a perturbed copy,
    a smooth gradient against a blurred copy, flat regions, and equal
    images."""
    rs = np.random.RandomState(0)
    a = rs.randint(0, 256, (72, 64, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rs.randint(-25, 26, a.shape), 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[0:80, 0:96]
    g = np.stack([(yy * 3) % 256, (xx * 2) % 256, (yy + xx) % 256], -1).astype(np.uint8)
    gb = cv2.GaussianBlur(g, (5, 5), 1.2)
    flat = np.full((48, 48, 3), 128, np.uint8)
    flat2 = flat.copy()
    flat2[10:20] = 200
    pairs = [("noise", a, b), ("gradient", g, gb), ("flat", flat, flat2), ("equal", a, a.copy())]
    for i in range(3):
        s = cv2.GaussianBlur(rs.randint(0, 256, (64, 64, 3)).astype(np.uint8), (9, 9), 3)
        pairs.append((f"smooth{i}", s,
                      np.clip(s.astype(int) + rs.randint(-5, 6, s.shape), 0, 255).astype(np.uint8)))
    return pairs


PAIRS = image_pairs()


@pytest.mark.parametrize("pair", range(len(PAIRS)), ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("y", [False, True])
@pytest.mark.parametrize("crop", [0, 2])
def test_psnr_and_ssim_match_jax(pair, y, crop):
    _, a, b = PAIRS[pair]
    ref = J.calculate_psnr(a, b, crop, test_y_channel=y)
    got = P.calculate_psnr(a, b, crop, test_y_channel=y)
    assert got == ref or abs(got - ref) <= PSNR_RTOL * abs(ref)
    ref = J.calculate_ssim(a, b, crop, test_y_channel=y)
    got = P.calculate_ssim(a, b, crop, test_y_channel=y)
    assert abs(got - ref) <= SSIM_ATOL, (got, ref)


def test_y_channel_helpers_match_jax():
    a = PAIRS[0][1]
    np.testing.assert_array_equal(P.to_y_channel(a), J.to_y_channel(a))
    np.testing.assert_array_equal(P.bgr2ycbcr_y(a / 255.0), J.bgr2ycbcr_y(a / 255.0))


def test_gaussian_window_and_valid_filter_match_opencv():
    k = P.gaussian_kernel(11, 1.5)
    np.testing.assert_allclose(k, cv2.getGaussianKernel(11, 1.5)[:, 0], rtol=1e-15, atol=0)
    img = np.random.RandomState(1).rand(40, 33) * 255
    ref = cv2.filter2D(img, -1, np.outer(k, k))[5:-5, 5:-5]
    np.testing.assert_array_equal(P._filter_valid(img, k), ref)


def test_metric_shape_mismatch_raises():
    with pytest.raises(ValueError):
        P.calculate_psnr(np.zeros((4, 4, 3)), np.zeros((4, 5, 3)), 0)
    with pytest.raises(ValueError):
        P.calculate_ssim(np.zeros((4, 4, 3)), np.zeros((4, 5, 3)), 0)


@pytest.fixture
def lpips_params():
    """JAX's LPIPS parameters from seeded numpy fills (lin_i positive, as
    LPIPS's learned weights are), installed as JAX's metric singleton, and
    the port's LPIPSModel on the CPU holding the same through the bridge.
    Both singletons are reset afterwards."""
    jnet = JLPIPS()
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda r: jnet.init(r, x, x), jax.random.PRNGKey(0))["params"]
    flat = fill_params(shapes, seed=3)
    for i in range(len(ALEX_LAYOUT)):
        flat[f"lin{i}"] = np.abs(flat[f"lin{i}"]) + 0.01
    state, leftovers = from_jax_params(flat, "lpips")
    assert leftovers == []
    jmodel = j_lpips_metric.LPIPSModel.instance(params={"params": jax_tree(flat)})
    pmodel = LPIPSModel.instance(params=state, device="cpu")
    yield flat, jmodel, pmodel
    j_lpips_metric.LPIPSModel._instance = None
    LPIPSModel._instance = None


def test_lpips_net_matches_jax(lpips_params):
    flat, jmodel, pmodel = lpips_params
    rs = np.random.RandomState(4)
    a = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rs.randn(*a.shape), -1, 1).astype(np.float32)
    ref = jmodel(jnp.asarray(a), jnp.asarray(b))
    got = pmodel(a, b)
    assert got.shape == ref.shape == (2,)
    assert np.abs(got - ref).max() <= LPIPS_RTOL * np.abs(ref).max()


@pytest.mark.parametrize("pair", range(len(PAIRS)), ids=[p[0] for p in PAIRS])
def test_calculate_lpips_matches_jax(lpips_params, pair):
    _, a, b = PAIRS[pair]
    m_opt = {"type": "calculate_lpips", "crop_border": 2, "test_y_channel": True,
             "better": "lower"}
    ref = j_calculate_metric({"img": a, "img2": b}, m_opt)
    got = calculate_metric({"img": a, "img2": b, "device": "cpu"}, m_opt)
    assert abs(got - ref) <= LPIPS_RTOL * max(abs(ref), 1e-6), (got, ref)


def test_calculate_lpips_uneven_shapes_match_jax(lpips_params):
    a, b = PAIRS[0][1], PAIRS[1][2]
    kw = {"crop_border": 0, "strict_shape": False}
    ref = j_lpips_metric.calculate_lpips(a, b, **kw)
    got = calculate_metric({"img": a, "img2": b, "device": "cpu"},
                           {"type": "calculate_lpips", **kw})
    assert abs(got - ref) <= LPIPS_RTOL * abs(ref)


@pytest.mark.parametrize("pair", range(len(PAIRS)), ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("name", ["psnr", "ssim"])
def test_calculate_metric_dispatch_matches_jax(name, pair):
    m_opt = {"type": f"calculate_{name}", "crop_border": 2, "test_y_channel": True,
             "better": "higher"}
    _, a, b = PAIRS[pair]
    ref = j_calculate_metric({"img": a, "img2": b}, m_opt)
    got = calculate_metric({"img": a, "img2": b, "device": "cpu"}, m_opt)
    assert got == ref or abs(got - ref) <= (PSNR_RTOL * abs(ref) if name == "psnr"
                                            else SSIM_ATOL)
    assert m_opt["type"] == f"calculate_{name}"          # the caller's dict is left as it is


@pytest.fixture
def arcface_params():
    """One seeded ArcFace parameter set in both identity-metric singletons
    (reset afterwards)."""
    shapes = jax.eval_shape(lambda r: JArcFace(50).init(r, jnp.zeros((1, 112, 112, 3))),
                            jax.random.PRNGKey(0))["params"]
    flat = fill_params(shapes, seed=6)
    j_identity._IDModel._instance = j_identity._IDModel({"params": jax_tree(flat)})
    IdentityModel.instance(params=from_jax_params(flat, "id")[0], device="cpu")
    yield
    j_identity._IDModel._instance = j_identity._IDModel._instance_path = None
    IdentityModel._instance = IdentityModel._instance_path = None


@pytest.mark.parametrize("name", ["calculate_identity", "calculate_fid", "calculate_niqe"])
def test_identity_fid_niqe_dispatch_matches_jax(name, request, tmp_path):
    """calculate_metric of each metric against JAX's: identity within 1e-5
    absolute (seeded ArcFace weights in both singletons), FID and NIQE
    within 1e-8 relative (the same float64 numpy and scipy arithmetic)."""
    rs = np.random.RandomState(3)
    if name == "calculate_identity":
        request.getfixturevalue("arcface_params")
        a = rs.randint(0, 256, (64, 64, 3)).astype(np.uint8)
        data = {"img": a, "img2": np.roll(a, 3, axis=0)}
        m_opt = {"type": name, "crop_border": 2, "better": "higher",
                 "model_path": "checkpoints/absent/model_ir_se50.pth"}
    elif name == "calculate_fid":
        data = {"feats1": rs.randn(40, 8), "feats2": rs.randn(30, 8) + 0.2}
        m_opt = {"type": name, "better": "lower"}
    else:
        c = rs.randn(36, 36)
        path = str(tmp_path / "pris.npz")
        np.savez(path, mu_pris_param=rs.rand(1, 36), cov_pris_param=c @ c.T / 36 + np.eye(36))
        data = {"img": rs.randint(0, 256, (200, 200, 3)).astype(np.uint8)}
        m_opt = {"type": name, "crop_border": 0, "pris_params_path": path}
    ref = j_calculate_metric(data, m_opt)
    got = calculate_metric({**data, "device": "cpu"}, m_opt)
    tol = 1e-5 if name == "calculate_identity" else 1e-8 * abs(ref)
    assert np.isfinite(ref) and abs(got - ref) <= tol, (got, ref)
    assert m_opt["type"] == name                       # the caller's dict is left as it is
    with pytest.raises(KeyError):
        calculate_metric({}, {"type": "calculate_nothing"})


def test_lpips_seeded_init_follows_jax_initializers():
    net = init_weights(LPIPS(), 0)
    for i, (ch, k, *_) in enumerate(ALEX_LAYOUT):
        lin = getattr(net, f"lin{i}")
        assert torch.equal(lin, torch.full((ch,), 1.0 / ch))
        w = getattr(net.net, f"conv{i}").weight
        bound = 1.0 / np.sqrt(w[0].numel())
        assert float(w.detach().abs().max()) <= bound and float(w.detach().std()) > bound / 3
    assert torch.equal(init_weights(LPIPS(), 0).net.conv2.weight, net.net.conv2.weight)


def test_lpips_model_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LPIPSModel(device="cuda")
