"""The port's ops against their JAX twins on the CPU, and the warp-blend
plain version against both the JAX reference and the TPU kernel itself
(interpret mode). Tolerance for ops: 1e-5 absolute -- float32 on both sides,
the same formulas, differing only in summation order and rounding of
intermediate products."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets torch's thread count)
from torch_inputs import warp_inputs
from torch_parity import nchw, nhwc

# the JAX ops package re-exports functions under some module names, so the
# modules are fetched by path
j_act, j_gs, j_mod, j_pw, j_rs, j_fir = (
    importlib.import_module(f"ood_gan_inversion_tpu.ops.{m}") for m in
    ("fused_act", "grid_sample", "modulated", "pallas_warp", "resize", "upfirdn2d"))
from ood_gan_inversion_tpu_torch.ops import fused_act, modulated, resize, upfirdn2d
from ood_gan_inversion_tpu_torch.ops.grid_sample import grid_sample_bilinear
from ood_gan_inversion_tpu_torch.ops.warp_blend import warp_blend, warp_blend_reference

ATOL = 1e-5


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def test_fused_leaky_relu():
    x, b = rand(2, 5, 6, 7), rand(7, seed=1)
    close(nhwc(fused_act.fused_leaky_relu(nchw(x), torch.from_numpy(b))),
          j_act.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    close(fused_act.fused_leaky_relu(torch.from_numpy(x[:, 0, 0])),
          j_act.fused_leaky_relu(jnp.asarray(x[:, 0, 0])))


def test_make_kernel():
    np.testing.assert_array_equal(upfirdn2d.make_kernel([1, 3, 3, 1]),
                                  j_fir.make_kernel([1, 3, 3, 1]))


@pytest.mark.parametrize("up,down,pad", [(1, 1, (2, 1)), (2, 1, (2, 1)),
                                         (1, 2, (1, 1)), (1, 1, (-1, 2))])
def test_upfirdn2d(up, down, pad):
    x = rand(2, 9, 8, 3)
    k = j_fir.make_kernel([1, 3, 3, 1]) * (up * up)
    close(nhwc(upfirdn2d.upfirdn2d(nchw(x), k, up=up, down=down, pad=pad)),
          j_fir.upfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad))


def test_upsample2x_and_blur():
    x, k = rand(1, 6, 6, 4), j_fir.make_kernel([1, 3, 3, 1])
    close(nhwc(upfirdn2d.upsample2x(nchw(x), k)), j_fir.upsample2x(jnp.asarray(x), k))
    close(nhwc(upfirdn2d.blur(nchw(x), k, pad=(1, 1), upsample_factor=2)),
          j_fir.blur(jnp.asarray(x), k, pad=(1, 1), upsample_factor=2))


def test_pixel_norm_equal_linear_demod():
    x, w, b = rand(3, 16), rand(16, 8, seed=1), rand(8, seed=2)
    close(modulated.pixel_norm(torch.from_numpy(x)), j_mod.pixel_norm(jnp.asarray(x)))
    # the port stores linear weights (out, in)
    close(modulated.equal_linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                 torch.from_numpy(b), lr_mul=0.01),
          j_mod.equal_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 0.01))
    k, s = rand(3, 3, 16, 8, seed=3) * 0.1, rand(3, 16, seed=4)
    close(modulated.demod_scale(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                                torch.from_numpy(s)),
          j_mod.demod_scale(jnp.asarray(k), jnp.asarray(s)))


@pytest.mark.parametrize("upsample,demodulate,ksize", [
    (False, True, 3), (True, True, 3), (False, False, 1)])
def test_modulated_conv2d(upsample, demodulate, ksize):
    x = rand(2, 8, 8, 6)
    w = rand(ksize, ksize, 6, 5, seed=1)
    s = 1.0 + 0.2 * rand(2, 6, seed=2)
    bk = j_fir.make_kernel([1, 3, 3, 1])
    got = modulated.modulated_conv2d(
        nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
        torch.from_numpy(s), demodulate=demodulate, upsample=upsample,
        blur_kernel=bk)
    ref = j_mod.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                 demodulate=demodulate, upsample=upsample,
                                 blur_kernel=bk)
    close(nhwc(got), ref)


@pytest.mark.parametrize("n_in,n_out,method,ac", [
    (1024, 256, "bilinear", False), (7, 13, "bilinear", False),
    (16, 32, "bicubic", True), (32, 64, "bicubic", True)])
def test_interp_matrix(n_in, n_out, method, ac):
    np.testing.assert_array_equal(resize.interp_matrix(n_in, n_out, method, ac),
                                  j_rs.interp_matrix(n_in, n_out, method, ac))


def test_resize():
    x = rand(2, 32, 24, 3)
    close(nhwc(resize.resize_bilinear(nchw(x), (16, 40))),
          j_rs.resize_bilinear(jnp.asarray(x), (16, 40)))
    close(nhwc(resize.resize_bicubic_ac(nchw(x), (64, 48))),
          j_rs.resize_bicubic_ac(jnp.asarray(x), (64, 48)))


def test_grid_sample_bilinear():
    x, grid, _ = warp_inputs(2, 16, 5, 0.3)
    grid[0, 0, 0] = (1.2, -1.3)                  # outside the image: zero taps
    close(grid_sample_bilinear(torch.from_numpy(x), torch.from_numpy(grid)),
          j_gs.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid)))


@pytest.mark.parametrize("b,size,c,scale,at_bound", [
    (1, 32, 128, 0.08, False),
    (2, 64, 128, 0.08, False),
    (1, 32, 256, 0.02, False),
    (1, 32, 128, 0.1, True),
])
def test_warp_blend_reference_matches_jax_and_tpu_kernel(b, size, c, scale, at_bound):
    """The plain version against JAX's warp_blend_reference and against the
    TPU kernel itself (Pallas interpret mode), at the shapes of
    tests/test_pallas_warp.py and with the flow pinned at the bound."""
    x, grid, alpha = warp_inputs(b, size, c, scale, seed=3, at_bound=at_bound)
    got = warp_blend_reference(torch.from_numpy(x), torch.from_numpy(grid),
                               torch.from_numpy(alpha)).numpy()
    jx, jg, ja = jnp.asarray(x), jnp.asarray(grid), jnp.asarray(alpha)
    close(got, j_pw.warp_blend_reference(jx, jg, ja))
    tpu = j_pw._warp_blend_fwd(jx, jg, ja, j_pw.max_disp_px(scale, size),
                               interpret=True)
    close(got, tpu)
    # on CPU tensors the wrapper is the plain version, and counts nothing
    before = warp_blend.launches
    out = warp_blend(torch.from_numpy(x), torch.from_numpy(grid),
                     torch.from_numpy(alpha))
    np.testing.assert_array_equal(out.numpy(), got)
    assert warp_blend.launches == before


def test_warp_blend_rejects_what_the_kernel_does_not_take():
    x, grid, alpha = (torch.from_numpy(a) for a in warp_inputs(1, 8, 4, 0.1))
    with pytest.raises(TypeError):
        warp_blend(x.double(), grid, alpha)
    with pytest.raises(ValueError):
        warp_blend(x, grid[..., :1].contiguous(), alpha)
    with pytest.raises(ValueError):
        warp_blend(x.permute(0, 2, 1, 3), grid, alpha)   # not contiguous
    with pytest.raises(ValueError):
        warp_blend(x, grid.double(), alpha)
    with pytest.raises(ValueError):
        warp_blend(x, grid, alpha[..., 0])


@pytest.mark.parametrize("shape_from,shape_to", [((32, 32), (64, 64)), ((8, 8), (16, 16))])
def test_cached_operators_made_in_inference_mode_serve_autograd(shape_from, shape_to):
    """The resize matrices and FIR kernels are cached per shape, dtype and
    device. A cache entry made inside `torch.inference_mode` (an engine's
    forward) must still serve a later forward that autograd records (a
    train step of the same shapes): an inference tensor cannot be saved for
    backward."""
    k = upfirdn2d.make_kernel((1, 3, 3, 2))
    x = torch.rand(1, 1, *shape_from)
    with torch.inference_mode():
        resize.resize_bilinear(x, shape_to)
        upfirdn2d.upsample2x(x, k)
    y = x.clone().requires_grad_()
    (resize.resize_bilinear(y, shape_to).sum() + upfirdn2d.upsample2x(y, k).sum()).backward()
    assert y.grad is not None and bool(torch.isfinite(y.grad).all())
