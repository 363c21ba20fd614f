"""The phase-packed >=512px generator tail of the port -- the polyphase
algebra, the packed conv pair and stage, `Generator.packed_stage` and the
inversion slice with the packed tail -- against the JAX package on the CPU.

On the CPU the port's kernel wrappers run their plain versions; the JAX
wrappers run their Pallas kernels in interpret mode. Tolerances:
  * packed kernels, packing, tiling: 1e-6 (exact up to float32 rounding of
    a few products);
  * packed convolutions and the pair / stage functions: 2e-5, as in
    tests/test_pallas_kernels.py (float32, other summation order);
  each as absolute plus relative tolerance (`close`);
  * decodes: 2e-5 of max|ref| for the generator, 1e-3 of max|ref| for the
    whole slice (as tests/test_torch_arch.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err,
                          with_style_mlp)

j_poly, j_pk, j_sg2, j_fir = (
    importlib.import_module(f"ood_gan_inversion_tpu.{m}") for m in
    ("ops.polyphase", "ops.pallas_kernels", "nn.stylegan2", "ops.upfirdn2d"))
from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu_torch.archs.ood_e4e import OODFaceGANE4E
from ood_gan_inversion_tpu_torch.convert import from_jax_params
from ood_gan_inversion_tpu_torch.infer import InversionEngine
from ood_gan_inversion_tpu_torch.nn import stylegan2 as sg2
from ood_gan_inversion_tpu_torch.ops import packed_conv, polyphase

BLUR = j_fir.make_kernel((1, 3, 3, 1))
PACK_TOL = 1e-6
CONV_TOL = 2e-5
GEN_RTOL = 2e-5
SLICE_RTOL = 1e-3
SLICE_CFG = dict(out_size=512, channel_multiplier=1, narrow=0.125,
                 encoder_num_layers=4, cycle_align=2, warp_scale=0.08)
GEN_CFG = dict(size=64, style_dim=64, channel_multiplier=1, narrow=0.125)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def close(got, ref, tol):
    """|got - ref| <= tol + tol * |ref|, as np.testing.assert_allclose with
    rtol = atol = tol (the form of tests/test_pallas_kernels.py)."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


T = torch.from_numpy


# ------------------------------------------------------------ polyphase


def test_pack_and_unpack_match_jax():
    x = rand(2, 8, 10, 5)
    packed = polyphase.pack_space_to_depth(T(x))
    close(packed, j_poly.pack_space_to_depth(jnp.asarray(x)), PACK_TOL)
    close(polyphase.unpack_depth_to_space(packed, 5), x, PACK_TOL)
    xp = rand(2, 4, 5, 12, seed=1)
    close(polyphase.unpack_depth_to_space(T(xp), 3),
          j_poly.unpack_depth_to_space(jnp.asarray(xp), 3), PACK_TOL)


@pytest.mark.parametrize("kernel", ["upconv_blur", "conv3x3", "conv1x1", "skip_up"])
def test_packed_kernels_match_jax(kernel):
    if kernel == "upconv_blur":
        w = rand(3, 3, 5, 7, seed=2)
        got = polyphase.upconv_blur_packed_kernel(T(w), BLUR)
        ref = j_poly.upconv_blur_packed_kernel(jnp.asarray(w), BLUR)
    elif kernel == "conv3x3":
        w = rand(3, 3, 6, 4, seed=3)
        got = polyphase.conv3x3_packed_kernel(T(w))
        ref = j_poly.conv3x3_packed_kernel(jnp.asarray(w))
    elif kernel == "conv1x1":
        w = rand(1, 1, 6, 3, seed=4)
        got = polyphase.conv1x1_packed_kernel(T(w))
        ref = j_poly.conv1x1_packed_kernel(jnp.asarray(w))
    else:
        got = polyphase.skip_up_packed_kernel(BLUR, 3)
        ref = j_poly.skip_up_packed_kernel(BLUR, 3)
    assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
    close(got, ref, PACK_TOL)


@pytest.mark.parametrize("ksize,padding", [(3, 1), (1, 0)])
def test_conv_packed_and_tile_match_jax(ksize, padding):
    x, k = rand(2, 9, 7, 6, seed=5), rand(ksize, ksize, 6, 8, seed=6, scale=0.3)
    close(polyphase.conv_packed(T(x), T(k), padding),
          j_poly.conv_packed(jnp.asarray(x), jnp.asarray(k), padding), CONV_TOL)
    v = rand(2, 5, seed=7)
    close(polyphase.tile_phase_major(T(v)), j_poly.tile_phase_major(jnp.asarray(v)),
          PACK_TOL)


def test_packed_conv2_kernel_is_three_quarters_zero():
    """The dense packed conv2 kernel does 4x the MACs of the unpacked conv:
    only 9 of the 36 (output phase, tap) blocks per input phase are non-zero."""
    k = polyphase.conv3x3_packed_kernel(torch.ones(3, 3, 1, 1))
    assert k.shape == (3, 3, 4, 4)
    assert int((k != 0).sum()) == 36 and k.numel() == 144


# ------------------------------------------------- packed pair and stage


def pair_args(rs, b, h, c1=8, c4=16):
    """The inputs of tests/test_pallas_kernels.py:_make_args, as numpy."""
    return dict(
        x=rs.randn(b, h, h, c1), n1=0.1 * rs.randn(b, h, h, 4),
        n2=0.1 * rs.randn(b, h, h, 4), k1=rs.randn(3, 3, c1, c4) * 0.2,
        s1=rs.rand(b, c1) + 0.5, d1=rs.rand(b, c4) + 0.5,
        b1=0.1 * rs.randn(c4), k2=rs.randn(3, 3, c4, c4) * 0.2,
        s2=rs.rand(b, c4) + 0.5, d2=rs.rand(b, c4) + 0.5, b2=0.1 * rs.randn(c4))


def stage_args(rs, b, h, c1=8, c4=16):
    a = pair_args(rs, b, h, c1, c4)
    a["skip"] = rs.randn(b, h, h, 3)
    a["k3sr"] = (rs.rand(b, c4) + 0.5)[:, :, None] * (rs.randn(c4, 12) * 0.2)[None]
    a["b3"] = rs.randn(12) * 0.1
    a["k4"] = rs.randn(3, 3, 3, 12) * 0.1
    order = ["x", "n1", "n2", "skip", "k1", "s1", "d1", "b1", "k2", "s2", "d2",
             "b2", "k3sr", "b3", "k4"]
    return [a[k].astype(np.float32) for k in order]


PAIR_ORDER = ["x", "n1", "n2", "k1", "s1", "d1", "b1", "k2", "s2", "d2", "b2"]


@pytest.mark.parametrize("fn", ["packed_pair_reference", "fused_packed_pair"])
@pytest.mark.parametrize("b,h", [(1, 16), (2, 16), (1, 32)])
def test_packed_pair_matches_jax(fn, b, h):
    a = pair_args(np.random.RandomState(b * 100 + h), b, h)
    args = [a[k].astype(np.float32) for k in PAIR_ORDER]
    got = getattr(packed_conv, fn)(*map(T, args))
    ref = getattr(j_pk, fn)(*map(jnp.asarray, args))
    assert tuple(got.shape) == ref.shape == (b, h, h, 16)
    close(got, ref, CONV_TOL)


@pytest.mark.parametrize("fn", ["packed_stage_reference", "fused_packed_stage"])
@pytest.mark.parametrize("b,h", [(2, 16), (1, 32)])
def test_packed_stage_matches_jax(fn, b, h):
    args = stage_args(np.random.RandomState(b * 10 + h), b, h)
    rgb, z2 = getattr(packed_conv, fn)(*map(T, args))
    rgb_ref, z2_ref = getattr(j_pk, fn)(*map(jnp.asarray, args))
    assert tuple(rgb.shape) == rgb_ref.shape == (b, h, h, 12)
    close(z2, z2_ref, CONV_TOL)
    close(rgb, rgb_ref, CONV_TOL)


def test_wrappers_check_operands():
    args = [T(a) for a in stage_args(np.random.RandomState(0), 1, 8)]
    with pytest.raises(ValueError, match="k1"):
        packed_conv.fused_packed_stage(*args[:4], args[4][:, :, :4], *args[5:])
    with pytest.raises(ValueError, match="noise4"):
        packed_conv.fused_conv3x3_act(args[0], args[1][..., :2], args[4], args[5],
                                      args[6], args[7])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        packed_conv.fused_conv3x3_act(args[0].double(), *args[1:2], args[4], *args[5:8])
    before = (packed_conv.fused_conv3x3_act.launches, packed_conv.fused_packed_stage.launches)
    packed_conv.fused_packed_stage(*args)          # CPU: plain version, no launch
    packed_conv.fused_packed_pair(args[0], args[1], args[2], *args[4:12])
    assert (packed_conv.fused_conv3x3_act.launches,
            packed_conv.fused_packed_stage.launches) == before


# ---------------------------------------------------------- the generator


@pytest.fixture(scope="module")
def gen_flat():
    """A small JAX generator's parameters filled from a numpy seed, with
    non-zero noise weights and biases."""
    lats = jnp.zeros((2, 10, 64), jnp.float32)
    jgen = j_sg2.Generator(n_mlp=2, **GEN_CFG)
    return with_style_mlp(fill_params(init_shapes(jgen, lats, packed=False), seed=3), jgen, 64,
                          seed=4)


def gen_inputs(seed=4):
    rs = np.random.RandomState(seed)
    lats = rs.randn(2, 10, 64).astype(np.float32)
    noise = [rs.randn(2, 1, s, s).astype(np.float32)
             for s in (4, 8, 8, 16, 16, 32, 32, 64, 64)]
    return lats, noise


def port_generator(gen_flat, **tail):
    return load_port(sg2.Generator(**GEN_CFG, n_mlp=2, **tail), gen_flat, prefix="generator/")


@pytest.mark.parametrize("tail_kernel", ["none", "pair", "stage"])
def test_packed_generator_matches_unpacked(gen_flat, tail_kernel, monkeypatch):
    """Packed stages at 32 and 64px (the packing threshold lowered, as in
    tests/test_polyphase.py) against the unpacked decode, same weights and
    noise: the same linear algebra, 2e-5 of max|ref|."""
    monkeypatch.setattr(sg2, "_PACKED_MIN_RES", 32)
    lats_np, noise_np = gen_inputs()
    lats, noise = T(lats_np), [T(n) for n in noise_np]
    packed = port_generator(gen_flat, packed_tail=True, tail_kernel=tail_kernel)
    assert [packed.stage_is_packable(i) for i in range(4)] == [False, False, True, True]
    with torch.no_grad():
        ref = port_generator(gen_flat)(lats, noise)
        got = packed(lats, noise)
    assert got.shape == ref.shape == (2, 3, 64, 64)
    assert max_rel_err(got.numpy(), ref.numpy()) < GEN_RTOL


def test_packed_generator_matches_jax(gen_flat, monkeypatch):
    """The port's packed decode against the JAX package's packed decode."""
    monkeypatch.setattr(sg2, "_PACKED_MIN_RES", 32)
    monkeypatch.setattr(j_sg2, "_PACKED_MIN_RES", 32)
    monkeypatch.setattr(j_sg2, "_PACKED_TAIL", True)
    lats, noise = gen_inputs()
    ref = j_sg2.Generator(n_mlp=2, **GEN_CFG).apply(
        {"params": jax_tree(gen_flat)},
        jnp.asarray(lats), noise=[jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise],
        packed=True)
    with torch.no_grad():
        got = port_generator(gen_flat, packed_tail=True)(T(lats), [T(n) for n in noise])
    assert max_rel_err(got.permute(0, 2, 3, 1).numpy(), ref) < GEN_RTOL


def test_stage_operands_match_jax(gen_flat, monkeypatch):
    """The operands the port hands its whole-stage kernel -- K1 and K2 built
    from the OIHW he-scaled weights, the per-sample k3sr with the style
    scale folded in, the packed noise, the tiled scales and biases -- are
    those the JAX package hands its own, at both packed stages."""
    seen = {"port": [], "jax": []}

    def recorder(side, reference):
        def record(*args):
            seen[side].append([np.asarray(a) for a in args])
            return reference(*args)
        return record

    monkeypatch.setattr(sg2, "_PACKED_MIN_RES", 32)
    monkeypatch.setattr(sg2, "fused_packed_stage",
                        recorder("port", packed_conv.packed_stage_reference))
    monkeypatch.setattr(j_sg2, "_PACKED_MIN_RES", 32)
    monkeypatch.setattr(j_sg2, "_PALLAS_PAIR", True)
    monkeypatch.setenv("OGI_PALLAS_STAGE", "1")
    monkeypatch.setattr(j_sg2, "pallas_stage_supported", lambda *a: True)
    monkeypatch.setattr(j_sg2, "fused_packed_stage",
                        recorder("jax", j_pk.packed_stage_reference))
    lats, noise = gen_inputs()
    j_sg2.Generator(n_mlp=2, **GEN_CFG).apply(
        {"params": jax_tree(gen_flat)}, jnp.asarray(lats),
        noise=[jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise], packed=True)
    with torch.no_grad():
        port_generator(gen_flat, packed_tail=True, tail_kernel="stage")(
            T(lats), [T(n) for n in noise])
    assert len(seen["port"]) == len(seen["jax"]) == 2
    names = ["x", "n1", "n2", "skip", "k1", "s1", "d1", "b1", "k2", "s2", "d2",
             "b2", "k3sr", "b3", "k4"]
    for port_args, jax_args in zip(seen["port"], seen["jax"]):
        for name, p, j in zip(names, port_args, jax_args):
            assert p.shape == j.shape, name
            # x and skip come out of the decode before the stage
            tol = GEN_RTOL if name in ("x", "skip") else PACK_TOL
            assert max_rel_err(p, j) < tol, (name, max_rel_err(p, j))


# ----------------------------------------------------------- whole slice


@pytest.fixture(scope="module")
def slice_case():
    """JAX's 512px slice with its packed tail through the pair kernel
    (OGI_PALLAS=1, interpret mode), and the inputs it ran on."""
    x0 = jnp.zeros((1, 512, 512, 3), jnp.float32)
    flat = with_style_mlp(fill_params(init_shapes(JArch(**SLICE_CFG), x0, mod_size=256), seed=0),
                          JArch(**SLICE_CFG), 512, seed=1)
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (2, 512, 512, 3)).astype(np.float32)
    noise = [rs.randn(*s).astype(np.float32)
             for s in OODFaceGANE4E(**SLICE_CFG).generator.noise_shapes(2)]
    jarch = JArch(**SLICE_CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sg2, "_PALLAS_PAIR", True)
        mp.setattr(j_sg2, "_PACKED_TAIL", True)
        ref = jax.jit(lambda p, x, n: jarch.apply({"params": p}, x, mod_size=256,
                                                  noise=n))(
            jax_tree(flat), jnp.asarray(x),
            [jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise])
    return flat, x, noise, jax.tree_util.tree_map(np.asarray, ref)


@pytest.mark.parametrize("tail_kernel", ["none", "pair"])
def test_whole_slice_packed_tail_matches_jax(slice_case, tail_kernel):
    flat, x, noise, ref = slice_case
    arch = load_port(OODFaceGANE4E(**SLICE_CFG, packed_tail=True,
                                   tail_kernel=tail_kernel), flat)
    with torch.no_grad():
        out = arch(T(x), mod_size=256, noise=[T(n) for n in noise])
    for k in ("image", "mask", "gen_image", "lats"):
        assert tuple(out[k].shape) == ref[k].shape, k
        assert max_rel_err(out[k].numpy(), ref[k]) < SLICE_RTOL, k
    for k in (1, 2, 3, 4):
        assert max_rel_err(out["aligns"][k].numpy(), ref["aligns"][k]) < SLICE_RTOL


def test_bridge_loads_strictly_into_packed_arch(slice_case):
    state, leftovers = from_jax_params(slice_case[0])
    assert leftovers == []
    arch = OODFaceGANE4E(**SLICE_CFG, packed_tail=True, tail_kernel="stage")
    arch.load_state_dict(state, strict=True)
    assert set(arch.state_dict()) == set(OODFaceGANE4E(**SLICE_CFG).state_dict())


def test_engine_tail_options():
    opt = {"network_g": {"type": "ood_faceGAN_e4e", "out_size": 64,
                         "channel_multiplier": 1, "narrow": 0.125,
                         "encoder_num_layers": 4}}
    gen = InversionEngine(opt, device="cpu").net.generator
    assert (gen.packed_tail, gen.tail_kernel) == (False, "none")
    gen = InversionEngine(opt, device="cpu", packed_tail=True,
                          tail_kernel="stage").net.generator
    assert (gen.packed_tail, gen.tail_kernel) == (True, "stage")
    with pytest.raises(ValueError, match="needs packed_tail"):
        InversionEngine(opt, device="cpu", tail_kernel="pair")
    with pytest.raises(ValueError, match="not in"):
        InversionEngine(opt, device="cpu", packed_tail=True, tail_kernel="fused")
