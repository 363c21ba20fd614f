"""The port's single-process multi-device entries on the CPU: meshes and
replicas (parallel/mesh.py), the H-banded decode (parallel/spatial.py,
`InversionEngine.invert_spatial`), the data-sharded inversions
(`invert_batch_sharded`, `invert_batch_perkey_sharded`) and
`BatchingServer(mesh=)`, against JAX's and against the port's unsharded
paths. A mesh's slots repeat the CPU, as JAX's tests use the session's
virtual CPU devices.

Tolerances: the banded decode (through a conditioned stage and through the
packed tail too) against JAX's `spatial_sharding` output within JAX's own
test's rtol / atol 2e-4 (tests/test_parallel.py), and against the port's
unbanded forward within the same; band gradients against the unbanded ones
within 1e-4 of max|ref|; `invert_batch_sharded`
against JAX's within the slice's 1e-3 of max|ref| (tests/test_torch_arch.py);
the per-key sharded entry and the server's replies bit for bit the
unsharded ones (the port's contract, C2)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve import OPT, images, serve
from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err,
                          with_style_mlp)
from torch_parity import release_freed_memory  # noqa: F401 (autouse)

from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu.infer import InversionEngine as JEngine
from ood_gan_inversion_tpu.nn.stylegan2 import Generator as JGenerator
from ood_gan_inversion_tpu.nn.stylegan2 import NoiseInjection as JNoiseInjection
from ood_gan_inversion_tpu.parallel import make_mesh as j_make_mesh
from ood_gan_inversion_tpu.parallel import replicate_sharding, spatial_sharding
from ood_gan_inversion_tpu_torch.archs.ood_e4e import OODFaceGANE4E
from ood_gan_inversion_tpu_torch.convert import from_jax_params
from ood_gan_inversion_tpu_torch.infer import InversionEngine
from ood_gan_inversion_tpu_torch.nn.layers import init_weights
from ood_gan_inversion_tpu_torch.nn import stylegan2 as sg2
from ood_gan_inversion_tpu_torch.nn.stylegan2 import Generator, ModulatedConv2d, NoiseInjection
from ood_gan_inversion_tpu_torch.ops.upfirdn2d import make_kernel, upsample2x
from ood_gan_inversion_tpu_torch.parallel import Replicas, make_mesh, spatial, split_batch
from ood_gan_inversion_tpu_torch.serve import BatchingServer

SP_TOL = 2e-4
SLICE_RTOL = 1e-3
# tests/test_parallel.py's spatial case (64px, n_mlp 2, channel_multiplier 1,
# ModSize 32, cycle_align 1), with the 4-layer encoder trunk and a quarter of
# the widths
SP_CFG = dict(out_size=64, style_dim=512, n_mlp=2, channel_multiplier=1, narrow=0.25,
              encoder_num_layers=4, enable_modulation=True, modulation_type="NOISE",
              warp_scale=0.08, cycle_align=1, blend_with_gen=True)


def cpu_mesh(n, axes=("data",)):
    return make_mesh(["cpu"] * n, axes=axes)


# ------------------------------------------------------------- meshes
def test_mesh_and_split():
    m = make_mesh(["cpu"] * 4, axes=("data", "sp"), shape=(2, 2))
    assert m.shape == {"data": 2, "sp": 2} and m.size == 4
    assert m.axis_names == ("data", "sp") and m.devices.shape == (2, 2)
    assert m.slots == [torch.device("cpu")] * 4
    x = torch.arange(8.0).reshape(4, 2)
    parts = split_batch(x, cpu_mesh(2))
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    with pytest.raises(ValueError, match="does not divide"):
        split_batch(x, cpu_mesh(3))


def test_replicas_one_per_device_and_refreshed():
    net = torch.nn.Linear(2, 2)
    reps = Replicas(net, "cpu")
    assert reps.get("cpu") is net and reps.copies() == 0
    a = reps.get("cpu:0")
    assert a is not net and reps.get("cpu:0") is a and reps.copies() == 1
    with torch.no_grad():
        net.weight += 1.0
    reps.version += 1
    b = reps.get("cpu:0")
    assert b is not a and torch.equal(b.weight, net.weight) and reps.copies() == 1


# ------------------------------------------------------------- the banded decode
def _ops():
    """(name, op, halo) of every op the banded stage gives a halo: the
    upsampling modulated conv, the modulated 3x3 conv, ToRGB's skip
    upsample."""
    up = init_weights(ModulatedConv2d(6, 5, 3, style_dim=4, upsample=True), 0)
    same = init_weights(ModulatedConv2d(6, 5, 3, style_dim=4), 1)
    s = torch.randn(1, 4, generator=torch.Generator().manual_seed(2))
    kernel = make_kernel((1, 3, 3, 1))
    return [("upconv", lambda x: up(x, s), spatial.halo_rows(6, 3, up=2), 2),
            ("conv3x3", lambda x: same(x, s), spatial.halo_rows(3, 1), 1),
            ("skip_upsample", lambda x: upsample2x(x, kernel), spatial.halo_rows(4, 2, up=2), 2)]


@pytest.mark.parametrize("name", ["upconv", "conv3x3", "skip_upsample"])
def test_halo_rows_of_each_op(name):
    """Each op's halo, derived from its padding, is the rows its output bands
    read: the output rows of input row a's band ([up a, up a + up)) change
    exactly when an input row in [a - top, a + bottom] does; the banded op
    (4 bands of 2 rows, every halo taken across a band edge) equals the op on the whole image, and one row less
    of halo on either side does not."""
    _, op, halo, up = next(o for o in _ops() if o[0] == name)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 6 if name != "skip_upsample" else 3, 8, 8, generator=g,
                    dtype=torch.float64 if name == "skip_upsample" else torch.float32)
    with torch.no_grad():
        full = op(x)
        top, bottom = halo
        changed = []
        for row in range(8):
            xp = x.clone()
            xp[:, :, row] += 1.0
            changed.append((op(xp) - full).abs().amax(dim=(0, 1, 3)) > 0)
        for a in range(8):
            reads = [row for row in range(8) if changed[row][up * a:up * a + up].any()]
            assert reads == list(range(max(a - top, 0), min(a + bottom, 7) + 1)), (a, reads)
        parts = list(x.chunk(4, dim=2))
        banded = torch.cat([spatial._halo_apply(parts, i, op, halo, up) for i in range(4)], 2)
        torch.testing.assert_close(banded, full, rtol=1e-6, atol=1e-6)
        for short in ((top - 1, bottom), (top, bottom - 1)):
            cut = torch.cat([spatial._halo_apply(parts, i, op, short, up) for i in range(4)], 2)
            assert not torch.allclose(cut, full, rtol=1e-3, atol=1e-3), short


@pytest.fixture(scope="module")
def sp_case():
    """The spatial case's seeded JAX tree, its input and noise, and JAX's
    spatially sharded outputs (4 virtual devices, min_h 32 and 16; JAX's
    own test holds the first to its unsharded forward)."""
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    # traced at ModSize 64, so that the tree holds both SAMM blocks the port builds
    flat = fill_params(init_shapes(JArch(**SP_CFG), x, mod_size=64), seed=3)
    rs = np.random.RandomState(4)
    img = (rs.rand(1, 64, 64, 3) * 0.6 - 0.3).astype(np.float32)
    arch = OODFaceGANE4E(**SP_CFG)
    noise = [rs.randn(*s).astype(np.float32) for s in arch.generator.noise_shapes(1)]
    jarch = JArch(**SP_CFG)

    def fwd(p, xx):
        return jarch.apply({"params": p}, xx, mod_size=32,
                           noise=[jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise])["image"]

    params = jax_tree(flat)
    mesh = j_make_mesh(jax.devices()[:4], axes=("sp",))
    out = {}
    for min_h in (32, 16):
        with spatial_sharding(mesh, min_h=min_h):
            out[min_h] = np.asarray(jax.jit(fwd)(
                jax.device_put(params, replicate_sharding(mesh)),
                jax.device_put(jnp.asarray(img), replicate_sharding(mesh))))
    full = with_style_mlp(flat, jarch, 512, seed=5)
    return {"flat": full, "img": img, "noise": noise, "jax_sp": out[32], "jax_sp16": out[16]}


def port_arch(case):
    arch = OODFaceGANE4E(**SP_CFG)
    return load_port(arch, case["flat"])


def test_spatial_decode_matches_jax(sp_case):
    """tests/test_parallel.py's spatial case in the port: 4 slots, min_h 32
    (the 64px stage banded, 16 rows a band, its input's 8-row bands taking
    their halos across every band edge), against JAX's spatial_sharding
    output and the port's unbanded forward."""
    arch = port_arch(sp_case)
    x = torch.from_numpy(sp_case["img"])
    noise = [torch.from_numpy(n) for n in sp_case["noise"]]
    calls = []
    stage = spatial.banded_stage

    def spy(gen, idx, *a):
        calls.append(idx)
        return stage(gen, idx, *a)

    with torch.no_grad():
        plain = arch(x, mod_size=32, noise=noise)["image"].numpy()
        spatial.banded_stage = spy
        try:
            with spatial.banding(cpu_mesh(4, ("sp",)), Replicas(arch, "cpu"), min_h=32):
                banded = arch(x, mod_size=32, noise=noise)["image"].numpy()
        finally:
            spatial.banded_stage = stage
    assert calls == [3]                   # the 64px stage; the 32px one holds SAMM
    np.testing.assert_allclose(banded, sp_case["jax_sp"], rtol=SP_TOL, atol=SP_TOL)
    np.testing.assert_allclose(banded, plain, rtol=SP_TOL, atol=SP_TOL)


def test_invert_spatial_and_refusals(sp_case, monkeypatch):
    """The engine's entry against its invert (the same seed's noise) on 2 and
    4 slots. At min_h 16 the 16px stage is banded and the 32px stage, which
    holds SAMM, takes its input gathered (it was refused before banding
    reached conditioned stages): the arch's forward against JAX's
    spatial_sharding output at min_h 16 and the unbanded forward, and the
    engine's entry against invert. The phase-packed tail (refused before
    too) runs banded: with the packing threshold lowered to 64px (as
    tests/test_torch_packed.py lowers it), the 64px stage packed, each
    tail_kernel's engine against its own invert."""
    state, _ = from_jax_params(sp_case["flat"])
    opt = {"network_g": {"type": "ood_faceGAN_e4e", **SP_CFG, "ModSize": 32}}
    eng = InversionEngine(opt, params=state, device="cpu")
    img = sp_case["img"][0] + 0.3
    ref = eng.invert(img, seed=2)
    for n in (2, 4):
        for min_h in (32, 16):
            out = eng.invert_spatial(img, seed=2, mesh=cpu_mesh(n, ("sp",)), min_h=min_h)
            for k in ("image", "mask", "gen_image"):
                assert out[k].device == eng.device
                torch.testing.assert_close(out[k], ref[k], rtol=SP_TOL, atol=SP_TOL)
    arch = port_arch(sp_case)
    x = torch.from_numpy(sp_case["img"])
    noise = [torch.from_numpy(n) for n in sp_case["noise"]]
    with torch.no_grad():
        plain = arch(x, mod_size=32, noise=noise)["image"].numpy()
        with spatial.banding(cpu_mesh(4, ("sp",)), Replicas(arch, "cpu"), min_h=16):
            banded = arch(x, mod_size=32, noise=noise)["image"].numpy()
    np.testing.assert_allclose(banded, sp_case["jax_sp16"], rtol=SP_TOL, atol=SP_TOL)
    np.testing.assert_allclose(banded, plain, rtol=SP_TOL, atol=SP_TOL)
    monkeypatch.setattr(sg2, "_PACKED_MIN_RES", 64)
    calls = []
    stage = spatial.banded_packed_stage

    def spy(gen, idx, *a):
        calls.append(idx)
        return stage(gen, idx, *a)

    monkeypatch.setattr(spatial, "banded_packed_stage", spy)
    for tail_kernel in ("none", "pair", "stage"):
        packed = InversionEngine(opt, params=state, device="cpu", packed_tail=True,
                                 tail_kernel=tail_kernel)
        ref = packed.invert(img, seed=2)
        for n in (2, 4):
            out = packed.invert_spatial(img, seed=2, mesh=cpu_mesh(n, ("sp",)), min_h=32)
            for k in ("image", "mask", "gen_image"):
                torch.testing.assert_close(out[k], ref[k], rtol=SP_TOL, atol=SP_TOL)
    assert calls == [3] * 6


def test_band_gradients_reach_the_trained_parameters(sp_case, monkeypatch):
    """Under grad mode a band on a second device (the slot "cpu:0", a
    device of its own for the mesh, whose replica would be a deep copy)
    computes with the arch's parameters moved into the graph: the
    gradients of a loss of the banded forward, the path-length kind (a
    gradient of the latents' gradient) included, equal the unbanded ones;
    with the bands on the replicas instead, the stages' gradients miss."""
    arch = port_arch(sp_case)
    x = torch.from_numpy(sp_case["img"])
    noise = [torch.from_numpy(n) for n in sp_case["noise"]]
    lats = arch.encode(x.permute(0, 3, 1, 2), noise=arch.split_noise(noise)[0])[0]
    lats = lats.detach().requires_grad_()
    cot = torch.from_numpy(np.random.RandomState(9).randn(1, 3, 64, 64).astype(np.float32))
    params = list(arch.generator.parameters())

    def grads(mesh=None):
        feats = [f.detach() for f in arch.encode(x.permute(0, 3, 1, 2),
                                                 noise=arch.split_noise(noise)[0])[1]]

        def decode():
            return arch.decode_samm(lats, feats, x.permute(0, 3, 1, 2), 32,
                                    arch.split_noise(noise)[1])["image"]

        if mesh is None:
            img = decode()
        else:
            with spatial.banding(mesh, Replicas(arch, "cpu"), min_h=32):
                img = decode()
        (gl,) = torch.autograd.grad(img, lats, cot, create_graph=True)
        loss = (img * cot).sum() + gl.square().sum()
        return torch.autograd.grad(loss, params, allow_unused=True)

    ref = grads()
    mesh = make_mesh(["cpu", "cpu:0"], axes=("sp",))
    got = grads(mesh)
    err = max(max_rel_err(g.numpy(), r.numpy()) for g, r in zip(got, ref) if r is not None)
    assert err < 1e-4
    monkeypatch.setattr(spatial._State, "twin", lambda st, m, dev: st.replicas.get(dev)
                        .get_submodule(st._names[id(m)]))
    on_copies = grads(mesh)
    monkeypatch.undo()
    err = max(max_rel_err(g.numpy(), r.numpy()) for g, r in zip(on_copies, ref)
              if r is not None and r.abs().max() > 0)
    assert err > 0.1


def test_banded_packed_generator_matches_jax(monkeypatch):
    """tests/test_parallel.py's packed-stage spatial case (512px
    Generator, channel_multiplier 1, narrow 0.5, min_h 128, JAX's XLA
    packed tail at 512px on 4 devices) through the port's packed tail with
    each tail_kernel on 2 and 4 slots: the 128 and 256px stages banded,
    the 512px stage packed and banded (its bands' windows 2 coarse rows
    past their own, clipped at the image's border), against JAX's
    spatial_sharding output and the port's unbanded packed decode."""
    jgen = JGenerator(size=512, style_dim=512, n_mlp=2, channel_multiplier=1, narrow=0.5)
    rs = np.random.RandomState(11)
    lat = (rs.randn(1, 16, 512) * 0.3).astype(np.float32)
    gen = Generator(512, 512, 1, 0.5, n_mlp=2)
    noise = [rs.randn(*s).astype(np.float32) for s in gen.noise_shapes(1)]
    flat = with_style_mlp(fill_params(init_shapes(jgen, jnp.asarray(lat)), seed=12), jgen, 512,
                          seed=13)
    mesh = j_make_mesh(jax.devices()[:4], axes=("sp",))
    jnoise = [jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise]
    with spatial_sharding(mesh, min_h=128):
        ref = np.asarray(jax.jit(lambda p, l: jgen.apply({"params": p}, l, noise=jnoise))(
            jax.device_put(jax_tree(flat), replicate_sharding(mesh)),
            jax.device_put(jnp.asarray(lat), replicate_sharding(mesh))))
    calls = []
    stage = spatial.banded_packed_stage

    def spy(g, idx, *a):
        calls.append(idx)
        return stage(g, idx, *a)

    monkeypatch.setattr(spatial, "banded_packed_stage", spy)
    tn = [torch.from_numpy(n) for n in noise]
    for tail_kernel in ("none", "pair", "stage"):
        gen = load_port(Generator(512, 512, 1, 0.5, n_mlp=2, packed_tail=True,
                                  tail_kernel=tail_kernel), flat, prefix="generator/")
        with torch.no_grad():
            plain = gen(torch.from_numpy(lat), tn).permute(0, 2, 3, 1).numpy()
            for n in (2, 4):
                with spatial.banding(cpu_mesh(n, ("sp",)), Replicas(gen, "cpu"), min_h=128):
                    got = gen(torch.from_numpy(lat), tn).permute(0, 2, 3, 1).numpy()
                np.testing.assert_allclose(got, ref, rtol=SP_TOL, atol=SP_TOL)
                np.testing.assert_allclose(got, plain, rtol=SP_TOL, atol=SP_TOL)
    assert calls == [6] * 6


# ------------------------------------------------------------- data-sharded entries
@pytest.fixture(scope="module")
def engine():
    eng = InversionEngine(OPT, device="cpu")
    for m in eng.net.modules():        # make the noise matter
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.3)
    return eng


KEYS = ("image", "gen_image", "mask", "lats")


@pytest.fixture(scope="module")
def perkey(engine):
    imgs, seeds = images(4, 11), [3, 4, 5, 3]
    return imgs, seeds, engine.invert_batch_perkey(imgs, seeds)


@pytest.mark.parametrize("n", [2, 4])
def test_invert_batch_perkey_sharded_bit_for_bit(engine, perkey, n):
    imgs, seeds, ref = perkey
    got = engine.invert_batch_perkey_sharded(imgs, seeds, cpu_mesh(n))
    assert set(got) == set(ref)
    for k in KEYS:
        assert torch.equal(got[k], ref[k]), k
    for a in ref["aligns"]:
        assert torch.equal(got["aligns"][a], ref["aligns"][a]), a
    sub = engine.invert_batch_perkey_sharded(imgs, seeds, cpu_mesh(n), outputs=("image",))
    assert set(sub) == {"image"} and torch.equal(sub["image"], ref["image"])
    with pytest.raises(ValueError, match="does not divide"):
        engine.invert_batch_perkey_sharded(imgs[:3], seeds[:3], cpu_mesh(2))


def test_replicas_refresh_after_apply_direction(engine):
    """A slot on a second device gets a replica of the weights, made at its
    first use and made again after apply_direction: the sharded replies
    equal the unsharded ones before and after."""
    eng = InversionEngine(OPT, device="cpu")
    eng.net.load_state_dict(engine.net.state_dict())
    mesh = make_mesh(["cpu", "cpu:0"])
    imgs, seeds = images(2, 12), [0, 1]
    before = eng.invert_batch_perkey_sharded(imgs, seeds, mesh)
    assert torch.equal(before["image"], eng.invert_batch_perkey(imgs, seeds)["image"])
    assert eng.replicas.copies() == 1
    old = eng.replicas.get("cpu:0")
    eng.apply_direction(np.full((eng.net.style_cnt, 512), 0.2, np.float32))
    after = eng.invert_batch_perkey_sharded(imgs, seeds, mesh)
    assert eng.replicas.get("cpu:0") is not old and eng.replicas.copies() == 1
    assert torch.equal(after["image"], eng.invert_batch_perkey(imgs, seeds)["image"])
    assert not torch.equal(after["image"][1], before["image"][1])


def test_server_mesh_replies_match_lone_requests(engine):
    """BatchingServer(mesh=) (tests/test_serve.py's mesh case): a batch pads
    up to the mesh size, and each reply is the lone request's bit for
    bit."""
    srv = BatchingServer(engine, max_batch=8, max_wait_ms=200.0, mesh=cpu_mesh(4))
    assert [srv._batch_size_for(n) for n in (1, 3, 4, 5, 8)] == [4, 4, 4, 8, 8]
    imgs = images(3, 7)
    outs = serve(srv, imgs)
    assert srv.stats["requests"] == 3 and srv.stats["split"] == 0
    assert srv.stats["padded"] == 4 * srv.stats["batches"] - 3
    for im, (image, mask) in zip(imgs, outs):
        ref = engine.invert(im, seed=0)
        np.testing.assert_array_equal(image, ref["image"][0].numpy())
        np.testing.assert_array_equal(mask, ref["mask"][0].numpy())


def test_invert_batch_sharded_matches_jax():
    """invert_batch_sharded on 2 slots against JAX's on 2 virtual devices,
    tests/test_infer.py's 64px engine (with the 4-layer trunk and a quarter
    of the widths), the same weights and the same noise stream (the port's
    draw for the batch, fed to JAX's noise injections); and against the
    port's invert_batch, bit for bit."""
    cfg = {"type": "ood_faceGAN_e4e", "out_size": 64, "channel_multiplier": 1,
           "cycle_align": 1, "warp_scale": 0.08, "encoder_num_layers": 4, "narrow": 0.25}
    opt = {"network_g": {**cfg, "ModSize": 64}}
    jcfg = {k: v for k, v in cfg.items() if k != "type"}
    flat = fill_params(init_shapes(JArch(**jcfg), jnp.zeros((1, 64, 64, 3)), mod_size=64),
                       seed=6)
    state, _ = from_jax_params(with_style_mlp(flat, JArch(**jcfg), 512, seed=7))
    eng = InversionEngine(opt, params=state, device="cpu")
    imgs = images(2, 9)
    got = eng.invert_batch_sharded(imgs, seed=1, mesh=cpu_mesh(2))
    ref = eng.invert_batch(imgs, seed=1)
    for k in KEYS:
        assert torch.equal(got[k], ref[k]), k
    noise = eng.net.make_noise(2, torch.Generator().manual_seed(1), torch.device("cpu"))
    feed = iter([jnp.asarray(n.numpy().transpose(0, 2, 3, 1)) for n in noise])

    def fed(next_fun, args, kwargs, context):
        if (isinstance(context.module, JNoiseInjection) and context.method_name == "__call__"
                and kwargs.get("noise", args[1] if len(args) > 1 else None) is None):
            return next_fun(args[0], noise=next(feed))
        return next_fun(*args, **kwargs)

    jeng = JEngine(opt, params=jax_tree(flat))
    with fnn.intercept_methods(fed):
        jout = jeng.invert_batch_sharded(imgs, jax.random.PRNGKey(0),
                                         mesh=j_make_mesh(jax.devices()[:2]))
    assert next(feed, None) is None
    for k in ("image", "mask", "gen_image"):
        assert max_rel_err(got[k].numpy(), np.asarray(jout[k])) < SLICE_RTOL, k
