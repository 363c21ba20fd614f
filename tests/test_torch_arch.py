"""The whole slice -- the E4E inversion arch, the weights bridge and the
inversion engine of the PyTorch port -- against the JAX package on the CPU.

Tolerance for the slice: 1e-3 of max|ref|. Both sides compute in float32,
but the decode runs ~50 convolution layers after the encoder's, the JAX
side runs its 512px stage phase-packed (other summation order), and the
SAMM flows move sample positions, which turns small differences in a flow
into larger ones in the warped feature."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import fill_params, init_shapes, jax_tree, load_port, max_rel_err

from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu_torch.archs.ood_e4e import OODFaceGANE4E
from ood_gan_inversion_tpu_torch.convert import from_jax_params, port_key
from ood_gan_inversion_tpu_torch.infer import InversionEngine
from ood_gan_inversion_tpu_torch.nn.stylegan2 import NoiseInjection

SLICE_RTOL = 1e-3
# all four SAMM scales (32..256px) and one >=512px generator stage
CFG = dict(out_size=512, channel_multiplier=1, narrow=0.125,
           encoder_num_layers=4, cycle_align=2, warp_scale=0.08)
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_flat():
    x = jnp.zeros((1, 512, 512, 3), jnp.float32)
    flat = fill_params(init_shapes(JArch(**CFG), x, mod_size=256), seed=0)
    assert np.abs(flat["delta_latent"]).max() > 0
    return flat


def test_whole_slice_matches_jax(jax_flat):
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, (2, 512, 512, 3)).astype(np.float32)
    arch = load_port(OODFaceGANE4E(**CFG), jax_flat)
    noise = [rs.randn(*s).astype(np.float32)
             for s in arch.generator.noise_shapes(2)]
    jarch = JArch(**CFG)
    ref = jax.jit(lambda p, x, n: jarch.apply({"params": p}, x, mod_size=256,
                                              noise=n))(
        jax_tree(jax_flat), jnp.asarray(x),
        [jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise])
    with torch.no_grad():
        out = arch(torch.from_numpy(x), mod_size=256,
                   noise=[torch.from_numpy(n) for n in noise])
    for k in ("image", "mask", "gen_image", "lats"):
        assert out[k].shape == ref[k].shape, k
        assert max_rel_err(out[k].numpy(), ref[k]) < SLICE_RTOL, k
    for k in (1, 2, 3, 4):
        assert max_rel_err(out["aligns"][k].numpy(), ref["aligns"][k]) < SLICE_RTOL
    m = out["mask"].numpy()
    assert m.min() >= 0.0 and m.max() <= 1.0


def test_bridge_consumes_every_leaf_and_loads_strictly(jax_flat):
    state, leftovers = from_jax_params(jax_flat)
    assert leftovers == []
    arch = OODFaceGANE4E(**CFG)
    arch.load_state_dict(state, strict=True)
    assert set(state) == set(arch.state_dict())
    np.testing.assert_array_equal(      # HWIO -> OIHW
        arch.encoder.trunk.input_conv.weight.detach().numpy(),
        jax_flat["encoder/trunk/input_conv/weight"].transpose(3, 2, 0, 1))
    # a subtree the port has no module for is reported, not dropped silently
    _, left = from_jax_params({**jax_flat,
                               "generator/style_0/weight": np.zeros((2, 2))})
    assert left == ["generator/style_0/weight"]
    assert port_key("encoder/trunk/body_1/norm1/norm/var") == \
        "encoder.trunk.body.1.norm1.running_var"


def small_opt():
    return {"network_g": {"type": "ood_faceGAN_e4e", "out_size": 64,
                          "channel_multiplier": 1, "narrow": 0.125,
                          "encoder_num_layers": 4, "warp_scale": 0.08,
                          "cycle_align": 2, "ModSize": 256,
                          "stage": "Inference"}}


def test_engine_per_seed_determinism_across_batch_slots():
    eng = InversionEngine(small_opt(), seed=3, device="cpu")
    for m in eng.net.modules():        # make the noise matter
        if isinstance(m, NoiseInjection):
            m.weight.data.fill_(0.5)
    rs = np.random.RandomState(2)
    imgs = [rs.rand(80, 80, 3).astype(np.float32) for _ in range(3)]
    alone = eng.invert(imgs[0], seed=7)
    # decoded one by one: bit-identical to the lone request
    split = eng.invert_batch_perkey_split([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    assert split["image"].shape == (3, 64, 64, 3)
    assert split["aligns"][2].shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(split["image"][2].numpy(), alone["image"][0].numpy())
    np.testing.assert_array_equal(split["mask"][2].numpy(), alone["mask"][0].numpy())
    batch = eng.invert_batch_perkey([imgs[1], imgs[2], imgs[0]], [8, 9, 7])
    assert batch["image"].shape == (3, 64, 64, 3)
    assert batch["aligns"][2].shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(batch["image"][2].numpy(), alone["image"][0].numpy())
    np.testing.assert_array_equal(batch["mask"][2].numpy(), alone["mask"][0].numpy())
    other = eng.invert(imgs[0], seed=8)
    assert not torch.equal(other["image"], alone["image"])
    sub = eng.invert_batch_perkey(imgs[:2], [1, 2], outputs=("image", "mask"))
    assert set(sub) == {"image", "mask"}


def test_engine_defaults_to_cuda_and_applies_directions():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InversionEngine(small_opt())
    eng = InversionEngine(small_opt(), seed=0, device="cpu")
    d = np.full((1, 10, 512), 0.5, np.float32)
    eng.apply_direction(d)
    np.testing.assert_array_equal(eng.net.delta_latent.detach().numpy(), d)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "ood_gan_inversion_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "prof_torch_inversion.py"]
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "ood_gan_inversion_tpu"), (f, name)
