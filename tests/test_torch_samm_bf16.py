"""The port's bfloat16-operand SAMM options of a float32 arch (nn/samm.py:
`samm_conv_bf16`, `samm_warp_bf16`, `samm_gather_bf16`) against the JAX
package on the CPU with the flag each mirrors set through its module
constant, read when JAX traces: `ops.pallas_kernels._CONV_BF16`
(OGI_SAMM_CONV_BF16=1), `nn.samm._MXU_WARP` = "1" with
`_MXU_WARP_CAST_BF16` "1" or "all" (OGI_MXU_WARP=1, OGI_MXU_WARP_BF16),
`ops.grid_sample._MODE` = "gather4bf16" (OGI_GRIDSAMPLE). On the CPU JAX's
warp kernel falls back to its reference, so both sides compute the
plain versions, JAX op by op (not jitted, as the port computes them).

  * the warp cast's gate against JAX's own arithmetic (mxu_warp_supported,
    max_disp_px) at every SAMM scale of the 1024px model and at narrower
    widths and larger flows;
  * one SAMM block at the 1024px model's 128px scale (C 256), where
    "fit" casts: both take the cast branch, and the outputs agree within
    one bfloat16 step (2^-7) of max|ref|: the flows differ in float32
    rounding, so a few elements round to the neighbouring bfloat16 value;
  * the float32 E4E slice (64px, a quarter of the widths, ModSize 64,
    cycle_align 2) with each option. The warp cases lower the cast's floor
    from 128 to 32px on both sides (`WARP_BF16_MIN`, JAX's
    `_MXU_WARP_MIN`), so that the 32px block (C 128) takes it; "fit" casts
    there at warp_scale 0.75 (a flow bound of 14 px), "all" at 0.08.

The options make the slice ill-conditioned: a value that the option
rounds to bfloat16 moves by a whole bfloat16 step (2^-8 of it) when a
float32 difference of 1e-7 crosses a rounding boundary, and the next align
cycle's flows carry that on. So both sides' outputs move when the input
moves by NUDGE (1e-6) of itself: at these weights JAX's by up to 4.7e-3
of max|ref| with "fit" (gen_image, 4 seeds), 1.4e-3 with samm_gather_bf16,
5.8e-4 with "all", and the port's by as much (`python
tests/test_torch_samm_bf16.py` prints every reading). The port's float32
sums differ from JAX's by more than 1e-6. The slice is therefore held, key
by key, within SLICE_RTOL of max|ref| or, where that is larger, within the
sum of the two sides' own moves under a nudge (the most over
NUDGE_SEEDS); and closer to JAX's output with the option than JAX's
output without it, by its mean error (SLICE_MEAN_FRACTION of the
option's own mean effect)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import release_freed_memory  # noqa: F401 (autouse)
from torch_parity import (fill_params, init_shapes, jax_tree, load_port, max_rel_err, nchw,
                          nhwc, with_style_mlp)

from ood_gan_inversion_tpu.archs.ood_e4e import OODFaceGANE4E as JArch
from ood_gan_inversion_tpu.nn import samm as j_samm
from ood_gan_inversion_tpu.ops import grid_sample as j_gs
from ood_gan_inversion_tpu.ops import pallas_kernels as j_pk
from ood_gan_inversion_tpu.ops import pallas_warp as j_pw
from ood_gan_inversion_tpu_torch.archs import build_network
from ood_gan_inversion_tpu_torch.archs.ood_e4e import OODFaceGANE4E
from ood_gan_inversion_tpu_torch.infer import InversionEngine
from ood_gan_inversion_tpu_torch.nn import samm
from ood_gan_inversion_tpu_torch.ops import warp_blend as p_wb

SLICE_RTOL = 1e-3
BLOCK_RTOL = 2.0 ** -7
SLICE_MEAN_FRACTION = 0.5
# the nudge of the slice's input that measures its conditioning
NUDGE, NUDGE_SEEDS = 1e-6, (100, 101)
# (H = W, C) of the 1024px model's SAMM scales at channel_multiplier 2
SAMM_SCALES = [(32, 512), (64, 512), (128, 256), (256, 128)]
CFG = dict(out_size=64, channel_multiplier=1, narrow=0.25, encoder_num_layers=4,
           cycle_align=2, warp_scale=0.08)
# option -> (the port's arch keys, JAX's module constants, warp_scale)
OPTIONS = {
    "conv_bf16": ({"samm_conv_bf16": True}, [(j_pk, "_CONV_BF16", True)], 0.08),
    "gather_bf16": ({"samm_gather_bf16": True}, [(j_gs, "_MODE", "gather4bf16")], 0.08),
    "warp_fit": ({"samm_warp_bf16": "fit"},
                 [(j_samm, "_MXU_WARP", "1"), (j_samm, "_MXU_WARP_CAST_BF16", "1")], 0.75),
    "warp_all": ({"samm_warp_bf16": "all"},
                 [(j_samm, "_MXU_WARP", "1"), (j_samm, "_MXU_WARP_CAST_BF16", "all")], 0.08),
}


def jax_casts(mode, h, c, scale):
    """JAX's SPMWarp branch for a float32 feature with OGI_MXU_WARP=1:
    whether it casts the feature to bfloat16."""
    p = j_pw.max_disp_px(scale, h)
    cast_all, cast_fit = mode == "all", mode in ("1", "all")
    if h < j_samm._MXU_WARP_MIN:
        return False
    if j_pw.mxu_warp_supported(h, h, c, p, 4) and not (
            cast_all and j_pw.mxu_warp_supported(h, h, c, p, 2)):
        return False
    return cast_fit and j_pw.mxu_warp_supported(h, h, c, p, 2)


@pytest.mark.parametrize("mode", ["fit", "all"])
def test_warp_cast_gate_matches_jax(mode):
    """The port's copy of the gate against JAX's arithmetic; at the 1024px
    model's widths "fit" casts the 128px scale alone, "all" the 128 and
    256px ones."""
    jmode = {"fit": "1", "all": "all"}[mode]
    for h in (16, 32, 64, 128, 256, 512):
        for c in (64, 96, 128, 256, 512):
            for scale in (0.02, 0.08, 0.3, 0.75):
                assert samm.warp_bf16_cast(mode, h, h, c, scale) == jax_casts(
                    jmode, h, c, scale), (h, c, scale)
                assert samm.max_disp_px(scale, h) == j_pw.max_disp_px(scale, h)
    cast = [h for h, c in SAMM_SCALES if samm.warp_bf16_cast(mode, h, h, c, 0.08)]
    assert cast == ([128] if mode == "fit" else [128, 256])
    assert not any(samm.warp_bf16_cast("off", h, h, c, 0.08) for h, c in SAMM_SCALES)


def test_samm_block_fit_cast_matches_jax(monkeypatch):
    """One SAMM block (one align cycle, a coarser align merged in) at 128px,
    C 256, with samm_warp_bf16="fit" against JAX's block with
    OGI_MXU_WARP=1: both cast the feature to bfloat16 for the warp, and
    agree within one bfloat16 step of max|ref|."""
    c, size = 256, 128
    rs = np.random.RandomState(0)
    feat, gen_feat = (rs.randn(1, size, size, c).astype(np.float32) for _ in range(2))
    coarse = np.concatenate([np.tanh(rs.randn(1, 64, 64, 2)) * 0.08, rs.rand(1, 64, 64, 1)],
                            -1).astype(np.float32)
    jmod = j_samm.StyledScaleNShiftBlock(c, c, warp_scale=0.08, cycle_align=1)
    args = [jnp.asarray(a) for a in (feat, rs.randn(1, 512).astype(np.float32), gen_feat,
                                     coarse)]
    flat = fill_params(init_shapes(jmod, *args), seed=1)
    seen = {"jax": [], "port": []}
    j_platform, p_warp = j_samm.warp_blend_platform, samm.warp_blend

    def j_spy(target, *a):
        seen["jax"].append(target.dtype)
        return j_platform(target, *a)

    def p_spy(target, *a):
        seen["port"].append(target.dtype)
        return p_warp(target, *a)

    monkeypatch.setattr(j_samm, "_MXU_WARP", "1")
    monkeypatch.setattr(j_samm, "_MXU_WARP_CAST_BF16", "1")
    monkeypatch.setattr(j_samm, "warp_blend_platform", j_spy)
    monkeypatch.setattr(samm, "warp_blend", p_spy)
    ref_out, ref_align = jmod.apply({"params": jax_tree(flat)}, *args)
    mod = load_port(samm.StyledScaleNShiftBlock(c, warp_scale=0.08, samm_warp_bf16="fit"),
                    flat, "modulation_0/")
    with torch.no_grad():
        out, align = mod(nchw(feat), nchw(gen_feat), aligned_coarse=nchw(coarse))
    assert seen["jax"] == [jnp.bfloat16] and seen["port"] == [torch.bfloat16]
    assert out.dtype == torch.float32
    assert max_rel_err(nhwc(out), ref_out) < BLOCK_RTOL
    assert max_rel_err(nhwc(align), ref_align) < SLICE_RTOL


@pytest.fixture(scope="module")
def slice_tree():
    jarch = JArch(**CFG)
    flat = fill_params(init_shapes(jarch, jnp.zeros((1, 64, 64, 3)), mod_size=64), seed=5)
    return with_style_mlp(flat, jarch, 512, seed=6)


def slice_inputs():
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    noise = [rs.randn(*s).astype(np.float32)
             for s in OODFaceGANE4E(**CFG).generator.noise_shapes(1)]
    return x, noise


def mean_rel_err(got, ref):
    """mean |got - ref| / mean |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).mean() / np.abs(ref).mean())


def jax_slice(flat, x, noise, scale):
    ref = JArch(**{**CFG, "warp_scale": scale}).apply(
        {"params": jax_tree(flat)}, jnp.asarray(x), mod_size=64,
        noise=[jnp.asarray(n.transpose(0, 2, 3, 1)) for n in noise])
    return {k: np.asarray(ref[k]) for k in ("image", "gen_image", "mask")}


def port_slice(flat, x=None, **opts):
    x0, noise = slice_inputs()
    x = x0 if x is None else x
    arch = load_port(OODFaceGANE4E(**{**CFG, **opts}), flat)
    with torch.no_grad():
        out = arch(torch.from_numpy(x), mod_size=64, noise=[torch.from_numpy(n) for n in noise])
    return {k: out[k].numpy() for k in ("image", "gen_image", "mask")}


def nudged(x, seed):
    """x moved by NUDGE of itself, elementwise, from a numpy seed."""
    return (x * (1.0 + NUDGE * np.random.RandomState(seed).randn(*x.shape))).astype(np.float32)


def set_flags(option, monkeypatch):
    """JAX's module constants for `option`, the warp cast's floor lowered
    to 32px on both sides."""
    for mod, name, value in OPTIONS[option][1]:
        monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(j_samm, "_MXU_WARP_MIN", 32)
    monkeypatch.setattr(samm, "WARP_BF16_MIN", 32)


def readings(flat, opts, scale, seeds):
    """With the port's options `opts` (and JAX's flags as the caller set
    them): (JAX's slice, the port's, and for each of `seeds` how far JAX's
    and the port's outputs move under a nudge of the input, as max_rel_err
    per key)."""
    x, noise = slice_inputs()
    ref = jax_slice(flat, x, noise, scale)
    got = port_slice(flat, warp_scale=scale, **opts)
    moves = []
    for seed in seeds:
        xs = nudged(x, seed)
        j, p = jax_slice(flat, xs, noise, scale), port_slice(flat, xs, warp_scale=scale, **opts)
        moves.append(({k: max_rel_err(j[k], ref[k]) for k in ref},
                      {k: max_rel_err(p[k], got[k]) for k in got}))
    return ref, got, moves


@pytest.mark.parametrize("option", list(OPTIONS))
def test_slice_option_matches_jax(slice_tree, option, monkeypatch):
    """The float32 slice with the option against JAX's with its flag (see
    the module docstring for the bounds), off the port's slice without the
    option, and the option's route taken (the warp cast at the 32px block
    alone, the bfloat16 sample at every warp it does not cast)."""
    opts, _, scale = OPTIONS[option]
    x, noise = slice_inputs()
    ref_off = jax_slice(slice_tree, x, noise, scale)
    set_flags(option, monkeypatch)
    casts, taps = [], p_wb.warp_blend_taps_bf16.launches
    warp = samm.warp_blend

    def spy(target, *a):
        casts.append((target.shape[1], target.dtype))
        return warp(target, *a)

    monkeypatch.setattr(samm, "warp_blend", spy)
    ref, got, moves = readings(slice_tree, opts, scale, NUDGE_SEEDS)
    casts = casts[:len(casts) // (1 + len(NUDGE_SEEDS))]
    monkeypatch.undo()
    plain = port_slice(slice_tree, warp_scale=scale)
    for k in ("image", "gen_image", "mask"):
        bound = max(SLICE_RTOL, max(j[k] for j, _ in moves) + max(p[k] for _, p in moves))
        assert max_rel_err(got[k], ref[k]) <= bound, k
        assert mean_rel_err(got[k], ref[k]) < SLICE_MEAN_FRACTION * mean_rel_err(
            ref_off[k], ref[k]), k
        assert max_rel_err(plain[k], ref_off[k]) < SLICE_RTOL, k
    assert max_rel_err(got["image"], plain["image"]) > 0.0
    if option.startswith("warp"):
        assert sorted(casts) == [(32, torch.bfloat16)] * 2 + [(64, torch.float32)] * 2
    else:
        assert all(dt == torch.float32 for _, dt in casts)
    # on the CPU the wrappers count no launch: they run their plain versions
    assert p_wb.warp_blend_taps_bf16.launches == taps


def test_taps_bf16_plain_version_is_jax_gather4bf16(monkeypatch):
    """warp_blend_taps_bf16's plain version against JAX's gather4bf16 grid
    sample blended with the float32 target, bit for bit (op by op on both
    sides); and against the float32 warp within the bfloat16 rounding of
    the taps and weights."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 16, 16, 8).astype(np.float32)
    grid = (rs.rand(2, 16, 16, 2) * 2.2 - 1.1).astype(np.float32)
    alpha = rs.rand(2, 16, 16, 1).astype(np.float32)
    monkeypatch.setattr(j_gs, "_MODE", "gather4bf16")
    warped = np.asarray(j_gs.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid)))
    ref = warped * alpha + x * (1.0 - alpha)
    t = [torch.from_numpy(a) for a in (x, grid, alpha)]
    got = p_wb.warp_blend_taps_bf16(*t)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    f32 = p_wb.warp_blend(*t).numpy()
    assert 0.0 < np.abs(got.numpy() - f32).max() <= 2.0 ** -6 * np.abs(x).max()
    with pytest.raises(TypeError, match="float32 target"):
        p_wb.warp_blend_taps_bf16(t[0].bfloat16(), t[1], t[2])


def test_options_plumbing_and_refusals():
    """Each option reaches every SAMM block of each family and the engine;
    samm_conv_bf16 refuses the fused and literal body0, whose convs it
    would leave as they are, and samm_warp_bf16 a mode it does not know."""
    base = {"out_size": 64, "channel_multiplier": 1, "narrow": 0.125,
            "encoder_num_layers": 4}
    opts = {"samm_conv_bf16": True, "samm_warp_bf16": "all", "samm_gather_bf16": True}
    for arch_type, extra in (("ood_faceGAN_e4e", {}), ("ood_faceGAN_restyle", {}),
                             ("ood_faceGAN_FeatureStyle", {"narrow": 1.0})):
        arch = build_network({"type": arch_type, **base, **extra, **opts})
        for block in arch.modulation.values():
            spm = block.alignment
            assert spm.body.samm_conv_bf16 and spm.warp_bf16 == "all" and spm.gather_bf16
    eng = InversionEngine({"network_g": {"type": "ood_faceGAN_e4e", **base, "ModSize": 64}},
                          device="cpu", samm_warp_bf16="fit")
    assert {b.alignment.warp_bf16 for b in eng.net.modulation.values()} == {"fit"}
    for body0 in ("fused", "literal"):
        with pytest.raises(ValueError, match="samm_conv_bf16"):
            OODFaceGANE4E(**base, samm_body0=body0, samm_conv_bf16=True)
    with pytest.raises(ValueError, match="samm_warp_bf16"):
        OODFaceGANE4E(**base, samm_warp_bf16="1")


def main():
    """Prints each option's readings at the slice (the gap to JAX, and both
    sides' moves under a nudge of the input for four seeds), as max_rel_err
    of image, gen_image and mask; first without an option at "fit"'s
    warp_scale 0.75."""
    jarch = JArch(**CFG)
    flat = fill_params(init_shapes(jarch, jnp.zeros((1, 64, 64, 3)), mod_size=64), seed=5)
    flat = with_style_mlp(flat, jarch, 512, seed=6)

    def text(errs):
        return ", ".join(f"{k} {v:.2e}" for k, v in errs.items())

    for option in ("off", *OPTIONS):
        opts, _, scale = OPTIONS.get(option, ({}, [], 0.75))
        with pytest.MonkeyPatch.context() as mp:
            if option != "off":
                set_flags(option, mp)
            ref, got, moves = readings(flat, opts, scale, (100, 101, 102, 103))
        print(f"{option} (warp_scale {scale}): port vs JAX "
              f"{text({k: max_rel_err(got[k], ref[k]) for k in ref})}")
        for seed, (j, p) in zip((100, 101, 102, 103), moves):
            print(f"  nudge seed {seed}: JAX moves {text(j)}; the port {text(p)}")


if __name__ == "__main__":
    main()
