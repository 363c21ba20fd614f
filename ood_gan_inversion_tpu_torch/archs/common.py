"""SAMM-conditioned decode loop and mask compositing (counterpart of
archs/common.py), NCHW, shared by the three encoder families.

At a conditioned layer the SAMM block aligns the generator feature to the
encoder's, by the arch's `modulation_type`:
  * NOISE (the shipped configs): the aligned feature replaces the
    generator's conv output before the noise injection (aligned + w *
    noise, then the activation). With the arch's `samm_fp32_infer` a
    bfloat16 arch runs the block in float32 (the feature, the style and
    the conv output cast up, the aligned feature cast back; JAX's
    OGI_SAMM_FP32_INFER=1 at every SAMM scale);
  * ADD: the block aligns the full styled conv's output out_a, and the
    layer's output is feature_modulation(out_a, (None, aligned - out_a +
    n), "ADD") with n ~ N(0, 1) of out_a's shape: the draws that
    `cond_noise_shapes` lists, after the generator's per-layer list in the
    forward's noise;
  * SFT and FUSE build but raise here, as JAX's decode does.
FeatureStyle's content injection mixes a feature into the generator's
activation at the layers `features_in` names. Stages that are neither
conditioned nor injected run phase-packed where the generator packs them
(`Generator.stage_is_packable`); inside parallel/spatial.py's `banding`
they run banded over a mesh's slots (phase-packed where the generator packs
them), and a conditioned or injected stage takes its input gathered onto
the first slot and runs whole there."""

import math

import torch

from ..nn.stylegan2 import DECODE_SPANS, feature_modulation
from ..ops.resize import resize_bilinear
from ..parallel import spatial
from ..utils import trace

# the span of the SAMM block of scale index ind (1 = 32px): SAMM_SPANS[ind - 1]
SAMM_SPANS = tuple(f"samm.{2 ** (k + 5)}" for k in range(4))


def cond_layers_for(mod_size: int, n_feats: int = 4):
    """Generator layers receiving SAMM injection: 32px->5, 64px->7,
    128px->9, 256px->11."""
    if mod_size <= 0:
        return []
    max_size = int(math.floor(math.log2(mod_size)))
    cond_len = min(max(1 + max_size - 5, 0), n_feats)
    return [(2 * (k + 2)) + 1 for k in range(cond_len)]


def cond_noise_shapes(arch, batch):
    """The shapes of the ADD injection's draws: one (B, C, s, s) per SAMM
    block, in layer order (32px first), C the generator's width at s px;
    none for another modulation type. Drawn for every block whatever the
    forward's mod_size, so a forward's noise does not depend on it."""
    if not arch.enable_modulation or arch.modulation_type != "ADD":
        return []
    gen = arch.generator
    return [(batch, gen.convs[2 * (k + 2)].conv.weight.shape[0], 2 ** (k + 5), 2 ** (k + 5))
            for k in range(len(arch.modulation))]


def conditioned_decode(arch, lats, feats_c, mod_size: int, noise, features_in=None,
                       feature_scale: float = 1.0):
    """feats_c: the 4 adapted encoder features [256, 128, 64, 32]px;
    noise: the generator's per-layer noise list (Generator.make_noise),
    then, for ADD, the draws of cond_noise_shapes.
    features_in: optional {layer index: (B, C, H, W) feature}; the
    activation entering layer i becomes (1 - feature_scale) * out +
    feature_scale * feature (i odd: before the pair's first conv; even:
    between its two convs). Returns (image (B, 3, S, S), {scale index 1..4
    (1 = 32px): align})."""
    gen = arch.generator
    cond_layers = cond_layers_for(mod_size)
    features_in = features_in or {}
    mod_type = arch.modulation_type
    if cond_layers and mod_type not in ("NOISE", "ADD"):
        raise NotImplementedError(
            f"modulation_type={mod_type} SAMM injection is non-functional in the "
            "reference (None condition slots); use NOISE or ADD")
    cond_noise = noise[gen.num_layers:]

    def inject(out, layer):
        f = features_in.get(layer)
        if f is None:
            return out
        return (1.0 - feature_scale) * out + feature_scale * f.to(out.dtype)

    b = lats.shape[0]
    with trace.span(DECODE_SPANS[0], b):
        out = gen.conv1(gen.const_input(b, lats.dtype), lats[:, 0], noise[0])
        skip = gen.to_rgb1(out, lats[:, 1])
    aligns, prev_align = {}, None
    i = 1
    for idx, to_rgb in enumerate(gen.to_rgbs):
        conditioned = i in cond_layers or i in features_in or i + 1 in features_in
        with trace.span(DECODE_SPANS[idx + 1], b):
            if conditioned:
                # SAMM and the feature injection run whole on the first slot
                # (parallel/spatial.py; nothing outside its banding context)
                out, skip = spatial.gather(out), spatial.gather(skip)
            if spatial.banded(out, conditioned):
                out, skip = spatial.banded_stage(
                    gen, idx, out, skip, lats[:, i], lats[:, i + 1], lats[:, i + 2],
                    noise[1 + 2 * idx], noise[2 + 2 * idx])
            elif not conditioned and gen.stage_is_packable(idx):
                out, skip = gen.packed_stage(
                    idx, out, skip, lats[:, i], lats[:, i + 1], lats[:, i + 2],
                    noise[1 + 2 * idx], noise[2 + 2 * idx],
                    unpack_out=idx < len(gen.to_rgbs) - 1)
            else:
                conv_a, conv_b = gen.convs[2 * idx], gen.convs[2 * idx + 1]
                out = inject(out, i)
                if i in cond_layers:
                    ind = cond_layers.index(i) + 1
                    mod, feat, style = arch.modulation[str(4 - ind)], feats_c[4 - ind], lats[:, i]
                    if mod_type == "ADD":
                        out_a = conv_a(out, style, noise[1 + 2 * idx])
                        with trace.span(SAMM_SPANS[ind - 1], b):
                            aligned, align = mod(feat, out_a, prev_align, style)
                        cond = aligned - out_a + cond_noise[ind - 1].to(out_a.dtype)
                        out = feature_modulation(out_a, (None, cond), mod_type="ADD")
                    else:
                        out_c = conv_a.conv(out, style)
                        with trace.span(SAMM_SPANS[ind - 1], b):
                            if arch.samm_fp32_infer and out_c.dtype == torch.bfloat16:
                                aligned, align = mod(feat.float(), out_c.float(), prev_align,
                                                     style.float())
                                aligned = aligned.to(out_c.dtype)
                            else:
                                aligned, align = mod(feat, out_c, prev_align, style)
                        out = conv_a.activate(conv_a.noise(aligned, noise[1 + 2 * idx]))
                    aligns[ind] = prev_align = align
                else:
                    out = conv_a(out, lats[:, i], noise[1 + 2 * idx])
                out = conv_b(inject(out, i + 1), lats[:, i + 1], noise[2 + 2 * idx])
                skip = to_rgb(out, lats[:, i + 2], skip)
            # banding anchor (parallel/spatial.py; nothing outside its banding
            # context): the >= min_h stages' outputs are H-banded
            out, skip = spatial.constrain(out), spatial.constrain(skip)
        i += 2
    return spatial.gather(skip), aligns


def blending_mask(aligns, out_size: int):
    """Composite the per-scale alphas to the full-resolution mask
    (B, 1, out_size, out_size)."""
    alpha = None
    for k in sorted(aligns):
        a_k = resize_bilinear(aligns[k][:, 2:3], (out_size, out_size))
        alpha = a_k if alpha is None else (a_k * alpha) + (alpha * (1.0 - alpha))
    return torch.clamp(alpha, 0.0, 1.0) if alpha is not None else None


def blend_and_pack(arch, x, gen_image, lats, aligns):
    """Blends the input's out-of-domain pixels over the inversion. Returns
    dict(image, lats, aligns, mask, gen_image); aligns gains key out_size
    holding the composited mask as 3 channels."""
    image, mask = gen_image, None
    if arch.blend_with_gen and aligns:
        with trace.span("blend", x.shape[0]):
            mask = blending_mask(aligns, arch.out_size)
            aligns[arch.out_size] = mask.expand(-1, 3, -1, -1)
            for _ in range(arch.blend_cnt):
                image = mask * x + image * (1.0 - mask)
    return {"image": image, "lats": lats, "aligns": aligns, "mask": mask,
            "gen_image": gen_image}
