"""SAMM-conditioned decode loop and mask compositing (counterpart of
archs/common.py), NCHW, shared by the three encoder families. Only the
NOISE modulation path is ported: at a conditioned layer the aligned
encoder feature replaces the generator's conv output before the noise
injection (aligned + w * noise). FeatureStyle's content injection mixes a
feature into the generator's activation at the layers `features_in`
names. Stages that are neither conditioned nor injected run phase-packed
where the generator packs them (`Generator.stage_is_packable`)."""

import math

import torch

from ..ops.resize import resize_bilinear


def cond_layers_for(mod_size: int, n_feats: int = 4):
    """Generator layers receiving SAMM injection: 32px->5, 64px->7,
    128px->9, 256px->11."""
    if mod_size <= 0:
        return []
    max_size = int(math.floor(math.log2(mod_size)))
    cond_len = min(max(1 + max_size - 5, 0), n_feats)
    return [(2 * (k + 2)) + 1 for k in range(cond_len)]


def conditioned_decode(arch, lats, feats_c, mod_size: int, noise, features_in=None,
                       feature_scale: float = 1.0):
    """feats_c: the 4 adapted encoder features [256, 128, 64, 32]px;
    noise: the generator's per-layer noise list (Generator.make_noise).
    features_in: optional {layer index: (B, C, H, W) feature}; the
    activation entering layer i becomes (1 - feature_scale) * out +
    feature_scale * feature (i odd: before the pair's first conv; even:
    between its two convs). Returns (image (B, 3, S, S), {scale index 1..4
    (1 = 32px): align})."""
    gen = arch.generator
    cond_layers = cond_layers_for(mod_size)
    features_in = features_in or {}

    def inject(out, layer):
        f = features_in.get(layer)
        if f is None:
            return out
        return (1.0 - feature_scale) * out + feature_scale * f.to(out.dtype)

    out = gen.conv1(gen.const_input(lats.shape[0], lats.dtype), lats[:, 0],
                    noise[0])
    skip = gen.to_rgb1(out, lats[:, 1])
    aligns, prev_align = {}, None
    i = 1
    for idx, to_rgb in enumerate(gen.to_rgbs):
        if (i not in cond_layers and i not in features_in and i + 1 not in features_in
                and gen.stage_is_packable(idx)):
            out, skip = gen.packed_stage(
                idx, out, skip, lats[:, i], lats[:, i + 1], lats[:, i + 2],
                noise[1 + 2 * idx], noise[2 + 2 * idx],
                unpack_out=idx < len(gen.to_rgbs) - 1)
            i += 2
            continue
        conv_a, conv_b = gen.convs[2 * idx], gen.convs[2 * idx + 1]
        out = inject(out, i)
        if i in cond_layers:
            ind = cond_layers.index(i) + 1
            out_c = conv_a.conv(out, lats[:, i])
            aligned, align = arch.modulation[str(4 - ind)](
                feats_c[4 - ind], out_c, aligned_coarse=prev_align)
            out = conv_a.activate(conv_a.noise(aligned, noise[1 + 2 * idx]))
            aligns[ind] = prev_align = align
        else:
            out = conv_a(out, lats[:, i], noise[1 + 2 * idx])
        out = conv_b(inject(out, i + 1), lats[:, i + 1], noise[2 + 2 * idx])
        skip = to_rgb(out, lats[:, i + 2], skip)
        i += 2
    return skip, aligns


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
        mask = blending_mask(aligns, arch.out_size)
        aligns[arch.out_size] = mask.expand(-1, 3, -1, -1)
        for _ in range(arch.blend_cnt):
            image = mask * x + image * (1.0 - mask)
    return {"image": image, "lats": lats, "aligns": aligns, "mask": mask,
            "gen_image": gen_image}
