"""OOD face-GAN inversion arch, FeatureStyle encoder family (counterpart
of archs/ood_featurestyle.py). What differs from the E4E arch:
  * the encoder (nn/encoders/feature_style.py) is ArcFace's iresnet50 on
    the input pooled to 256px, with linear style heads and a content
    tensor (B, 512, 16, 16);
  * `avg_latent` holds one W per layer, (style_cnt, style_dim);
  * with `inject_content`, the decode mixes the content tensor into the
    generator's activation entering layer 5 at `feature_scale`
    (archs/common.py:conditioned_decode). It is off by default: the
    reference's forward computes the content and never passes it to the
    generator, so its trained checkpoints saw no injection.
The noise is the generator's per-layer list, as for E4E.
"""

from ..nn.encoders.e4e import PROGRESSIVE_INFERENCE
from ..nn.encoders.feature_style import FSEncoderV2
from ..ops.resize import adaptive_avg_pool
from ..utils import trace
from .common import blend_and_pack, cond_layers_for, conditioned_decode
from .ood_e4e import OODFaceGANE4E


class OODFaceGANFeatureStyle(OODFaceGANE4E):
    """The `network_g` keys of the E4E arch plus `feature_scale` and
    `inject_content`; the encoder's depth is iresnet50's
    (`encoder_num_layers` is not read)."""
    ENCODER = "FeatureStyle"

    def __init__(self, encoder="FeatureStyle", feature_scale=1.0, inject_content=False,
                 **kwargs):
        super().__init__(encoder=encoder, **kwargs)
        self.feature_scale, self.inject_content = feature_scale, inject_content

    def build_encoder(self, num_layers):
        return FSEncoderV2(n_styles=self.style_cnt)

    def avg_latent_shape(self):
        return (self.style_cnt, self.style_dim)

    def encode(self, x, truncation: float = 1.0, stage: int = PROGRESSIVE_INFERENCE,
               freeze_encoder: bool = True, noise=None):
        """x (B, 3, S, S) in [-1, 1] -> (W+, (adapted features, content));
        the content rides along to the decode. The encoder has no
        progressive stages (JAX's ignores `stage` too) and decodes
        nothing (`noise` is None)."""
        with trace.span("encoder", x.shape[0]):
            lats, content, feats = self.encoder(adaptive_avg_pool(x.to(self.dtype), (256, 256)))
        if freeze_encoder:
            lats, content = lats.detach(), content.detach()
            feats = [f.detach() for f in feats]
        lats, feats_c = self.offset_and_adapt(lats + self.avg_latent[None].to(lats.dtype),
                                              feats, truncation)
        return lats, (feats_c, content)

    def decode_samm(self, lats, feats_and_content, x, mod_size: int = 256, noise=None):
        """(W+, (adapted features, content)) -> the output dict, NCHW."""
        feats_c, content = feats_and_content
        x = x.to(self.dtype)
        features_in = {5: content} if self.inject_content else None
        if not self.enable_modulation or not cond_layers_for(mod_size):
            image, _ = conditioned_decode(self, lats, [None] * 4, 0, noise, features_in,
                                          self.feature_scale)
            return {"image": image, "lats": lats, "aligns": {}, "mask": None,
                    "gen_image": image}
        gen_image, aligns = conditioned_decode(self, lats, feats_c, mod_size, noise,
                                               features_in, self.feature_scale)
        return blend_and_pack(self, x, gen_image, lats, aligns)
