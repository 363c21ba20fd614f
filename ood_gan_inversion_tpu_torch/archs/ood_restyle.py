"""OOD face-GAN inversion arch, ReStyle encoder family (counterpart of
archs/ood_restyle.py). What differs from the E4E arch:
  * the encoder (nn/encoders/restyle.py) takes 6 channels, [x256 || the
    previous decode pooled to 256px], and runs `enc_cycle` times: first on
    the average image (the generator's decode of `avg_latent`), then on
    the decode of the latents so far, each pass adding its W+ delta; with
    freeze_encoder (the default) the loop runs without grad, as the
    reference's does;
  * `avg_latent` holds one W per layer, (style_cnt, style_dim).
Then the SAMM-conditioned decode, as in E4E.

Noise: the arch decodes enc_cycle + 1 times in a forward, each decode with
the generator's per-layer noise. `make_noise` and the `noise` argument of
`forward` are the concatenation of those lists in decode order: the
average image's, the enc_cycle - 1 refinements', then the final
conditioned decode's (each `Generator.num_layers` entries, in layer
order; the final decode's followed by ADD's draws where the arch has
them, as the E4E arch's noise is). Every decode runs at the input's
batch, the average image's too: a batch of per-seed draws gives each
sample its own average image, as a lone request has, at the cost of b
decodes where JAX runs one at batch 1 and tiles it (PERF.md gives the
cost).
"""

import contextlib

import torch

from ..nn.encoders.e4e import PROGRESSIVE_INFERENCE
from ..nn.encoders.restyle import ProgressiveBackboneEncoder
from ..ops.resize import adaptive_avg_pool
from ..utils import trace
from .ood_e4e import OODFaceGANE4E


class OODFaceGANReStyle(OODFaceGANE4E):
    """The `network_g` keys of the E4E arch plus `enc_cycle`;
    `encoder_num_layers` is the IR-SE trunk's depth (50, as JAX builds it)."""
    ENCODER = "ReStyle"

    def __init__(self, encoder="ReStyle", enc_cycle=2, **kwargs):
        if enc_cycle < 1:
            raise ValueError(f"enc_cycle must be >= 1, got {enc_cycle}")
        super().__init__(encoder=encoder, **kwargs)
        self.enc_cycle = enc_cycle

    def build_encoder(self, num_layers):
        return ProgressiveBackboneEncoder(num_layers, "ir_se", self.style_cnt, input_nc=6)

    def avg_latent_shape(self):
        return (self.style_cnt, self.style_dim)

    def make_noise(self, batch, generator=None, device=None):
        """The noise of the enc_cycle + 1 decodes of one forward, in the
        order the module docstring gives, drawn in that order; the final
        decode's is the E4E arch's (with ADD's draws)."""
        return ([n for _ in range(self.enc_cycle)
                 for n in self.generator.make_noise(batch, generator, device)]
                + super().make_noise(batch, generator, device))

    def split_noise(self, noise):
        """make_noise's list -> (the enc_cycle decodes' lists of `encode`,
        the final decode's noise)."""
        n = self.enc_cycle * self.generator.num_layers
        return noise[:n], noise[n:]

    def encode(self, x, truncation: float = 1.0, stage: int = PROGRESSIVE_INFERENCE,
               freeze_encoder: bool = True, noise=None):
        """x (B, 3, S, S) in [-1, 1]; noise: the enc_cycle decodes' lists
        (make_noise without its last decode) -> (W+, adapted features)."""
        n = self.generator.num_layers
        if noise is None or len(noise) != self.enc_cycle * n:
            raise ValueError(f"encode needs the noise of {self.enc_cycle} decodes "
                             f"({self.enc_cycle * n} tensors)")
        x = x.to(self.dtype)
        x256 = adaptive_avg_pool(x, (256, 256))
        avg = self.avg_latent[None].to(x.dtype)

        def decode256(lats, dec):
            return adaptive_avg_pool(self.generator(lats, noise[dec * n:(dec + 1) * n]),
                                     (256, 256))

        def encoder(prev):
            with trace.span("encoder", x.shape[0]):
                return self.encoder(torch.cat([x256, prev], dim=1), stage)

        with torch.no_grad() if freeze_encoder else contextlib.nullcontext():
            lats, feats = encoder(decode256(avg.expand(x.shape[0], -1, -1), 0))
            lats = lats + avg
            for dec in range(1, self.enc_cycle):
                delta, feats = encoder(decode256(lats.detach(), dec))
                lats = lats + delta
        return self.offset_and_adapt(lats, feats, truncation)
