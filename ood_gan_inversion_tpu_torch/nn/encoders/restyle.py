"""ReStyle's progressive backbone encoder (counterpart of
nn/encoders/restyle.py), NCHW: an IR-SE trunk over a 6-channel input
[x || previous decode], every style head (GradualStyleBlock(512, 512,
16)) on the final 16px map, the first head's W plus the others' deltas.
Returns W+ (B, n_styles, 512) and the trunk taps [256px/64, 128px/64,
64px/128, 32px/256, 16px/512], as E4E does. Only the Inference
progressive stage (every delta active) is ported; the heads run one after
another, the JAX default."""

import torch
from torch import nn

from ..irse import IRSETrunk, trunk_taps
from .e4e import PROGRESSIVE_INFERENCE, GradualStyleBlock


class ProgressiveBackboneEncoder(nn.Module):
    def __init__(self, num_layers=50, mode="ir_se", n_styles=18, input_nc=6):
        super().__init__()
        self.num_layers, self.n_styles = num_layers, n_styles
        self.trunk = IRSETrunk(num_layers, mode, input_ch=input_nc)
        self.style = nn.ModuleList(GradualStyleBlock(512, 512, 16) for _ in range(n_styles))

    def forward(self, x, stage: int = PROGRESSIVE_INFERENCE):
        if min(stage + 1, self.n_styles) < self.n_styles:
            raise NotImplementedError(
                f"progressive encoder stage {stage} (< {self.n_styles - 1}) "
                "is not ported (ROADMAP A7); use stage: Inference")
        final, feats = self.trunk(x, taps=trunk_taps(self.num_layers))
        w0 = self.style[0](final)
        deltas = [torch.zeros_like(w0)] + [head(final) for head in self.style[1:]]
        return w0[:, None, :] + torch.stack(deltas, dim=1), feats
