"""The FeatureStyle configuration's reference (`reference/featurestyle.py`)
on the CPU: its encoder against the program's `FSEncoderV2` alone, on one
set of seeded weights (the content tensor, which no output of the inverter
reads, is compared here); the seed-77 weights at the micro size, pinned;
and the full-size FLOP count of `featurestyle_face`, pinned."""

import json

import pytest
import torch

from conftest import micro_cell
from portbench import run
from portbench.metrics.mfu_pct import model_flops_per_image
from portbench.reference import featurestyle
from portbench.weights import make_state_dict
from test_portbench_references import _digest

WORKLOAD = "featurestyle_f32_b8"


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_reference_encoder_matches_the_ports_on_the_cpu():
    from ood_gan_inversion_tpu_torch.nn.encoders.feature_style import FSEncoderV2

    config = micro_cell(WORKLOAD)["config"]
    state = make_state_dict(config, 77, "cpu")
    enc = {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}
    ref = featurestyle.build(config["network_g"]).encoder
    ref.load_state_dict(enc, strict=True)
    port = FSEncoderV2(n_styles=ref.n_styles)
    port.load_state_dict(enc, strict=True)
    x = torch.rand((2, 3, 256, 256), generator=torch.Generator().manual_seed(4)) * 2 - 1
    with torch.no_grad():
        lats, content, feats = ref.eval()(x)
        p_lats, p_content, p_feats = port.eval()(x)
    assert lats.shape == (2, 10, 512) and content.shape == (2, 512, 16, 16)
    assert [tuple(f.shape[1:]) for f in feats] == [(64, 256, 256), (64, 128, 128),
                                                  (128, 64, 64), (256, 32, 32)]
    # float32 in another summation order (per-sample convs, the pools as
    # matrix products): ~1e-6 of max|ref|
    errs = {"lats": _rel(p_lats, lats), "content": _rel(p_content, content)}
    errs.update({f"f{i}": _rel(p, r) for i, (p, r) in enumerate(zip(p_feats, feats))})
    assert max(errs.values()) < 2e-5, errs
    # the heads, not the offsets, carry the latents; each sample its own
    assert float(lats.std()) > 0.1 and _rel(lats[0], lats[1]) > 1e-2


def test_seeded_weights_are_bit_for_bit_as_pinned():
    # the seed-77 weights at the micro size: every key, shape and bit
    state = make_state_dict(micro_cell(WORKLOAD)["config"], 77, "cpu")
    assert len(state) == 547
    assert _digest(state) == ("e63474948f6ad0bc9d0e823dc223c0ae"
                              "5a5e643d3902a032bc0eccf0d06c8c21")


def test_full_size_flop_count_is_as_pinned():
    # GFLOP per 1024px image of the full-size reference (PERF.md, section 3)
    cfg = json.loads((run.PKG / "configs/featurestyle_face.json").read_text())
    assert model_flops_per_image(cfg) / 1e9 == pytest.approx(1735.83, abs=0.01)
