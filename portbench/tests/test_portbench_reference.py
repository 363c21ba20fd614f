"""Each cell's reference (the module its configuration names) against the
program's plain path on the CPU, at the configuration's micro size, on one
set of seeded weights loaded into both."""

import numpy as np
import pytest
import torch

from conftest import WORKLOADS, micro_cell


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_matches_the_port_on_the_cpu(workload):
    from ood_gan_inversion_tpu_torch.infer import InversionEngine
    from portbench import check
    from portbench.weights import make_state_dict

    config = micro_cell(workload)["config"]
    g = config["network_g"]
    engine = InversionEngine({"network_g": g}, params=make_state_dict(config, 77, "cpu"),
                             device="cpu")
    ref, model = check.reference(config, 77, torch.device("cpu"))
    rng = np.random.default_rng(5)
    s = g["out_size"]
    imgs = [rng.random((s, s, 3), dtype=np.float32) for _ in range(3)]
    seeds = [3, 2 ** 40 + 1, 9]
    outs = engine.invert_batch_perkey(imgs, seeds)
    refs = check.run_reference(ref, model, imgs, seeds, torch.device("cpu"), 2)
    errs = check.errors(outs, refs)
    # float32 in another summation order: ~1e-6 of max|ref| (2e-6 measured)
    assert max(errs.values()) < 2e-5, errs
    # the reply depends on its seed and on its image
    assert (outs["gen_image"][0] - outs["gen_image"][2]).abs().max() > 1e-3
    assert 0.0 < float(refs["mask"].min()) and float(refs["mask"].max()) < 1.0


def test_weights_repeat_for_a_seed_and_change_with_it():
    from portbench.weights import make_state_dict
    config = micro_cell("e4e_f32_b8")["config"]
    a, b, c = (make_state_dict(config, s, "cpu") for s in (1, 1, 2))
    key = "generator.convs.0.conv.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    # the leaves around a fixed value differ from channel to channel and from
    # layer to layer, within their ranges
    noise = torch.cat([v for k, v in a.items() if k.endswith("noise.weight")])
    assert noise.unique().numel() == noise.numel() and 0.05 <= noise.min() <= noise.max() <= 0.2
    for key in ("generator.convs.3.activate.bias", "generator.to_rgbs.0.bias",
                "generator.convs.0.conv.modulation.bias", "encoder.trunk.body.0.norm1.running_var",
                "encoder.trunk.input_prelu.weight", "modulation.3.alignment.body.body0.norm1.weight",
                "avg_latent", "delta_latent"):
        assert a[key].std() > 0.01, key
    assert a["encoder.trunk.body.0.norm1.running_var"].min() > 0.7
