"""mfu_pct (%, host clock and a count; layer: model step): the model's
FLOPs per image times img_per_s of the same traced run, over the card's
published peak in the configuration's dtype (float32: 67 TFLOP/s; the
engine turns TF32 off). The FLOPs are those of the convolutions and
matrix products of the configuration's reference (the module its
`reference` names) at the cell's image size, counted by
`torch.utils.flop_counter` over a forward on the meta device, so the
count is the same whatever the program runs."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.metrics import img_per_s
from portbench.peaks import FLOPS
from portbench.weights import meta_reference


def model_flops_per_image(config):
    model = meta_reference(config).requires_grad_(False)
    s = config["network_g"].get("out_size", 1024)
    noise = [[torch.zeros(shape, device="meta") for shape in model.generator.noise_shapes()]
             for _ in range(model.n_decodes())]
    counter = FlopCounterMode(display=False)
    with counter:
        model(torch.zeros((1, s, s, 3), device="meta"), noise)
    return counter.get_total_flops()


def read(run):
    rate = img_per_s.read(run)
    if not rate:
        return None
    flops = model_flops_per_image(run.config)
    return 100.0 * flops * rate / FLOPS[run.config["dtype"]]
