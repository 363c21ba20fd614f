"""The plain references of the benchmark's configurations, one module each.

A configuration file names its reference under `reference`: the module
`portbench/reference/<reference>.py`, which `module(config)` imports by
that name. Everything that builds or counts the reference (the check and
its control, the seeded weights of both sides, the FLOP count of
`mfu_pct`) finds it so; nothing falls back to another module. A
reference module imports nothing of the program under test, and has:

  build(network_g)   the float32 `nn.Module` of that `network_g`, built
                     on the current default device; every parameter and
                     buffer has an entry in its owner's `init_specs()`
                     ("normal", std[, mean]) or ("uniform", half_width[,
                     centre]), from which `portbench/weights.py` draws it
  batch_noise(model, seeds, device)
                     each seed's noise at batch 1 (`model.make_noise`),
                     concatenated over the batch, per decode and layer

and the module that `build` returns has:

  forward(x, noises)    x (B, S, S, 3) NHWC in [-1, 1], noises from
                        `batch_noise`; returns a dict with `image`, `mask`
                        and `gen_image` (NHWC) and `lats`
  make_noise(seed, device)  one image's noise: a list per decode
  n_decodes()           the number of decodes of one forward
  generator.noise_shapes()  one image's noise shape of each layer of a
                        decode, in order

Its parameter names are the program's state-dict keys, so that one set of
seeded tensors loads into both sides.
"""

import importlib
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_]{0,63}$")


def module(config):
    """The reference module that the configuration names."""
    cfg, name = config.get("name"), config.get("reference")
    if name is None:
        raise ValueError(f"configuration {cfg!r} names no reference (its `reference` key)")
    if not (isinstance(name, str) and NAME.match(name)
            and (Path(__file__).parent / f"{name}.py").is_file()):
        raise ValueError(f"configuration {cfg!r}: no reference {name!r} "
                         f"(portbench/reference/<name>.py)")
    return importlib.import_module(f"{__name__}.{name}")
