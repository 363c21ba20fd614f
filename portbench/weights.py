"""Seeded weights for both sides: the program under test and the reference.

The configuration's reference model (the module its `reference` names;
portbench/reference/__init__.py), built on the meta device, names every
tensor and says how it is drawn (`init_specs` of its modules: a normal or
a uniform draw, scaled and shifted). All normal draws come from one
`torch.randn` call and all uniform ones from one `torch.rand` call, made
on the target device from a generator seeded with the run's seed, then cut
into the tensors. The same seed gives the same tensors.
"""

import torch

from . import reference


def meta_reference(config):
    """The configuration's reference model on the meta device."""
    ref = reference.module(config)
    with torch.device("meta"):
        return ref.build(config["network_g"])


def leaf_specs(model):
    """[(state-dict key, shape, spec)] in module order."""
    out = []
    for mod_name, mod in model.named_modules():
        specs = mod.init_specs() if hasattr(mod, "init_specs") else {}
        tensors = dict(mod.named_parameters(recurse=False))
        tensors.update(mod.named_buffers(recurse=False))
        missing = set(tensors) - set(specs)
        if missing:
            raise ValueError(f"{mod_name or type(mod).__name__}: no init spec for {sorted(missing)}")
        for name, spec in specs.items():
            if name in tensors:
                key = f"{mod_name}.{name}" if mod_name else name
                out.append((key, tuple(tensors[name].shape), spec))
    return out


def make_state_dict(config, seed, device):
    """The state dict of the configuration's weights for `seed`, float32 on
    `device`."""
    specs = leaf_specs(meta_reference(config))
    g = torch.Generator(device=device).manual_seed(int(seed))

    def total(kind):
        return sum(torch.Size(shape).numel() for _, shape, spec in specs if spec[0] == kind)

    pools = {"normal": torch.randn(total("normal"), generator=g, device=device),
             "uniform": torch.rand(total("uniform"), generator=g, device=device)}
    at = {"normal": 0, "uniform": 0}
    state = {}
    for key, shape, (kind, scale, *shift) in specs:
        n = torch.Size(shape).numel()
        flat = pools[kind][at[kind]:at[kind] + n]
        at[kind] += n
        if kind == "uniform":
            flat = flat * 2.0 - 1.0
        state[key] = (flat * scale + (shift[0] if shift else 0.0)).reshape(shape)
    return state
