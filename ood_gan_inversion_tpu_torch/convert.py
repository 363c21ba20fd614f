"""JAX -> port weights bridge.

`from_jax_params` maps the flattened flax parameter tree of the JAX
`OODFaceGANE4E` (keys 'a/b/c' as `flax.traverse_util.flatten_dict` joins
them) onto the port's `state_dict` names:

  * list members: 'style_3' -> 'style.3', 'convs_0' -> 'convs.0', ...;
  * the IR-SE trunk's BatchNorm wrapper level 'norm1/norm/scale' ->
    'norm1.weight', running statistics 'mean'/'var' -> 'running_mean' /
    'running_var'; InstanceNorm 'scale' -> 'weight';
  * layouts: conv kernels HWIO -> OIHW, linear weights (in, out) ->
    (out, in), the generator's constant input NHWC -> NCHW.
"""

import re

import numpy as np
import torch

_LIST_MEMBER = re.compile(r"_(\d+)(?=/|$)")


def port_key(jax_key: str) -> str:
    """The port state_dict name of one flattened JAX parameter path."""
    k = re.sub(r"/norm/(scale|bias|mean|var)$", r"/\1", jax_key)
    k = _LIST_MEMBER.sub(r"/\1", k)
    k = re.sub(r"/scale$", "/weight", k)
    k = re.sub(r"/mean$", "/running_mean", k)
    k = re.sub(r"/var$", "/running_var", k)
    return k.replace("/", ".")


def port_value(jax_key: str, value) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    if jax_key == "generator/input":
        a = a.transpose(0, 3, 1, 2)
    elif jax_key.endswith("weight") and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif jax_key.endswith("weight") and a.ndim == 2:
        a = a.T
    return torch.from_numpy(np.ascontiguousarray(a))


# The JAX subtrees the port has modules for. Anything else (e.g. the
# generator's style MLP, which the inversion path never runs) is left over.
_PORTED = re.compile(
    r"^(avg_latent|delta_latent)$"
    r"|^encoder/(trunk|style_\d+|latlayer[12])/"
    r"|^feats_conv_\d+/"
    r"|^modulation_\d+/alignment/body/"
    r"|^generator/(input$|conv1/|to_rgb1/|convs_\d+/|to_rgbs_\d+/)")


def from_jax_params(flat: dict):
    """Returns (state_dict, leftovers): the port's tensors for every JAX
    leaf of a ported subtree, and the JAX keys outside them. Load the
    state_dict with `load_state_dict(..., strict=True)`, which also catches
    a port tensor that no JAX leaf filled."""
    state, leftovers = {}, []
    for jk, v in flat.items():
        if _PORTED.match(jk):
            state[port_key(jk)] = port_value(jk, v)
        else:
            leftovers.append(jk)
    return state, leftovers
