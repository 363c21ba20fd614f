"""JAX -> port weights bridge.

`from_jax_params` maps the flattened flax parameter tree of one JAX net
(keys 'a/b/c' as `flax.traverse_util.flatten_dict` joins them) onto the
port's `state_dict` names: the inversion arch ("g"), the image
discriminator ("d"), the latent discriminator ("d2"), the perceptual
loss's VGG19 ("vgg"), the identity loss's ArcFace net ("id"), the
LPIPS metric's and LPIPS_Loss's AlexNet-LPIPS ("lpips"), FID's
InceptionV3 ("inception"), pSp's GradualStyleEncoder ("psp"), the single-W
encoder ("w_encoder"), ArcFaceLoss's ResNetArcFace ("arcface") and the
GPEN and GCFSR generators ("gpen", "gcfsr"). The arch "g" is any of the
three families: E4E, ReStyle and FeatureStyle, with or without the SAMM
bottleneck ('modulation_i/btn1').
`from_reference_irse50` reads the reference's own torch `model_ir_se50.pth`
into the ArcFace net.
`load_jax_train_state` loads all of a JAX `TrainState` into a port
`OODFaceGANModel`. Name and layout rules:

  * list members: 'style_3' -> 'style.3', 'convs_0' -> 'convs.0',
    'res_10' -> 'res.10', VGG's 'conv3_4' -> 'conv3.4', ...;
  * the IR-SE trunk's BatchNorm wrapper level 'norm1/norm/scale' ->
    'norm1.weight', running statistics 'mean'/'var' -> 'running_mean' /
    'running_var'; InstanceNorm 'scale' -> 'weight';
  * layouts: conv kernels HWIO -> OIHW, linear weights (in, out) ->
    (out, in) (flax Dense's 'kernel' becomes 'weight'), a generator's
    constant input NHWC -> NCHW;
  * the Inception net keeps torchvision's names ('branch5x5_1'), so its
    keys take only the BatchNorm renames.
"""

import re
from collections.abc import Mapping

import numpy as np
import torch

_LIST_MEMBER = re.compile(r"_(\d+)(?=/|$)")


def port_key(jax_key: str, list_members: bool = True) -> str:
    """The port state_dict name of one flattened JAX parameter path."""
    k = re.sub(r"/norm/(scale|bias|mean|var)$", r"/\1", jax_key)
    if list_members:
        k = _LIST_MEMBER.sub(r"/\1", k)
    k = re.sub(r"/(scale|kernel)$", "/weight", k)
    k = re.sub(r"/mean$", "/running_mean", k)
    k = re.sub(r"/var$", "/running_var", k)
    return k.replace("/", ".")


def jax_layout(key: str, ndim: int):
    """The permutation that takes a leaf's JAX axes to the port's (port
    axis i is JAX axis perm[i]), or None where the layouts agree. `key` is
    the JAX path or the port name: the rule reads only its end."""
    if key.replace(".", "/") in ("generator/input", "input"):
        return (0, 3, 1, 2)
    if key.endswith(("weight", "kernel")) and ndim == 4:
        return (3, 2, 0, 1)
    if key.endswith(("weight", "kernel")) and ndim == 2:
        return (1, 0)
    return None


def jax_first_axis(key: str, ndim: int) -> int:
    """The port axis that holds the leaf's first JAX axis (a conv kernel's
    H, a linear weight's input)."""
    perm = jax_layout(key, ndim)
    return 0 if perm is None else perm.index(0)


def port_value(jax_key: str, value) -> torch.Tensor:
    a = np.asarray(value, dtype=np.float32)
    perm = jax_layout(jax_key, a.ndim)
    if perm is not None:
        a = a.transpose(perm)
    return torch.from_numpy(np.ascontiguousarray(a))


# The JAX subtrees the port has modules for, per net. Anything else is
# left over.
_PORTED = {
    "g": re.compile(
        r"^(avg_latent|delta_latent)$"
        r"|^encoder/(trunk|style_\d+|latlayer[12])/"
        r"|^encoder/(input_conv|input_bn|input_prelu|layer[1-4]|content_\w+)/"
        r"|^encoder/style_\d+_(weight|bias)$"
        r"|^feats_conv_\d+/"
        r"|^modulation_\d+/(alignment/body|btn1)/"
        r"|^generator/(input$|conv1/|to_rgb1/|convs_\d+/|to_rgbs_\d+/|style_\d+/)"),
    "d": re.compile(r"^d/(conv0|res_\d+|final_conv|final_linear[01])/"),
    "d2": re.compile(r"^(first_linear|layer_\d+|final_linear)/"),
    "vgg": re.compile(r"^conv\d_\d/"),
    "id": re.compile(r"^(trunk|out_norm|out_norm1d)/|^linear_(weight|bias)$"),
    "psp": re.compile(r"^(trunk|style_\d+|latlayer[12])/"),
    "w_encoder": re.compile(r"^(trunk|linear)/"),
    "arcface": re.compile(r"^(conv1|bn[145]|prelu|layer[1-4]_\d+|fc5)/"),
    "gpen": re.compile(r"^(input$|conv1/|to_rgb1/|convs_\d+/|to_rgbs_\d+/|style_\d+/)"),
    "lpips": re.compile(r"^net/conv\d/|^lin\d$"),
    "inception": re.compile(r"^(Conv2d_\d[ab]_\dx\d|Mixed_\d[a-e])/"),
}
_PORTED["gcfsr"] = _PORTED["gpen"]


def from_jax_params(flat: dict, net: str = "g"):
    """Returns (state_dict, leftovers): the port's tensors for every JAX
    leaf of a ported subtree of `net` (a key of `_PORTED`: "g", "d", "d2",
    "vgg", "id", "lpips", "inception", "psp", "w_encoder", "arcface",
    "gpen" or "gcfsr"), and the JAX keys outside them. Load the
    state_dict with `load_state_dict(..., strict=True)`, which also catches
    a port tensor that no JAX leaf filled."""
    state, leftovers = {}, []
    for jk, v in flat.items():
        if _PORTED[net].match(jk):
            state[port_key(jk, net != "inception")] = port_value(jk, v)
        else:
            leftovers.append(jk)
    return state, leftovers


def from_reference_irse50(sd):
    """The ArcFace net's state_dict (`nn/irse.py:ArcFaceBackbone`) from the
    reference's torch `model_ir_se50.pth` state_dict (`input_layer`, `body.
    {i}.shortcut_layer` / `res_layer`, `output_layer`). Every tensor must
    map (BatchNorm step counters aside), or it raises; an output BatchNorm1d
    without affine parameters gets weight 1, bias 0. Torch layouts are the
    port's, so values are copied as they are."""
    renames = [
        (r"^input_layer\.0\.", "trunk.input_conv."),
        (r"^input_layer\.1\.", "trunk.input_norm."),
        (r"^input_layer\.2\.", "trunk.input_prelu."),
        (r"^body\.(\d+)\.shortcut_layer\.0\.", r"trunk.body.\1.shortcut_conv."),
        (r"^body\.(\d+)\.shortcut_layer\.1\.", r"trunk.body.\1.shortcut_norm."),
        (r"^body\.(\d+)\.res_layer\.0\.", r"trunk.body.\1.norm1."),
        (r"^body\.(\d+)\.res_layer\.1\.", r"trunk.body.\1.conv1."),
        (r"^body\.(\d+)\.res_layer\.2\.", r"trunk.body.\1.prelu."),
        (r"^body\.(\d+)\.res_layer\.3\.", r"trunk.body.\1.conv2."),
        (r"^body\.(\d+)\.res_layer\.4\.", r"trunk.body.\1.norm2."),
        (r"^body\.(\d+)\.res_layer\.5\.", r"trunk.body.\1.se."),
        (r"^output_layer\.0\.", "out_norm."),
        (r"^output_layer\.3\.weight$", "linear_weight"),
        (r"^output_layer\.3\.bias$", "linear_bias"),
        (r"^output_layer\.4\.", "out_norm1d."),
    ]
    state, leftovers = {}, []
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        for pat, rep in renames:
            if re.match(pat, k):
                state[re.sub(pat, rep, k)] = torch.as_tensor(v, dtype=torch.float32).clone()
                break
        else:
            leftovers.append(k)
    if leftovers:
        raise ValueError(f"ir_se50 tensors with no ArcFace counterpart: {sorted(leftovers)[:5]}")
    if "out_norm1d.weight" not in state:
        n = state["out_norm1d.running_mean"].shape[0]
        state["out_norm1d.weight"], state["out_norm1d.bias"] = torch.ones(n), torch.zeros(n)
    return state


def flatten_tree(tree, prefix=""):
    """{'a/b/c': leaf} of a nested mapping (a flax parameter tree)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key + "/"))
        else:
            flat[key] = v
    return flat


def load_jax_train_state(model, state):
    """Loads a JAX `TrainState` (anything with its fields) into the port
    `OODFaceGANModel` `model`: the generator's trainable and frozen trees
    into net_g, params_d into net_d, params_d2 into net_d2, the loss nets'
    'vgg' and 'id' trees into the perceptual and identity losses, each
    with strict=True, raising if a JAX leaf is left over; then the EMA
    of the trainable leaves and the path regularizer's running mean."""
    loss_nets = state.loss_net_params
    trees = [("g", {**flatten_tree(state.params_g_frozen),
                    **flatten_tree(state.params_g_train)}, model.net_g),
             ("d", flatten_tree(state.params_d), model.net_d),
             ("d2", flatten_tree(state.params_d2), model.net_d2)]
    if "vgg" in loss_nets:
        trees.append(("vgg", flatten_tree(loss_nets["vgg"]["params"]),
                      model.cri_perceptual.vgg))
    if "id" in loss_nets:
        trees.append(("id", flatten_tree(loss_nets["id"]["params"]), model.cri_id.facenet))
    for net, flat, module in trees:
        if module is None:
            if flat:
                raise ValueError(f"the JAX state has a {net} tree; the model has no such net")
            continue
        params, leftovers = from_jax_params(flat, net)
        if leftovers:
            raise ValueError(f"JAX {net} leaves the port has no module for: {leftovers}")
        module.load_state_dict(params, strict=True)
    # JAX keeps BatchNorm statistics as parameters, so an unfixed encoder
    # puts them in its EMA; the port keeps them as (never trained) buffers
    buffers = dict(model.net_g.named_buffers())
    ema = {port_key(jk): port_value(jk, v) for jk, v in flatten_tree(state.ema_train).items()}
    if set(ema) - set(buffers) != set(model.ema):
        raise ValueError("the JAX EMA's leaves are not the model's trainable parameters")
    with torch.no_grad():
        for k, p in model.ema.items():
            p.copy_(ema[k])
        model.mean_path_length.fill_(float(np.asarray(state.mean_path_length)))
