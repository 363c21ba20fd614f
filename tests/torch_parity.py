"""Shared helpers of the tests that hold the PyTorch port against the JAX
package on the CPU: seeded parameter trees, the weights bridge, layouts."""

import ctypes
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ood_gan_inversion_tpu_torch.convert import from_jax_params

# xdist runs several test workers side by side on the host's cores
torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def release_freed_memory():
    """When a worker leaves the module, hands the memory its tests freed
    back to the system. glibc keeps freed blocks in its arenas, so a
    worker's resident size stays at its largest test's for the rest of the
    run (a JAX forward and a micro train step leave ~2-4 GB), and the
    tier-1 run's six workers together come near the host's memory.
    Autouse in each test file that imports it by name."""
    yield
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def fill_params(shapes, seed):
    """A flat {'a/b/c': float32 array} tree with the shapes of `shapes`
    (a pytree of ShapeDtypeStructs, e.g. from jax.eval_shape), filled from a
    numpy seed: conv kernels scaled by 1/sqrt(fan_in) outside the
    generator (whose equalized-lr weights are N(0, 1) at init), BatchNorm
    variances positive, scales near 1, everything else small."""
    rs = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(shapes)
    out = {}
    for k, sd in sorted(flat.items()):
        key, shape = "/".join(k), tuple(sd.shape)
        leaf = k[-1]
        if leaf == "var":
            v = rs.uniform(0.5, 1.5, shape)
        elif leaf == "scale":
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif leaf == "prelu" or (len(k) > 1 and "prelu" in k[-2]):
            v = 0.25 + 0.05 * rs.randn(*shape)
        elif leaf == "weight" and len(shape) == 4 and k[0] != "generator":
            v = rs.randn(*shape) / np.sqrt(np.prod(shape[:3]))
        elif leaf in ("weight", "input") and len(shape) >= 2:
            v = rs.randn(*shape)
        elif key.endswith("modulation/bias"):
            v = 1.0 + 0.1 * rs.randn(*shape)
        else:
            v = 0.1 * rs.randn(*shape)
        out[key] = v.astype(np.float32)
    return out


def jax_tree(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def init_shapes(module, *args, **kwargs):
    """The parameter shapes of a flax module, traced without computing."""
    rng = jax.random.PRNGKey(0)
    return jax.eval_shape(
        functools.partial(module.init, **kwargs),
        {"params": rng, "noise": rng}, *args)["params"]


def with_style_mlp(flat, jmodule, style_dim, seed):
    """flat plus the style MLP's leaves of the JAX Generator or arch
    `jmodule`, filled from `seed` (flat's own leaves kept as they are). A flax module creates a parameter where
    it is first used, so a tree traced through the decode alone has no
    style MLP; the port's Generator holds it from construction, as the
    tree of JAX's training model does (its init runs random_latents)."""
    method = getattr(type(jmodule), "random_latents", None) or type(jmodule).style_mlp
    z = jnp.zeros((1, style_dim), jnp.float32)
    shapes = jax.eval_shape(lambda r: jmodule.init(r, z, method=method),
                            jax.random.PRNGKey(0))["params"]
    return {**fill_params(shapes, seed), **flat}


def load_port(module, flat, prefix="", net="g"):
    """Loads a JAX flat tree into a port module through the bridge;
    asserts that no JAX leaf is left over and that the load is strict.
    `prefix`: the module's path in the arch tree (e.g. "generator/") when
    the tree is a submodule's; `net`: the bridge's net (from_jax_params)."""
    state, leftovers = from_jax_params({prefix + k: v for k, v in flat.items()}, net)
    assert leftovers == []
    n = len(prefix.replace("/", "."))
    module.load_state_dict({k[n:]: v for k, v in state.items()}, strict=True)
    return module.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def max_rel_err(got, ref):
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))
