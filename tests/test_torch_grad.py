"""Gradients through the port's kernel wrappers on the CPU, against jax.grad
(jax.vjp) of the JAX package's counterparts.

Each kernel wrapper records its call as a torch.autograd.Function whose
backward differentiates the plain version, as the JAX package's custom_vjp
rules differentiate their references. On the CPU the Function's forward is
the plain version itself; the JAX side runs its Pallas kernels in interpret
mode, as the JAX package's own tests do, and its backward through the
reference. Inputs and cotangents come from numpy seeds; the loss is
sum(out * cotangent). Tolerances, as max|got - ref| / max|ref| per
gradient: 1e-5 for the warp (elementwise float32 arithmetic), 1e-4 for the
convolutions (float32 sums in another order than XLA's)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import warp_inputs
from torch_parity import max_rel_err

from ood_gan_inversion_tpu_torch.ops import (alignnet, halo_probe, packed_conv, samm_conv,
                                             warp_blend)

j_pk = importlib.import_module("ood_gan_inversion_tpu.ops.pallas_kernels")
j_warp = importlib.import_module("ood_gan_inversion_tpu.ops.pallas_warp")
T = torch.from_numpy
WARP_TOL, CONV_TOL = 1e-5, 1e-4


def leaves(arrays):
    """Float32 numpy arrays as torch leaves that require grad."""
    return [T(np.array(a, np.float32)).requires_grad_() for a in arrays]


def cotangent(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def backward_nodes(t):
    """The class names of every node of t's autograd graph."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(f for f, _ in node.next_functions)
    return names


def port_grads(outs, inputs, cts):
    """Gradients of sum(out * ct) over the outputs whose ct is not None."""
    used = [(o, T(c)) for o, c in zip(outs, cts) if c is not None]
    return torch.autograd.grad([o for o, _ in used], inputs, [c for _, c in used])


def assert_grads_close(got, ref, tol, layout=None):
    """Each gradient within tol of max|ref|; layout[i] maps the port's
    gradient i to the JAX layout."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy() if layout is None or layout[i] is None else layout[i](g.numpy())
        assert g.shape == np.shape(r), i
        assert max_rel_err(g, r) < tol, (i, max_rel_err(g, r))


def test_warp_blend_grad_matches_jax():
    """B1: gradients for target, grid and alpha against the VJP of JAX's
    warp_blend_reference (what mxu_warp_blend's custom_vjp runs); the flow
    reaches past the border, so masked taps are differentiated too."""
    arrays = warp_inputs(2, 16, 8, 0.08, seed=3)
    x = leaves(arrays)
    out = warp_blend.warp_blend(*x)
    assert type(out.grad_fn).__name__ == "WarpBlendBackward"
    ct = cotangent(out.shape, 4)
    ref_out, vjp = jax.vjp(j_warp.warp_blend_reference, *map(jnp.asarray, arrays))
    assert max_rel_err(out.detach().numpy(), ref_out) < WARP_TOL
    assert_grads_close(port_grads([out], x, [ct]), vjp(jnp.asarray(ct)), WARP_TOL)


def pair_arrays(b, h, c1, c4, seed):
    """The packed pair's operands, as tests/test_torch_packed.py makes them."""
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, h, c1), 0.1 * rs.randn(b, h, h, 4), 0.1 * rs.randn(b, h, h, 4),
            rs.randn(3, 3, c1, c4) * 0.2, rs.rand(b, c1) + 0.5, rs.rand(b, c4) + 0.5,
            0.1 * rs.randn(c4), rs.randn(3, 3, c4, c4) * 0.2, rs.rand(b, c4) + 0.5,
            rs.rand(b, c4) + 0.5, 0.1 * rs.randn(c4)]


def test_packed_pair_grad_matches_jax():
    """B3: the port's pair is two B3 Functions; its 11 gradients against
    jax.vjp of JAX's fused_packed_pair (the Pallas pair in interpret mode,
    its backward through packed_pair_reference)."""
    arrays = [np.asarray(a, np.float32) for a in pair_arrays(2, 8, 8, 16, seed=5)]
    x = leaves(arrays)
    out = packed_conv.fused_packed_pair(*x)
    assert type(out.grad_fn).__name__ == "PackedConv3x3ActBackward"
    assert backward_nodes(out).count("PackedConv3x3ActBackward") == 2
    ct = cotangent(out.shape, 6)
    ref_out, vjp = jax.vjp(j_pk.fused_packed_pair, *map(jnp.asarray, arrays))
    assert max_rel_err(out.detach().numpy(), ref_out) < CONV_TOL
    assert_grads_close(port_grads([out], x, [ct]), vjp(jnp.asarray(ct)), CONV_TOL)


@pytest.mark.parametrize("z2_loss", [True, False])
def test_packed_stage_grad_matches_jax(z2_loss):
    """B4: the 15 gradients against jax.vjp of JAX's fused_packed_stage
    (interpret mode), with the loss on rgb and z2, and on rgb alone (z2's
    cotangent None on the port's side, zeros on JAX's)."""
    rs = np.random.RandomState(7)
    b, h, c1, c4 = 2, 8, 8, 16
    pair = pair_arrays(b, h, c1, c4, seed=8)
    arrays = [np.asarray(a, np.float32) for a in (
        pair[0], pair[1], pair[2], rs.randn(b, h, h, 3), *pair[3:],
        (rs.rand(b, c4) + 0.5)[:, :, None] * (rs.randn(c4, 12) * 0.2)[None],
        0.1 * rs.randn(12), 0.1 * rs.randn(3, 3, 3, 12))]
    x = leaves(arrays)
    rgb, z2 = packed_conv.fused_packed_stage(*x)
    assert type(rgb.grad_fn).__name__ == type(z2.grad_fn).__name__ == "PackedStageBackward"
    cts = [cotangent(rgb.shape, 9), cotangent(z2.shape, 10) if z2_loss else None]
    ref_outs, vjp = jax.vjp(j_pk.fused_packed_stage, *map(jnp.asarray, arrays))
    for got, ref in zip((rgb, z2), ref_outs):
        assert max_rel_err(got.detach().numpy(), ref) < CONV_TOL
    ref = vjp(tuple(jnp.asarray(c if c is not None else np.zeros(z2.shape, np.float32))
                    for c in cts))
    assert_grads_close(port_grads([rgb, z2], x, cts), ref, CONV_TOL)


def nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def oihw(k):
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("act", ["prelu", "lrelu", "none"])
def test_conv3x3_act_grad_matches_jax(act):
    """B5: gradients for x, k (and the PReLU slopes) against jax.vjp of
    JAX's conv3x3_act (interpret mode), NHWC/HWIO there, NCHW/OIHW here."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 8, 8, 32).astype(np.float32)
    k = (rs.randn(3, 3, 32, 48) * 0.1).astype(np.float32)
    alpha = (0.25 + 0.05 * rs.randn(48)).astype(np.float32)
    port = leaves([nchw(x), oihw(k)] + ([alpha] if act == "prelu" else []))
    out = samm_conv.conv3x3_act(*port[:2], port[2] if act == "prelu" else None, act)
    assert type(out.grad_fn).__name__ == "Conv3x3ActBackward"
    ct = cotangent((2, 8, 8, 48), 12)
    ref_out, vjp = jax.vjp(lambda *a: j_pk.conv3x3_act(*a, act),
                           jnp.asarray(x), jnp.asarray(k), jnp.asarray(alpha))
    assert max_rel_err(out.detach().numpy().transpose(0, 2, 3, 1), ref_out) < CONV_TOL
    ref = vjp(jnp.asarray(ct))
    got = port_grads([out], port, [nchw(ct)])
    assert_grads_close(got, ref[:len(got)], CONV_TOL,
                       [lambda g: g.transpose(0, 2, 3, 1), lambda g: g.transpose(2, 3, 1, 0), None])


@pytest.mark.parametrize("diff_f_and_g", [True, False])
def test_fused_alignnet_body0_grad_matches_jax(diff_f_and_g):
    """B2a + B2b: the port's fused body0 composes the two Functions between
    plain passes; its 9 gradients against jax.vjp of JAX's
    fused_alignnet_body0 (Pallas in interpret mode, backward through the
    literal module dataflow). The op is called directly, so no channel
    floor applies."""
    rs = np.random.RandomState(13)
    b, h, c = 2, 8, 16
    c2 = 2 * c
    s, t = rs.randn(b, h, h, c), 2 * rs.randn(b, h, h, c) + 0.3
    k1, k2 = (rs.randn(3, 3, c2, c2) / np.sqrt(9 * c2) for _ in range(2))
    g1, b1 = 1 + 0.1 * rs.randn(c2), 0.1 * rs.randn(c2)
    alpha, g2, b2 = 0.25 + 0.05 * rs.randn(c2), 1 + 0.1 * rs.randn(c2), 0.1 * rs.randn(c2)
    arrays = [np.asarray(a, np.float32) for a in (s, t, g1, b1, k1, alpha, k2, g2, b2)]
    port = leaves([nchw(arrays[0]), nchw(arrays[1]), arrays[2], arrays[3], oihw(arrays[4]),
                   arrays[5], oihw(arrays[6]), arrays[7], arrays[8]])
    out = alignnet.fused_alignnet_body0(*port, diff_f_and_g)
    nodes = backward_nodes(out)
    assert nodes.count("AlignNetConv1Backward") == nodes.count("AlignNetConv2Backward") == 1
    ct = cotangent((b, h, h, c2), 14)
    ref_out, vjp = jax.vjp(lambda *a: j_pk.fused_alignnet_body0(*a, diff_f_and_g),
                           *map(jnp.asarray, arrays))
    assert max_rel_err(out.detach().numpy().transpose(0, 2, 3, 1), ref_out) < CONV_TOL
    to_nhwc, to_hwio = (lambda g: g.transpose(0, 2, 3, 1)), (lambda g: g.transpose(2, 3, 1, 0))
    assert_grads_close(port_grads([out], port, [nchw(ct)]), vjp(jnp.asarray(ct)), CONV_TOL,
                       [to_nhwc, to_nhwc, None, None, to_hwio, None, to_hwio, None, None])


def test_alignnet_conv2_grad_without_moments_loss():
    """B2b with the loss on y2 alone (the moments' cotangent None): the
    Function's gradients equal autograd of its plain version on the same
    loss."""
    rs = np.random.RandomState(15)
    arrays = [rs.randn(2, 12, 6, 7), rs.randn(12, 12, 3, 3) * 0.1]
    z, k = leaves(arrays)
    y2, part = alignnet.alignnet_conv2(z, k)
    assert type(part.grad_fn).__name__ == "AlignNetConv2Backward"
    ct = cotangent(y2.shape, 16)
    got = port_grads([y2, part], [z, k], [ct, None])
    z2, k2 = leaves(arrays)
    ref = port_grads([alignnet.alignnet_conv2_reference(z2, k2)[0]], [z2, k2], [ct])
    assert_grads_close(got, [r.numpy() for r in ref], 1e-6)


def test_box3x3_grad_matches_its_plain_version():
    """The probe: JAX has no VJP for it. Its gradient is the box sum of the
    cotangent (the zero-halo box is its own adjoint), and equals autograd of
    the plain version."""
    x = leaves([np.random.RandomState(17).randn(9, 11)])
    out = halo_probe.box3x3(x[0])
    assert type(out.grad_fn).__name__ == "Box3x3Backward"
    ct = cotangent(out.shape, 18)
    (got,) = port_grads([out], x, [ct])
    y = leaves([x[0].detach().numpy()])
    (twin,) = port_grads([halo_probe.box3x3_reference(y[0])], y, [ct])
    assert torch.equal(got, twin)
    assert max_rel_err(got.numpy(), halo_probe.box3x3_reference(T(ct)).numpy()) < 1e-6


def wrapper_cases(requires_grad):
    """Each kernel wrapper on small CPU tensors: (name of its Function,
    wrapper, plain version, arguments) rows."""
    rs = np.random.RandomState(19)
    leaf = lambda v: T(np.asarray(v, np.float32)).requires_grad_(requires_grad)
    r = lambda *shape: leaf(rs.randn(*shape))
    w = [leaf(a) for a in warp_inputs(1, 8, 4, 0.08, seed=20)]
    pair = [leaf(a) for a in pair_arrays(1, 6, 4, 8, 21)]
    stage = pair[:3] + [r(1, 6, 6, 3)] + pair[3:] + [r(1, 8, 12), r(12), r(3, 3, 3, 12)]
    s, t, coeffs, k1, a1 = r(1, 4, 5, 6), r(1, 4, 5, 6), r(1, 5, 4), r(8, 8, 3, 3), r(8)
    z, x = r(1, 8, 5, 6), r(5, 6)
    return [("WarpBlend", warp_blend.warp_blend, warp_blend.warp_blend_reference, w),
            ("PackedConv3x3Act", packed_conv.fused_conv3x3_act,
             packed_conv.packed_conv3x3_act_reference, [pair[0], pair[1], *pair[3:7]]),
            ("PackedStage", packed_conv.fused_packed_stage, packed_conv.packed_stage_reference,
             stage),
            ("AlignNetConv1", alignnet.alignnet_conv1, alignnet.alignnet_conv1_reference,
             [s, t, coeffs, k1, a1]),
            ("AlignNetConv2", alignnet.alignnet_conv2, alignnet.alignnet_conv2_reference,
             [z, k1]),
            ("Conv3x3Act", samm_conv.conv3x3_act, samm_conv.conv3x3_act_reference,
             [z, k1, a1, "prelu"]),
            ("Box3x3", halo_probe.box3x3, halo_probe.box3x3_reference, [x])]


def wrapper_calls(requires_grad):
    """Each kernel wrapper called on small CPU tensors: (name of its
    Function, thunk returning its first output) pairs."""
    def call(fn, args):
        out = fn(*args)
        return out[0] if isinstance(out, tuple) else out

    return [(name, lambda fn=fn, args=args: call(fn, args))
            for name, fn, _, args in wrapper_cases(requires_grad)]


def second_order(fn, args, seed):
    """Gradients, for every tensor argument, of sum(grad * v) over the
    arguments, where grad is the gradient of sum(out * ct): a gradient of a
    gradient. ct and v come from numpy seed `seed`; returns (first-order
    gradients, second-order gradients)."""
    rs = np.random.RandomState(seed)
    x = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) else a
         for a in args]
    wrt = [a for a in x if isinstance(a, torch.Tensor)]
    outs = fn(*x)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cts = [T(rs.randn(*o.shape).astype(np.float32)) for o in outs]
    grads = torch.autograd.grad(outs, wrt, cts, create_graph=True)
    loss = sum((g * T(rs.randn(*g.shape).astype(np.float32))).sum() for g in grads)
    if not loss.requires_grad:          # a linear function: no second order
        return grads, [None] * len(wrt)
    return grads, torch.autograd.grad(loss, wrt, allow_unused=True)


FUNCTIONS = ["WarpBlend", "PackedConv3x3Act", "PackedStage", "AlignNetConv1",
             "AlignNetConv2", "Conv3x3Act", "Box3x3"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_grad_of_grad_matches_its_plain_version(name):
    """Under create_graph each Function's gradients differentiate again, to
    the plain version's own second-order gradients (within 1e-6 of max|ref|:
    the same computation), which are not all zero but for the probe's (a
    linear map)."""
    _, fn, twin, args = next(c for c in wrapper_cases(True) if c[0] == name)
    grads, got = second_order(fn, args, seed=22)
    ref_grads, ref = second_order(twin, args, seed=22)
    assert [g.grad_fn is None for g in grads] == [r.grad_fn is None for r in ref_grads]
    assert any(r is not None and float(r.abs().max()) > 0 for r in ref) != (name == "Box3x3")
    for i, (g, r) in enumerate(zip(got, ref)):
        assert (g is None) == (r is None), i
        if r is not None:
            assert max_rel_err(g.detach().numpy(), r.detach().numpy()) <= 1e-6, i
    for g, r in zip(grads, ref_grads):
        assert max_rel_err(g.detach().numpy(), r.detach().numpy()) <= 1e-6


def test_warp_blend_grad_of_grad_matches_jax():
    """B1 at second order: sum(grad * v), grad the gradient of sum(out * ct),
    differentiated again against jax.grad of the same sum through
    mxu_warp_blend's custom_vjp backward rule (the VJP of
    warp_blend_reference). Tolerance 1e-5 of max|ref|."""
    arrays = warp_inputs(2, 16, 8, 0.08, seed=23)
    rs = np.random.RandomState(24)
    ct = rs.randn(*arrays[0].shape).astype(np.float32)
    v = [rs.randn(*a.shape).astype(np.float32) for a in arrays]
    x = leaves(arrays)
    grads = torch.autograd.grad(warp_blend.warp_blend(*x), x, T(ct), create_graph=True)
    got = torch.autograd.grad(sum((g * T(vi)).sum() for g, vi in zip(grads, v)), x)

    def vjp_dot_v(*a):
        g = j_warp._bwd(None, a, jnp.asarray(ct))
        return sum(jnp.sum(gi * jnp.asarray(vi)) for gi, vi in zip(g, v))

    ref = jax.grad(vjp_dot_v, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    assert_grads_close(got, ref, WARP_TOL)


def refuse_apply(monkeypatch):
    """Makes every torch.autograd.Function's apply raise."""
    def refuse(cls, *args):
        raise AssertionError(f"{cls.__name__}.apply called")

    monkeypatch.setattr(torch.autograd.Function, "apply", classmethod(refuse))


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_wrappers_skip_autograd_without_grad_mode(mode, monkeypatch):
    """Under torch.inference_mode() and torch.no_grad() every wrapper runs
    without its Function (Function.apply is made to raise) and returns a
    tensor with no grad_fn, inputs that require grad notwithstanding; with
    grad on, each records its Function."""
    calls = wrapper_calls(requires_grad=True)
    for name, fn in calls:
        assert type(fn().grad_fn).__name__ == name + "Backward"
    refuse_apply(monkeypatch)
    with getattr(torch, mode)():
        for name, fn in calls:
            assert fn().grad_fn is None, name


def test_wrappers_skip_autograd_without_inputs_that_require_grad(monkeypatch):
    """Grad mode on, but no input requires grad: no Function, no graph."""
    refuse_apply(monkeypatch)
    for name, fn in wrapper_calls(requires_grad=False):
        out = fn()
        assert not out.requires_grad and out.grad_fn is None, name
