"""What the CUDA kernel wrappers share: the operand checks, the choice
between the kernel (CUDA tensors) and the plain version (CPU tensors), the
ctypes binding and call of a kernel's C entry point, and the autograd
Function that gives each kernel a backward.

A kernel's backward differentiates its plain version (its "twin"), as the
JAX package's custom_vjp rules differentiate their references: the
Function saves the inputs, and its backward recomputes the twin on them
under autograd. Where autograd records nothing (grad mode off, as under
`torch.no_grad` or `torch.inference_mode`, or no input that requires grad)
a wrapper calls its kernel directly, without the Function."""

import ctypes
import functools
import threading
import types

import torch

from .. import build

# operand dtype codes of the C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# guards every wrapper's `.launches`: a server's dispatch threads launch
# kernels concurrently, and `+= 1` on an attribute is not atomic
_count_lock = threading.Lock()


def expect(name, t, shape, dtype):
    """Raises unless t is a `dtype` tensor of `shape`."""
    if t is None or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        got = None if t is None else f"{t.dtype} {tuple(t.shape)}"
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got {got}")


def widen(v):
    """A bfloat16 operand as float32 (exact), any other as it is: the
    operands of a kernel's plain version, which multiplies them exactly and
    sums in float32 as the kernel's tensor cores do."""
    return v.float() if v.dtype == torch.bfloat16 else v


def activation(x, what):
    """The dtype code of x, a float32 or bfloat16 (B, C, H, W) operand."""
    if x.dim() != 4 or x.dtype not in DTYPES:
        raise ValueError(f"{what}: input must be float32 or bfloat16 (B, C, H, W), "
                         f"got {x.dtype} {tuple(x.shape)}")
    return DTYPES[x.dtype]


def on_card(what, tensors):
    """True for CUDA tensors, False for CPU tensors; raises on mixed
    devices, other devices and non-contiguous CUDA operands."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")
    return True


@functools.cache
def entry(lib: str, name: str, n_ptrs: int, n_ints: int, stream: bool = True):
    """The C entry point `name` of csrc/<lib>.cu (built at first use): n_ptrs
    pointers, n_ints ints, then the stream if it takes one; returns an int."""
    fn = getattr(build.load(lib), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p] * stream)
    fn.restype = ctypes.c_int
    return fn


def count_launch(counter):
    """Adds one to `counter.launches`, under the lock."""
    with _count_lock:
        counter.launches += 1


def launch(counter, what, fn, x, *args):
    """Calls the C entry point fn with args and the current stream of x's
    device; raises if it reports an error, else counts the launch on
    `counter` (the wrapper)."""
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: error {err}")
    count_launch(counter)


def twin_function(name, run, twin):
    """A torch.autograd.Function `name` whose forward is run(*args) (the
    kernel for CUDA tensors, the plain version for CPU tensors) and whose
    backward is torch.autograd.grad of twin(*args) on the saved inputs.
    Arguments that are not tensors (an activation's name, an absent
    operand) pass through and get no gradient; a cotangent that is None
    (an output the loss does not use) adds nothing. Under create_graph the
    gradients are the twin's own partial derivatives, so they differentiate
    again, through the twin. `.run` is `run`."""

    def forward(ctx, *args):
        ctx.set_materialize_grads(False)
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.args = [None if i in ctx.tensor_at else a for i, a in enumerate(args)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return run(*args)

    def backward(ctx, *cotangents):
        # grad mode is on here only under create_graph: then the twin runs on
        # a view of each saved input, so its gradients are differentiable in
        # turn w.r.t. the inputs (a gradient of a gradient, as JAX's
        # custom_vjp rules allow). The views keep autograd.grad to the
        # partial derivatives: on the inputs themselves it would also follow
        # paths from one input to another through the graph that made them
        # (SAMM computes alpha and the grid from the target), and the outer
        # backward would count those paths twice.
        create = torch.is_grad_enabled()
        args = list(ctx.args)
        wrt = [i for i in ctx.tensor_at if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
                args[i] = (t.view_as(t) if create
                           else t.detach().requires_grad_(ctx.needs_input_grad[i]))
            outs = twin(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, cotangents)
                     if g is not None and o.requires_grad]
            grads = [None] * len(wrt)
            if pairs and wrt:
                grads = torch.autograd.grad([o for o, _ in pairs], [args[i] for i in wrt],
                                            [g for _, g in pairs], allow_unused=True,
                                            create_graph=create)
        out = [None] * len(args)
        for i, g in zip(wrt, grads):
            out[i] = g
        return tuple(out)

    def body(ns):
        ns.update(forward=staticmethod(forward), backward=staticmethod(backward),
                  run=staticmethod(run))

    return types.new_class(name, (torch.autograd.Function,), exec_body=body)


def dispatch(fn, *args):
    """fn.run(*args), through the Function fn where autograd records the
    call: grad mode on and a tensor argument that requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return fn.apply(*args)
    return fn.run(*args)
