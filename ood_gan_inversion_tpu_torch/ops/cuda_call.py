"""What the CUDA kernel wrappers share: the operand checks, the choice
between the kernel (CUDA tensors) and the plain version (CPU tensors), and
the ctypes binding and call of a kernel's C entry point."""

import ctypes
import functools

import torch

from .. import build

# operand dtype codes of the C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def expect(name, t, shape, dtype):
    """Raises unless t is a `dtype` tensor of `shape`."""
    if t is None or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        got = None if t is None else f"{t.dtype} {tuple(t.shape)}"
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got {got}")


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


def launch(what, fn, x, *args):
    """Calls the C entry point fn with args and the current stream of x's
    device; raises if it reports an error."""
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: error {err}")
