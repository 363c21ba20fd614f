"""Which ops of a batched forward compute a sample differently from the same
sample alone. No JAX here, so the card tests can use it too.

`batch_dependent_ops` runs one batched per-seed forward of an engine under
a TorchDispatchMode that replays every op whose output carries the batch's
rows on one sample's rows of its operands, and compares the bits with that
sample's rows of the batched output. Ops that only move or make data are
not replayed; the hand-written kernels are not aten ops and are not seen.
The batch should be 5: no width or channel count of the models is a
multiple of 5, so an operand is sliced only where it has the batch's rows.
"""

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

# ops that move, view or make data: they sum nothing, and some take the
# batch size as an argument (reshape) or index across it (index)
MOVES = {"view", "_unsafe_view", "reshape", "expand", "select", "slice", "permute",
         "transpose", "t", "unsqueeze", "squeeze", "alias", "detach", "clone", "copy_",
         "_to_copy", "empty", "new_empty", "zeros", "new_zeros", "ones", "new_ones",
         "full", "new_full", "arange", "empty_like", "empty_strided", "cat", "stack",
         "index", "lift_fresh"}


class _Replay(TorchDispatchMode):
    def __init__(self, batch, row):
        super().__init__()
        self.batch, self.row, self.differ = batch, row, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if (not isinstance(out, torch.Tensor) or out.dim() == 0
                or out.shape[0] % self.batch or name in MOVES):
            return out
        k = out.shape[0] // self.batch
        lo, hi = self.row * k, (self.row + 1) * k

        def rows(a):
            if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == k * self.batch:
                return a[lo:hi]
            return a

        one = func(*tree_map(rows, args), **tree_map(rows, kwargs))
        if not torch.equal(one, out[lo:hi]):
            shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            key = (name, str(out.dtype), shapes)
            err = float((one.float() - out[lo:hi].float()).abs().max())
            self.differ[key] = max(self.differ.get(key, 0.0), err)
        return out


def batch_dependent_ops(engine, batch=5, row=None, seed=0):
    """{(op, dtype, operand shapes): max|diff|} of the ops of one batched
    per-seed forward of `engine` (InversionEngine) on `batch` random images
    whose rows for sample `row` (the last by default) differ from the op
    computed on that sample alone."""
    rs = np.random.RandomState(seed)
    imgs = [rs.rand(engine.out_size, engine.out_size, 3).astype(np.float32)
            for _ in range(batch)]
    x = engine.input_batch(imgs)
    noise = engine._noise(range(batch))
    mode = _Replay(batch, batch - 1 if row is None else row)
    with torch.inference_mode(), mode:
        engine.net(x, mod_size=engine.mod_size, noise=noise)
    return mode.differ
