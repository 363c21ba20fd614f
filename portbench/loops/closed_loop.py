"""The closed loop of batch inversion: a client that keeps `ahead` calls
queued beyond the one whose outputs it waits for.

Each call is `invert_batch_perkey(images, seeds, outputs)` of `batch`
images drawn from the pool, which queues the forward and returns; its
`image` and `mask` are then queued for copying into pinned host memory,
and the call is done when the copy has landed. With `ahead` 1, call k + 1
is queued before the client waits for call k's outputs, so the device
does not wait for the host's read. Calls are dispatched until the window's
`seconds` have passed; a call counts when its outputs reached the host
within them. `check_batches` of the counted calls, drawn from the seed by
reservoir sampling, keep their outputs for the check.

When a copy landed is read from its own CUDA event, timed against one
that opens the window on the idle stream (the window starts on the host
clock once that one has run), and put on the host clock from there: the
host, busy queuing the next call, would see it late. On the CPU a call's
work is done when it returns.

Host spans: "entry" around each dispatch, "readback" around each wait.
"""

import collections

import numpy as np
import torch

from portbench.devtrace import now_ns

OUTPUTS = ("image", "mask", "lats", "gen_image")


class _Slots:
    """`n` reusable host buffers for a call's image and mask (pinned on the
    card), and a fence per call."""

    def __init__(self, run, n):
        t = run.traffic
        shape = (t["batch"], t["image_size"], t["image_size"])
        pin = run.device.type == "cuda"
        self.bufs = [(torch.empty(*shape, 3, pin_memory=pin), torch.empty(*shape, 1, pin_memory=pin))
                     for _ in range(n)]
        self.at = 0
        self.cuda = pin

    def read(self, out):
        """Queues the copy of out's image and mask to host; returns a fence."""
        img, mask = self.bufs[self.at]
        self.at = (self.at + 1) % len(self.bufs)
        img.copy_(out["image"], non_blocking=self.cuda)
        mask.copy_(out["mask"], non_blocking=self.cuda)
        return _event() if self.cuda else None


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _dispatch(run, slots):
    idx, seeds = run.requests.next()
    t0 = now_ns()
    out = run.system.invert_batch_perkey([run.pool[i] for i in idx], seeds, OUTPUTS)
    t1 = now_ns()
    run.spans.append(("entry", t0, t1))
    return {"idx": idx, "seeds": seeds, "out": out, "fence": slots.read(out),
            "t_entry": t0, "entry_ns": t1 - t0, "t_returned": t1}


def _wait(run, call, start=None):
    """Waits for the call's outputs; its t_done is when they landed (from
    its event and the window's `start` event on the card)."""
    t0 = now_ns()
    fence = call["fence"]
    if fence is None:
        call["t_done"] = call["t_returned"]
    else:
        fence.synchronize()
        call["t_done"] = (run.t_start_ns + int(start.elapsed_time(fence) * 1e6)
                          if start is not None else now_ns())
    run.spans.append(("readback", t0, now_ns()))


def warm_up(run):
    """Two calls of the cell's batch, through the window's own path."""
    slots = _Slots(run, run.traffic["ahead"] + 1)
    for _ in range(2):
        _wait(run, _dispatch(run, slots))
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.spans.clear()
    run.slots = slots


def window(run):
    ahead, keep = run.traffic["ahead"], run.traffic["check_batches"]
    rng = np.random.default_rng(run.sample_seed)
    pending, seen = collections.deque(), 0
    start = _event() if run.slots.cuda else None
    if start is not None:
        start.synchronize()
    run.t_start_ns = now_ns()
    deadline = run.t_start_ns + int(run.seconds * 1e9)
    while True:
        while len(pending) <= ahead and now_ns() < deadline:
            pending.append(_dispatch(run, run.slots))
        if not pending:
            break
        call = pending.popleft()
        _wait(run, call, start)
        out = call.pop("out")
        call["fence"] = None
        call["counted"] = call["t_done"] <= deadline
        run.calls.append(call)
        if not call["counted"]:
            continue
        run.t_end_ns = call["t_done"]
        sample = (call["idx"], call["seeds"], out)
        if seen < keep:
            run.samples.append(sample)
        else:
            j = int(rng.integers(0, seen + 1))
            if j < keep:
                run.samples[j] = sample
        seen += 1
