"""The port's spans: named intervals at the layer boundaries of an
inversion, timed on the host and on the card.

    with trace.span("encoder", n=x.shape[0]):
        ...

Tracing is on exactly while a `torch.profiler` session runs (any
activities): a profiled run records the spans, an unprofiled one pays one
flag check per span. Off, `span` returns one shared no-op object; it
allocates nothing, takes no lock and makes no CUDA call.

On, a span records a `Span`: its name; its id, its parent's (the span open
on the same thread when it opened) and its call's (the id of the outermost
span of its thread: one per engine `invert*` call, shared by all the spans
of that call); its thread; its host start and end on `time.time_ns()`,
which is the clock of the profiler's own events; `n`, the images it works
on; and, once CUDA is initialised, a pair of timing events recorded on the
current stream at entry and exit. It also enters
`torch.profiler.record_function(name)`, so the profiler's trace carries the
same names.

A span's device time (`Span.device_ms`, read after the caller has
synchronised) is the stream's time between its two events: the span's own
work, plus any time the card waited inside it for the host. A host-only
span such as `input` therefore reads ~0 while the card is still busy with
the previous call, and reads the idle time it caused once the card has
drained. On a mesh the events time the current device's stream only.

Spans of the engine's forward (a `.<res>` suffix is the stage's output
side in pixels):
    invert       a public `InversionEngine.invert*` call
    input        img2input of each image and their concatenation
    upload       the pinned copy of the input to the card
    noise        the per-seed noise draws
    forward      the arch's forward
    encoder      one pass of the encoder network (ReStyle: one per cycle)
    encoder.content  FeatureStyle's content branch, inside `encoder` (its
                 output reaches the decode only with `inject_content`)
    adapt        the W+ offsets and the 1x1 feature adapters
    decode.<res> one generator stage (conv1 + to_rgb1 for 4)
    samm.<res>   the SAMM block of a conditioned stage
    blend        the mask compositing and the blend

Records are kept in memory, the newest `CAPACITY`; `spans()` returns them
and `dropped()` counts those pushed out. A span's self time, on either
clock, is its duration less the part its children cover (`self_times`).
"""

import collections
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 17

_records = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_dropped = 0


class Span:
    """One recorded span; t0_ns, t1_ns on `time.time_ns()`."""

    __slots__ = ("name", "id", "parent", "call", "thread", "t0_ns", "t1_ns", "n",
                 "_events", "_outer", "_rf")

    def __init__(self, name, n):
        self.name, self.n = name, n
        self.t0_ns = self.t1_ns = None
        self._events = None

    def __enter__(self):
        global _dropped
        self.t0_ns = time.time_ns()
        outer = getattr(_local, "open", None)
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else None
        self.call = outer.call if outer is not None else self.id
        self.thread = threading.get_ident()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._outer = outer
        _local.open = self
        with _lock:
            if len(_records) == CAPACITY:
                _dropped += 1
            _records.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        self._rf.__exit__(*exc)
        self._rf = None
        _local.open = self._outer
        self._outer = None
        self.t1_ns = time.time_ns()
        return False

    @property
    def host_ms(self):
        return (self.t1_ns - self.t0_ns) / 1e6

    @property
    def device_ms(self):
        """The stream's time between the span's events (None without CUDA);
        the caller must have synchronised."""
        return None if self._events is None else self._events[0].elapsed_time(self._events[1])


class _Off:
    """The span of an untraced run: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, n=None):
    """A context manager around one layer's work; see the module docstring."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, n)


def spans():
    """The kept records, oldest first (a span still open has t1_ns None)."""
    with _lock:
        return list(_records)


def dropped():
    """How many records the bounded buffer has pushed out."""
    return _dropped


def durations(records, clock="host"):
    """{span id: duration in ms} of closed `records` on the "host" or the
    "device" clock (the caller must have synchronised); None where a span
    has no device time."""
    if clock == "host":
        return {r.id: r.host_ms for r in records}
    out = {r.id: r.device_ms for r in records}
    return None if any(v is None for v in out.values()) else out


def self_times(records, clock="host"):
    """{span id: self time in ms} of closed `records` (whole calls): its
    duration less the part its children cover. The children of one span
    ran one after another on its thread and on its stream, so that part
    is the sum of their durations. None as `durations`."""
    own = durations(records, clock)
    if own is None:
        return None
    out = dict(own)
    for r in records:
        if r.parent in out:
            out[r.parent] -= own[r.id]
    return out
