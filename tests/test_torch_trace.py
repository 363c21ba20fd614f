"""The port's spans (utils/trace.py) on the CPU: off outside a profiler, on
inside one; the spans of an E4E, a ReStyle and a FeatureStyle inversion,
their nesting, their call ids and their clock; threads that trace at
once; the bounded buffer; self times."""

import collections
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ood_gan_inversion_tpu_torch import infer
from ood_gan_inversion_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def two_threads():
    """A few threads each, so that test workers side by side do not
    starve one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _engine(monkeypatch, arch_type, out_size, narrow, **g):
    """A CPU engine with its weights zeroed: the spans do not depend on
    them, and a seeded draw of a 1024px arch's takes seconds."""
    monkeypatch.setattr(infer, "init_weights",
                        lambda net, seed: [p.data.zero_() for p in net.parameters()])
    opt = {"network_g": {"type": arch_type, "out_size": out_size, "channel_multiplier": 1,
                         "narrow": narrow, "encoder_num_layers": 4, "warp_scale": 0.08,
                         "cycle_align": 2, "ModSize": 256, "stage": "Inference", **g}}
    return infer.InversionEngine(opt, device="cpu")


def _stages(out_size):
    return [f"decode.{2 ** k}" for k in range(2, out_size.bit_length())]


def _samm(out_size):
    return [f"samm.{s}" for s in (32, 64, 128, 256) if s <= out_size]


def expected_names(arch, out_size, passes):
    """The spans of one invert_batch_perkey call: the prelude, the
    forward, `passes` encoder passes (FeatureStyle's with its content
    branch inside), passes + 1 decodes (ReStyle decodes once per pass
    before the conditioned decode), SAMM blocks up to 256px."""
    names = ["invert", "input", "upload", "noise", "forward", "adapt", "blend"]
    names += ["encoder"] * passes + _stages(out_size) * passes + _samm(out_size)
    names += ["encoder.content"] * passes if arch == "ood_faceGAN_FeatureStyle" else []
    names += _stages(out_size) if passes > 1 else []
    return collections.Counter(names)


# (arch, out_size, narrow, network_g extras, encoder passes, spans per
# call, batch):
# the full depth of the benchmark's configurations (1024px: every stage and
# all four SAMM blocks; ReStyle's 5 passes; FeatureStyle's iresnet50 at its
# published widths, having no knob, and 3 align cycles) at micro widths, and
# a micro ReStyle at 64px and batch 2
CASES = {
    "e4e": ("ood_faceGAN_e4e", 1024, 1 / 16, {}, 1, 21, 1),
    "restyle": ("ood_faceGAN_restyle", 1024, 1 / 16, {"enc_cycle": 5}, 5, 70, 1),
    "featurestyle": ("ood_faceGAN_FeatureStyle", 1024, 1 / 16, {"cycle_align": 3}, 1, 22, 1),
    "restyle_micro": ("ood_faceGAN_restyle", 64, 0.125, {"enc_cycle": 2}, 2, 26, 2),
}


def _traced_call(engine, imgs, seeds):
    """invert_batch_perkey under a CPU profiler: (this call's spans, t0,
    t1 around the call, the profiler)."""
    before = {id(r) for r in trace.spans()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        engine.invert_batch_perkey(imgs, seeds, ("image",))
        t1 = time.time_ns()
    return [r for r in trace.spans() if id(r) not in before], t0, t1, prof


def test_tracing_is_off_outside_a_profiler(monkeypatch):
    """Outside a profiler span() is one shared no-op: an E4E call records
    nothing, and entering spans allocates nothing and touches no CUDA."""
    eng = _engine(monkeypatch, "ood_faceGAN_e4e", 64, 0.125)
    n = len(trace.spans())
    eng.invert_batch_perkey([np.zeros((64, 64, 3), np.float32)], [1])
    assert len(trace.spans()) == n
    assert trace.span("invert", 2) is trace.span("decode.4")

    def no_cuda(*a, **k):
        raise AssertionError("CUDA touched by an untraced span")

    monkeypatch.setattr(torch.cuda, "is_initialized", no_cuda)
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    names = [f"decode.{2 ** k}" for k in range(2, 11)]
    tracemalloc.start()
    try:
        for name in names:                       # warm the loop's own objects
            with trace.span(name, 8):
                pass
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(2000):
            for name in names:
                with trace.span(name, 8):
                    pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024                          # 18000 spans: nothing each
    assert len(trace.spans()) == n


@pytest.mark.parametrize("case", list(CASES))
def test_inversion_spans_nest_share_a_call_and_the_clock(monkeypatch, case):
    """One invert_batch_perkey call inside a profiler records every span
    of the table, as many as expected, nested by parent id under one call
    id, each within its parent's host interval and within time.time_ns()
    taken around the call; the profiler's own events carry the names."""
    arch, size, narrow, extra, passes, count, b = CASES[case]
    eng = _engine(monkeypatch, arch, size, narrow, **extra)
    rs = np.random.RandomState(0)
    imgs = [rs.rand(size, size, 3).astype(np.float32) for _ in range(b)]
    got, t0, t1, prof = _traced_call(eng, imgs, list(range(b)))
    names = collections.Counter(r.name for r in got)
    assert names == expected_names(arch, size, passes) and len(got) == count

    by_id = {r.id: r for r in got}
    (root,) = [r for r in got if r.parent is None]
    assert root.name == "invert" and root.n == b
    parent_of = {"invert": None, "input": "invert", "upload": "invert", "noise": "invert",
                 "forward": "invert", "encoder": "forward", "adapt": "forward",
                 "decode": "forward", "blend": "forward", "samm": "decode",
                 "encoder.content": "encoder"}
    for r in got:
        assert r.call == root.id and r.n == b and r.thread == root.thread
        assert t0 <= r.t0_ns <= r.t1_ns <= t1
        if r is root:
            continue
        p = by_id[r.parent]
        want = parent_of.get(r.name) or parent_of[r.name.split(".")[0]]
        assert p.name.split(".")[0] == want, (r.name, p.name)
        assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns
        if r.name.startswith("samm."):
            assert p.name == "decode." + r.name.split(".")[1]
    # without CUDA a span has no device time
    assert all(r.device_ms is None for r in got) and trace.durations(got, "device") is None

    events = collections.Counter(e.name for e in prof.events() if e.name in names)
    assert events == names

    # self times: each at least 0, and together the call's duration
    own = trace.self_times(got)
    assert min(own.values()) >= -1e-9
    assert sum(own.values()) == pytest.approx(root.host_ms, rel=1e-9)


def test_threads_tracing_at_once_keep_their_own_parents():
    """Eight threads open nested spans at once under a short switch
    interval: every parent is a span of the same thread and call, open
    around its child."""
    def worker(k, barrier):
        barrier.wait(timeout=30)
        for i in range(100):
            with trace.span(f"outer{k}", k):
                with trace.span(f"mid{k}", k):
                    with trace.span(f"inner{k}", k):
                        pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(8)
        threads = [threading.Thread(target=worker, args=(k, barrier)) for k in range(8)]
        before = {id(r) for r in trace.spans()}
        with profile(activities=[ProfilerActivity.CPU]):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = [r for r in trace.spans() if id(r) not in before]
    assert len(got) == 8 * 100 * 3
    by_id = {r.id: r for r in got}
    want = {"mid": "outer", "inner": "mid"}
    for r in got:
        k = r.n
        if r.name == f"outer{k}":
            assert r.parent is None and r.call == r.id
            continue
        p = by_id[r.parent]
        assert p.name == want[r.name[:-1]] + str(k) and p.thread == r.thread
        assert p.call == r.call and p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns
    assert len({r.call for r in got}) == 800


def test_the_buffer_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=4))
    monkeypatch.setattr(trace, "_dropped", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(7):
            with trace.span(f"s{i}"):
                pass
    assert [r.name for r in trace.spans()] == ["s3", "s4", "s5", "s6"]
    assert trace.dropped() == 3
