"""The arithmetic of the metrics that read the port's own spans, on made-up
spans: self time under nested children, the filter to counted calls, the
check of the images, and None where nothing is found."""

import types

import pytest

from portbench import run, spans


def load(name):
    return run.metric_module(name)


def span(name, sid, parent, call, t0_us, t1_us, n=8, device_ms=None):
    return types.SimpleNamespace(name=name, id=sid, parent=parent, call=call,
                                 t0_ns=t0_us * 1000, t1_ns=t1_us * 1000, n=n,
                                 host_ms=(t1_us - t0_us) / 1000, device_ms=device_ms)


def one_call(first, t0_us, n=8):
    """The spans of one call, ids from `first`, host times from t0_us
    (us), device times (ms): invert 60 = the prelude's 2 + 1 + 1, a forward
    of 56 = encoder 6 + adapt 1 + decode.32 of 20 (samm.32 12 inside it) +
    decode.1024 25 + blend 2 and 2 of the forward's own."""
    c, t = first, t0_us
    return [span("invert", c, None, c, t, t + 1000, n, 60.0),
            span("input", c + 1, c, c, t + 10, t + 300, n, 2.0),
            span("upload", c + 2, c, c, t + 300, t + 350, n, 1.0),
            span("noise", c + 3, c, c, t + 350, t + 500, n, 1.0),
            span("forward", c + 4, c, c, t + 500, t + 990, n, 56.0),
            span("encoder", c + 5, c + 4, c, t + 510, t + 600, n, 6.0),
            span("adapt", c + 6, c + 4, c, t + 600, t + 610, n, 1.0),
            span("decode.32", c + 7, c + 4, c, t + 610, t + 800, n, 20.0),
            span("samm.32", c + 8, c + 7, c, t + 620, t + 700, n, 12.0),
            span("decode.1024", c + 9, c + 4, c, t + 800, t + 950, n, 25.0),
            span("blend", c + 10, c + 4, c, t + 950, t + 980, n, 2.0)]


def calls():
    """Two counted calls of 8 images and one that was not counted."""
    return [{"idx": [0] * 8, "counted": True, "t_entry": 0, "t_returned": 1_100_000},
            {"idx": [0] * 8, "counted": True, "t_entry": 2_000_000, "t_returned": 3_100_000},
            {"idx": [0] * 8, "counted": False, "t_entry": 4_000_000, "t_returned": 5_100_000}]


def fake_run(records):
    r = types.SimpleNamespace(cache={}, calls=calls())
    r.cache["program_spans"] = spans.counted_spans(records, r.calls)
    return r


def all_calls():
    # a warm-up call before the window, the two counted calls, the
    # uncounted one: only the counted calls' spans are read
    return (one_call(100, -5000) + one_call(1, 100) + one_call(20, 2100)
            + one_call(40, 4100))


def test_self_time_leaves_out_nested_children():
    from ood_gan_inversion_tpu_torch.utils import trace
    records = one_call(1, 0)
    dev = trace.self_times(records, "device")
    assert dev[5] == 56.0 - (6 + 1 + 20 + 25 + 2)              # forward's own
    assert dev[8] == 20.0 - 12.0 and dev[9] == 12.0            # decode.32 less samm.32
    assert dev[1] == 60.0 - 2 - 1 - 1 - 56
    host = trace.self_times(records, "host")
    assert host[1] == pytest.approx(1.0 - 0.29 - 0.05 - 0.15 - 0.49)
    assert sum(host.values()) == pytest.approx(records[0].host_ms)
    records[3].device_ms = None                                  # no CUDA: no device time
    assert trace.self_times(records, "device") is None


def test_metrics_read_the_counted_calls_per_image():
    r = fake_run(all_calls())
    got, images = spans.program_spans(r)
    assert images == 16 and {s.call for s in got} == {1, 20}
    assert load("prelude_host_ms_per_img").read(r) == pytest.approx(2 * (0.29 + 0.05 + 0.15) / 16)
    assert load("encoder_device_ms_per_img").read(r) == pytest.approx(2 * (6 + 1) / 16)
    assert load("generator_device_ms_per_img").read(r) == pytest.approx(2 * (8 + 25) / 16)
    assert load("samm_device_ms_per_img").read(r) == pytest.approx(2 * 12 / 16)
    assert load("samm_device_ms_per_img.restyle").read(r) == pytest.approx(2 * 12 / 16)


@pytest.mark.parametrize("records", [
    [],                                                        # no span recorded
    one_call(1, 100),                                          # a counted call missing
    one_call(1, 100) + one_call(20, 2100, n=4),                # images disagree
    one_call(100, -5000) + one_call(40, 4100),                 # no counted call traced
], ids=["none", "call_missing", "images_disagree", "outside"])
def test_metrics_read_none_without_the_counted_calls(records):
    r = fake_run(records)
    assert spans.program_spans(r) is None
    for name in ("prelude_host_ms_per_img", "encoder_device_ms_per_img",
                 "generator_device_ms_per_img", "samm_device_ms_per_img"):
        assert load(name).read(r) is None


def test_device_metrics_read_none_without_device_times():
    records = all_calls()
    for s in records:
        s.device_ms = None
    r = fake_run(records)
    assert load("prelude_host_ms_per_img").read(r) is not None
    assert load("generator_device_ms_per_img").read(r) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """A run whose program has no tracer (the import fails) reads None and
    raises nothing."""
    import builtins
    real = builtins.__import__

    def no_trace(name, *a, **k):
        if name.endswith("utils") and a and a[2] and "trace" in a[2]:
            raise ImportError(name)
        if name.endswith("utils.trace"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    r = types.SimpleNamespace(cache={}, calls=calls())
    assert load("samm_device_ms_per_img").read(r) is None
    assert load("prelude_host_ms_per_img").read(r) is None
