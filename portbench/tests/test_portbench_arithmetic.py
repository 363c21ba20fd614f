"""The harness's arithmetic on made-up readings: the rate over the window,
the union of device intervals, B1's bytes, the launch count."""

import json
import types

import pytest

from portbench import devtrace, run


def load(name):
    return run.metric_module(name)


def fake_run(events=None, calls=None, traffic=None, config=None):
    r = types.SimpleNamespace(cache={}, spans=[], events=events, t0_ns=0,
                              t_start_ns=1_000, t_end_ns=3_001_000,
                              traffic=traffic or {"batch": 8}, config=config or {})
    r.calls = calls if calls is not None else [
        {"idx": [0] * 8, "counted": True, "t_entry": 1_000, "entry_ns": 2_000_000},
        {"idx": [0] * 8, "counted": True, "t_entry": 2_001_000, "entry_ns": 4_000_000},
        {"idx": [0] * 8, "counted": False, "t_entry": 6_001_000, "entry_ns": 9_000_000}]
    for c in r.calls:
        c["t_returned"] = c["t_entry"] + c["entry_ns"]
    return r


def test_rate_is_counted_images_over_the_window():
    r = fake_run()
    assert load("img_per_s").read(r) == pytest.approx(16 / 3e-3)
    assert load("setup_s").read(r) == pytest.approx(1e-6)
    assert load("img_per_s").read(fake_run(calls=[])) is None


def test_entry_time_leaves_out_the_calls_into_cuda():
    r = fake_run()
    assert load("entry_host_ms_per_img").read(r) is None        # untraced
    # 0.5 ms of the first call in two overlapping API calls, 1 ms of the
    # second, and the uncounted call's 3 ms, which is not read
    r.api_calls = [(101_000, 401_000), (301_000, 601_000), (3_001_000, 4_001_000),
                   (7_001_000, 10_001_000)]
    assert load("entry_host_ms_per_img").read(r) == pytest.approx((6.0 - 1.5) / 16)
    assert devtrace.covered(devtrace.merge(r.api_calls), 0, 2_001_000) == 500_000


def test_union_of_intervals_and_gaps():
    merged = devtrace.merge([(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)])
    assert merged == [(0, 3), (5, 9), (12, 13)]
    assert devtrace.covered(merged, 2, 12) == 1 + 4
    assert devtrace.gaps(merged, 2, 14) == [(3, 5), (9, 12), (13, 14)]


def test_window_idle_share_launches_and_breakdown():
    # one copy to the host per call; the third call is not counted
    ev = [("Memcpy HtoD", "memcpy", 1_000, 2_000),
          ("k1", "kernel", 2_000, 1_002_000), ("Memcpy DtoH", "memcpy", 1_002_000, 1_052_000),
          ("k2", "kernel", 1_500_000, 2_000_000), ("Memcpy DtoH", "memcpy", 2_500_000, 2_600_000),
          ("k1", "kernel", 2_700_000, 3_500_000),      # the next call's: outside
          ("Memcpy DtoH", "memcpy", 3_500_000, 3_550_000)]
    r = fake_run(events=ev)
    r.spans = [("readback", 2_000_000, 2_600_000)]
    w = devtrace.window(r)
    assert (w["lo"], w["hi"]) == (1_000, 2_600_000)
    busy = 1_000 + 1_050_000 + 500_000 + 100_000
    assert w["busy_ns"] == busy
    assert load("device_idle_pct").read(r) == pytest.approx(100 * (1 - busy / 2_599_000))
    assert load("kernel_launches_per_img").read(r) == pytest.approx(2 / 16)
    b = devtrace.breakdown(r)
    assert b["device_ops"][0] == ["k1", 1e-3]
    assert b["idle_gaps"][0] == ["readback", 500_000 / 1e9]
    assert load("device_idle_pct").read(fake_run(events=None)) is None
    # the window's end is the last counted call's copy, whatever the clocks
    # say of the call's end
    r = fake_run(events=ev)
    r.t_end_ns = 2_590_000
    assert devtrace.window(r)["hi"] == 2_600_000


def test_b1_bytes_and_roofline():
    cfg = json.loads((run.ROOT / "portbench/configs/e4e_face.json").read_text())
    b1 = load("b1_roofline")
    bounds = b1.launch_bounds_s(cfg["network_g"], "float32", 8)
    assert len(bounds) == 8                       # 4 SAMM blocks x cycle_align 2
    px = 8 * 256 * 256                            # the 256px block, C = 128
    assert max(bounds) == pytest.approx((2 * px * 128 * 4 + 12 * px) / 3.35e12)
    # B1: 0.0732 ms of bound per 1024px forward at b = 1 (PERF.md, section 6)
    one = sum(b1.launch_bounds_s(cfg["network_g"], "float32", 1))
    assert one * 1e3 == pytest.approx(0.0732, rel=0.01)
    per_launch = [int(t * 2e9) for t in bounds]   # every launch at half its bound
    ev = [("warp_blend_kernel<float>", "kernel", 10_000 + i, 10_000 + i + t)
          for i, t in enumerate(per_launch * 3)]
    r = fake_run(events=ev, config=cfg, traffic={"batch": 8})
    r.config = dict(cfg)
    assert b1.read(r) == pytest.approx(50.0, rel=1e-4)     # int ns rounding
