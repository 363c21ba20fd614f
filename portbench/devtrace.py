"""The device trace of a traced run, and its arithmetic.

`device_trace` runs `torch.profiler` with CUDA activity only (no CPU op
events: they would slow the host that paces the device) and keeps each
device activity as (name, kind, start_ns, end_ns), kind "kernel",
"memcpy" or "memset", and each call the host made into the CUDA runtime
or driver (CUPTI records those with the CUDA activity) as (start_ns,
end_ns). The profiler's timestamps are on the host's wall clock
(`time.time_ns`), which is also the clock of the harness's own host
spans, so an idle gap can be named by what the host was doing in it.
"""

import bisect
import contextlib
import time


def merge(intervals):
    """The union of [start, end) intervals, as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered(merged, lo, hi):
    """How much of [lo, hi) the sorted disjoint intervals cover."""
    i, total = max(bisect.bisect_left(merged, (lo,)) - 1, 0), 0
    while i < len(merged) and merged[i][0] < hi:
        s, e = merged[i]
        total += max(min(e, hi) - max(s, lo), 0)
        i += 1
    return total


def gaps(merged, lo, hi):
    """The parts of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in clip(merged, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def kind_of(name):
    """CUPTI names its copies "Memcpy ..." and its memsets "Memset ..."."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


@contextlib.contextmanager
def device_trace(run):
    """Traces the block with CUDA activity only and keeps the device
    activity in run.events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    run.events, run.api_calls = [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        if "CUDA" in str(e.device_type()):
            run.events.append((name, kind_of(name), s, s + e.duration_ns()))
        elif name.startswith("cu"):
            run.api_calls.append((s, s + e.duration_ns()))


def now_ns():
    return time.time_ns()


def window(run):
    """The traced window's device activity, cached on the run: lo, the
    window's start (nothing was queued then); hi, the end of the last
    device-to-host copy of the last call counted in the window, so that
    the window holds whole calls; `merged`, the union of every device
    activity in it; `busy_ns`, what that union covers; `kernels`, the
    kernel events that start in it.

    The copies are told apart by count, not by time: every call of the
    window was waited for inside the trace, each made as many copies to the
    host, in order on one stream, and the counted calls come first."""
    if "window" not in run.cache:
        lo = run.t_start_ns
        copies = sorted(e for n, k, s, e in run.events
                        if k == "memcpy" and "DtoH" in n and s >= lo)
        per_call, rest = divmod(len(copies), max(len(run.calls), 1))
        counted = sum(1 for c in run.calls if c["counted"])
        hi = copies[per_call * counted - 1] if per_call and counted and not rest else run.t_end_ns
        inside = [ev for ev in run.events if ev[3] > lo and ev[2] < hi]
        merged = merge((s, e) for _, _, s, e in inside)
        run.cache["window"] = {
            "lo": lo, "hi": hi, "merged": merged, "busy_ns": covered(merged, lo, hi),
            "kernels": [ev for ev in inside if ev[1] == "kernel" and ev[2] >= lo]}
    return run.cache["window"]


def host_activity(spans, t):
    """The name of the harness's host span that holds time t."""
    for name, s, e in spans:
        if s <= t < e:
            return name
    return "harness"


def breakdown(run, top=10):
    """The device operations that took most time in the window, and its
    longest idle gaps, each named by what the host was doing then."""
    w = window(run)
    by_name = {}
    for name, _, s, e in w["kernels"]:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(w["merged"], w["lo"], w["hi"]), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:160], t / 1e9] for n, t in ops],
            "idle_gaps": [[host_activity(run.spans, (s + e) // 2), (e - s) / 1e9]
                          for s, e in idle]}
