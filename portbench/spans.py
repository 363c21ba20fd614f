"""The port's own spans (`ood_gan_inversion_tpu_torch/utils/trace.py`) in a
traced run, and the arithmetic of the metrics that read them.

The port records a span at each layer boundary of an inversion while a
`torch.profiler` session runs, so a `--trace 1` window records them and a
`--trace 0` one does not. A span has a name, an id, its parent's id, its
call's id (one per `invert*` call), host start and end on the trace's
clock (ns), `n` (its images), and `device_ms`, the current stream's time
between two CUDA events recorded at its entry and exit. A span's self time
(`trace.self_times`) is its duration less its children's.

The metrics keep the spans of counted calls: those whose `invert` span
started inside a counted call's interval `[t_entry, t_returned]`; and they
divide by the counted images, which must equal the sum of `n` over those
`invert` spans. Where the port records no spans (a program without them),
or the two counts differ, they read None.
"""

import bisect


def counted_spans(records, calls):
    """(the spans of the counted calls, their images), or None."""
    counted = [c for c in calls if c["counted"]]
    images = sum(len(c["idx"]) for c in counted)
    if not records or not images:
        return None
    starts = sorted((c["t_entry"], c["t_returned"]) for c in counted)

    def inside(t):
        i = bisect.bisect_right(starts, (t, float("inf"))) - 1
        return i >= 0 and starts[i][0] <= t <= starts[i][1]

    roots = [r for r in records if r.name == "invert" and r.parent is None and inside(r.t0_ns)]
    if not roots or sum(r.n for r in roots) != images:
        return None
    ids = {r.id for r in roots}
    return [r for r in records if r.call in ids], images


def program_spans(run):
    """counted_spans of the run's calls, from the port's tracer (cached on
    the run); None where the program has no tracer or recorded nothing."""
    if "program_spans" not in run.cache:
        try:
            from ood_gan_inversion_tpu_torch.utils import trace
        except ImportError:
            records = None
        else:
            records = [r for r in trace.spans() if r.t1_ns is not None]
        run.cache["program_spans"] = counted_spans(records, run.calls)
    return run.cache["program_spans"]


def ms_per_image(run, kinds, clock, self_time):
    """The time of the counted calls' spans of `kinds` (a name up to its
    first dot: "decode" for "decode.256"), self time or whole, on `clock`,
    per counted image; None where nothing was read."""
    got = program_spans(run)
    if got is None:
        return None
    from ood_gan_inversion_tpu_torch.utils import trace
    records, images = got
    times = (trace.self_times if self_time else trace.durations)(records, clock)
    picked = [r for r in records if r.name.split(".")[0] in kinds]
    if times is None or not picked:
        return None
    return sum(times[r.id] for r in picked) / images
