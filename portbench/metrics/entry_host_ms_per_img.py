"""entry_host_ms_per_img (ms/img, device trace; layer: entry): the host's
own time inside `invert_batch_perkey` (img2input, the noise draws, the
forward's Python and the torch dispatcher, which queue the work and
return), per image of the counted calls: each counted call's time in the
call less the part of it spent inside calls into the CUDA runtime or
driver, which the trace records. Those hold the waits on a full launch
queue, which pace the host when the device is the slower side, so what
is left is the host's dispatch cost alone, which a CUDA graph or fewer
launches cut."""

from portbench import devtrace


def read(run):
    api = getattr(run, "api_calls", None)
    calls = [c for c in run.calls if c["counted"]]
    n = sum(len(c["idx"]) for c in calls)
    if not api or not n:
        return None
    merged = devtrace.merge(api)
    own = sum(c["entry_ns"] - devtrace.covered(merged, c["t_entry"], c["t_returned"])
              for c in calls)
    return own / 1e6 / n
