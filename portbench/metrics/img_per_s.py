"""img_per_s (img/s, host clock): the images whose outputs reached host
memory within the window, over the time from the window's first dispatch
to the last of those arrivals. A stall anywhere in between counts."""


def counted_images(run):
    return sum(len(c["idx"]) for c in run.calls if c["counted"])


def read(run):
    n = counted_images(run)
    if not n:
        return None
    return n / ((run.t_end_ns - run.t_start_ns) / 1e9)
