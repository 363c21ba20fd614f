"""setup_s (s, host clock): from the start of the process to the window's
first call: imports, CUDA start, the kernels loaded (built on a checkout's
first run), weights made on the card, the image pool, the warm-up calls."""


def read(run):
    return (run.t_start_ns - run.t0_ns) / 1e9
