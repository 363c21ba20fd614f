"""kernel_launches_per_img (launches/img, device trace; layer: kernels):
the kernels that ran on the device in the traced window, per image of the
counted calls. The window holds whole calls (devtrace.window), so the
count repeats exactly from run to run."""

from portbench import devtrace


def read(run):
    if run.events is None:
        return None
    n = sum(len(c["idx"]) for c in run.calls if c["counted"])
    kernels = devtrace.window(run)["kernels"]
    if not n or not kernels:
        return None
    return len(kernels) / n
