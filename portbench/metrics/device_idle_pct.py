"""device_idle_pct (%, device trace; layer: device): the share of the
traced window in which no kernel, copy or memset ran on the card: the
window's length less the union of the device activity intervals (not
their sum, so overlapping work counts once), over the window's length."""

from portbench import devtrace


def read(run):
    if run.events is None:
        return None
    w = devtrace.window(run)
    if w["hi"] <= w["lo"] or not w["kernels"]:
        return None
    return 100.0 * (1.0 - w["busy_ns"] / (w["hi"] - w["lo"]))
