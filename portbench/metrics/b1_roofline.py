"""b1_roofline (%, device trace; layer: kernels): the least time B1
(`csrc/warp_blend.cu`, the SAMM warp-blend kernel) could take for the
window's launches, over the device time of its `warp_blend_kernel`
events in the window.

A forward launches B1 once per SAMM block and align cycle, on the
block's (batch, s, s, C) feature: the blocks at s = 32, 64, 128, 256 up
to the configuration's ModSize and out_size, C the generator's width at
s. Per launch (the arithmetic of chip_smoke.py:warp_bound_ms): bytes =
2 * px * C * itemsize (the target read, the output written) + 12 * px
(grid and alpha), flops = 11 * px * C (four taps at two each, the blend
three), px = batch * s * s; the bound is the larger of bytes over HBM's
rate and flops over the float32 peak."""

from portbench import devtrace
from portbench.peaks import FLOPS, HBM_BYTES_PER_S
from portbench.reference.model import generator_channels

KERNEL = "warp_blend_kernel"
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def launch_bounds_s(network_g, dtype, batch):
    """The bound of each of one forward's B1 launches, seconds."""
    ch = generator_channels(network_g.get("channel_multiplier", 2), network_g.get("narrow", 1.0))
    top = min(network_g.get("out_size", 1024), network_g.get("ModSize") or 256)
    out = []
    for s in (32, 64, 128, 256):
        if s > top:
            continue
        px, c = batch * s * s, ch[s]
        nbytes = 2 * px * c * ITEMSIZE[dtype] + 12 * px
        flops = 11 * px * c
        out += [max(nbytes / HBM_BYTES_PER_S, flops / FLOPS["float32"])] * network_g["cycle_align"]
    return out


def read(run):
    if run.events is None:
        return None
    times = [e - s for name, _, s, e in devtrace.window(run)["kernels"] if KERNEL in name]
    bounds = launch_bounds_s(run.config["network_g"], run.config["dtype"], run.traffic["batch"])
    if not times or len(times) % len(bounds):
        return None
    forwards = len(times) // len(bounds)
    return 100.0 * forwards * sum(bounds) / (sum(times) / 1e9)
