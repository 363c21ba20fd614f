"""prelude_host_ms_per_img (ms/img, program spans; layer: entry): the host
time of each counted call's prelude, the port's `input` (img2input of each
image and their concatenation), `upload` (the pinned copy to the card)
and `noise` (the per-seed draws) spans, per counted image. That is the
work that a call does on the host before its first kernel, and during
which the card drains once the previous call's work is done."""

from portbench import spans


def read(run):
    return spans.ms_per_image(run, ("input", "upload", "noise"), "host", self_time=False)
