"""encoder_device_ms_per_img (ms/img, program spans; layer: model step:
encoder): the device self time of the port's `encoder` spans (each pass of
the encoder network, one per encoder cycle of the configuration) and its
`adapt` span (the W+ offsets and the 1x1 feature adapters), per counted
image.
A span's device time is the stream's time between CUDA events recorded at
its entry and exit."""

from portbench import spans


def read(run):
    return spans.ms_per_image(run, ("encoder", "adapt"), "device", self_time=True)
