"""samm_device_ms_per_img (ms/img, program spans; layer: model step:
SAMM): the device time of every `samm.<res>` span of the port (the SAMM
block of a conditioned stage, 32 to 256 px: AlignNet, the flows and the
B1 warp-blend), per counted image."""

from portbench import spans


def read(run):
    return spans.ms_per_image(run, ("samm",), "device", self_time=False)
