"""generator_device_ms_per_img (ms/img, program spans; layer: model step:
generator): the device self time of every `decode.<res>` span of the port
(one per StyleGAN2 stage, 4 to 1024 px, in the conditioned decode and in
an iterative encoder's plain internal decodes alike), per counted image.
Self time leaves out the SAMM blocks, whose `samm.<res>` spans lie inside
their stages."""

from portbench import spans


def read(run):
    return spans.ms_per_image(run, ("decode",), "device", self_time=True)
