"""content_device_ms_per_img (ms/img, program spans; layer: model step:
encoder): the device self time of the port's `encoder.content` spans
(FeatureStyle's content branch, inside the `encoder` span; its output
reaches the decode only with `inject_content`, off as published), per
counted image. None where the counted calls recorded no such span (another
family, or a program without it)."""

from portbench import spans

NAME = "encoder.content"


def read(run):
    got = spans.program_spans(run)
    if got is None:
        return None
    from ood_gan_inversion_tpu_torch.utils import trace
    records, images = got
    picked = [r for r in records if r.name == NAME]
    if not picked:
        return None
    times = trace.self_times(records, "device")
    if times is None:
        return None
    return sum(times[r.id] for r in picked) / images
