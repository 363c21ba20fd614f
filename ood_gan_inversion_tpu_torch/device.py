"""Device selection shared by the entry points."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    another. Raises when CUDA is asked for and absent, so that no entry
    point carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev
