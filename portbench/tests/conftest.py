"""Shared fixtures of the benchmark's own tests: a cell cut to a micro
size that runs on the CPU."""

import sys
from pathlib import Path

import pytest
import torch

# the micro runs are small: a few threads each, so that test workers
# side by side do not starve one another's windows
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MICRO_ARCH = {"out_size": 64, "channel_multiplier": 1, "narrow": 0.125, "encoder_num_layers": 4}


def micro_cell(workload):
    """The workload's cell at 64px with narrow widths, a 4-unit trunk,
    two ReStyle passes and 3-image calls."""
    from portbench import run
    cell = run.resolve(run.ROOT, workload)
    g = cell["config"]["network_g"]
    g.update(MICRO_ARCH)
    if g["encoder"] == "ReStyle":
        g["enc_cycle"] = 2
    cell["traffic"].update(image_size=64, image_coarse=8, batch=3, pool=5, check_batches=2)
    cell["config"]["check_block"] = 2
    return cell


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
