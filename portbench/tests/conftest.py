"""Shared fixtures of the benchmark's own tests: a cell cut to a micro
size that runs on the CPU."""

import json
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

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def micro_cell(workload):
    """The workload's cell cut to a size that runs on the CPU: its
    configuration's `network_g` with the file's `micro` overrides, images
    at the micro `out_size`, 3-image calls."""
    from portbench import run
    cell = run.resolve(run.ROOT, workload)
    config = cell["config"]
    if "micro" not in config:
        raise KeyError(f"configuration {config['name']!r} has no `micro` overrides: "
                       "its cells cannot run on the CPU")
    g = config["network_g"]
    g.update(config["micro"])
    cell["traffic"].update(image_size=g["out_size"], image_coarse=8, batch=3, pool=5,
                           check_batches=2)
    config["check_block"] = 2
    return cell


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
