"""On the card (marked cuda; skips without one): a cell's short run is
correct, and its control, the reference with TF32 on in the program's
place, is not. Run on the card from the checkout's root with
`python -m pytest -p no:cacheprovider -m cuda portbench/tests -q`."""

import pytest

from conftest import WORKLOADS
from portbench import run


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_is_correct_and_its_control_is_not(workload, cuda_device):
    cell = run.resolve(run.ROOT, workload)
    sound = run.run_cell(cell, 2 ** 31 + 101, 3.0, False, cuda_device)
    assert run.verdict(sound)[0], run.verdict(sound)[1]
    control = run.run_cell(cell, 2 ** 31 + 101, 3.0, False, cuda_device, control=True)
    assert not run.verdict(control)[0], run.verdict(control)[1]
