"""A run drives the rest of the harness on the CPU at a micro size, with
the timed path sound and then broken underneath, and `correct` follows:
half of each batch left out (its slots filled with the mean over the
rest), an answer altered where it is produced, and the program reading a
leaf of its weights wrong: a generator bias from the neighbouring channel,
two layers' noise strengths swapped, a SAMM norm's weight and bias
swapped, avg_latent left out."""

import pytest
import torch

from conftest import WORKLOADS, micro_cell
from portbench import run


class HalfBatch:
    """Computes the first half of each call and fills the rest with the
    mean of those outputs."""

    def __init__(self, system):
        self.system = system

    def invert_batch_perkey(self, imgs, seeds, outputs=None):
        half = max(1, len(imgs) // 2)
        out = self.system.invert_batch_perkey(imgs[:half], seeds[:half], outputs)
        fill = len(imgs) - half
        return {k: torch.cat([v, v.mean(dim=0, keepdim=True).expand(fill, *v.shape[1:])])
                for k, v in out.items()}


class AlteredAnswer:
    """Moves one pixel of each image's blend by 1% of its largest value."""

    def __init__(self, system):
        self.system = system

    def invert_batch_perkey(self, imgs, seeds, outputs=None):
        out = dict(self.system.invert_batch_perkey(imgs, seeds, outputs))
        image = out["image"].clone()
        image[:, 3, 5, 1] += 0.01 * image.abs().amax(dim=(1, 2, 3))
        out["image"] = image
        return out


class MisreadWeights:
    """The program with `edit(state)` applied to its own weights in place."""

    edit = None

    def __init__(self, system):
        with torch.no_grad():
            self.edit(dict(system.net.named_parameters()))
        self.system = system

    def invert_batch_perkey(self, imgs, seeds, outputs=None):
        return self.system.invert_batch_perkey(imgs, seeds, outputs)


def _roll_bias(p):
    p["generator.convs.5.activate.bias"].copy_(p["generator.convs.5.activate.bias"].roll(1))


def _swap_noise_strengths(p):
    a, b = p["generator.convs.2.noise.weight"], p["generator.convs.5.noise.weight"]
    a_old = a.clone()
    a.copy_(b)
    b.copy_(a_old)


def _swap_norm_affine(p):
    w, b = (p[f"modulation.3.alignment.body.body0.norm1.{k}"] for k in ("weight", "bias"))
    w_old = w.clone()
    w.copy_(b)
    b.copy_(w_old)


def _drop_avg_latent(p):
    p["avg_latent"].zero_()


def misread(edit):
    return type(f"Misread{edit.__name__}", (MisreadWeights,), {"edit": staticmethod(edit)})


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [None, HalfBatch, AlteredAnswer] + [
    misread(e) for e in (_roll_bias, _swap_noise_strengths, _swap_norm_affine, _drop_avg_latent)],
    ids=lambda f: getattr(f, "__name__", "sound"))
def test_correct_follows_the_timed_path(workload, fault):
    # a window that holds several micro calls even with test workers side by side
    r = run.run_cell(micro_cell(workload), 2 ** 31 + 11, 10.0, False, "cpu", system_hook=fault)
    correct, numbers = run.verdict(r)
    # calls were counted, so the verdict is the numbers'
    assert any(c["counted"] for c in r.calls)
    assert correct is (fault is None), numbers
    assert all(n["value"] >= 0 for n in numbers.values())
