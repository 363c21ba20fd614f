"""The port's trainer on the ReStyle arch (options/train/ReStyle_Face.yml)
against JAX's `OODFaceGANModel.train_step` on the CPU, at micro size:
tests/test_torch_families.py's RESTYLE (64px, narrow 0.125, enc_cycle 2,
cycle_align 1), the 50-layer IR-SE encoder JAX builds, ModSize 32 then 64
after step 2 (tests/torch_family_train.py). Both frameworks start each
step from the same seeded TrainState, loaded into the port by
`convert.load_jax_train_state` (strict, nothing left over), with the same
noise (JAX's fed through `intercept_methods`: the encoder's enc_cycle
decodes, then the final one), path cotangent and z.

Tolerances, as tests/test_torch_train.py holds E4E: every logged loss
within LOSS_RTOL 1e-4 relative; every trainable leaf's gradient within
GRAD_RTOL 1e-3 of its max|ref| (or of NOISE_FLOOR x the net's largest
gradient); the updates and the EMA by that file's rule. Measured: losses
within 2.3e-6 relative but the path terms (path_length 9.0e-6, l_g_path
1.6e-5) at step 0.

With the shipped cycle_align 2 at this size, step 0's path_length differs
from JAX's by 1.2e-4 relative: the two-cycle flow accumulation (clipped
sums) makes it sensitive to float32 rounding, and the port in float32
lies 6.9e-5 from its own float64 value, JAX 1.9e-4. So these tests keep
the families' micro cycle_align 1."""

import pytest

from test_torch_families import RESTYLE
from torch_family_train import FamilyCase, check_step, micro_family_opt
from torch_parity import release_freed_memory  # noqa: F401 (autouse)

from ood_gan_inversion_tpu.archs.ood_restyle import OODFaceGANReStyle as JReStyle


@pytest.fixture(scope="module")
def restyle():
    return FamilyCase(micro_family_opt("ReStyle_Face.yml", RESTYLE), 2, JReStyle, RESTYLE,
                      decodes=RESTYLE["enc_cycle"])


def test_restyle_split_step0_matches_jax(restyle):
    """Step 0: the D phase (R1) and the G phase with the path-length
    regularizer, whose encode decodes enc_cycle times and whose double
    backward runs through the SAMM warp-blend's twin."""
    check_step(restyle, 0, {"l_d_r1", "l_g_path", "path_length"})


def test_restyle_fused_step_past_milestone_matches_jax(restyle):
    """Step 3: past the first milestone, ModSize 64 (both SAMM scales).
    The D gradient is held on the port's own fake: the fakes differ by
    1.8e-5 of max|ref| (the two 50-layer encoder passes), and the D's
    res_3/conv1 kernel, whose gradient cancels to 1/270 of the net's
    largest, moves by 3.2e-3 of its max between the two (the port's D on
    JAX's fake against on its own: 3.15e-3)."""
    assert restyle.jm.schedule_at(3) == (10, 64)
    check_step(restyle, 3, {"l_bin", "l_area"}, d_on_port_fake=True)
