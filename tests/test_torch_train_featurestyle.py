"""The port's trainer on the FeatureStyle arch
(options/train/FeatureStyle_Face.yml) against JAX's
`OODFaceGANModel.train_step` on the CPU, at micro size:
tests/test_torch_families.py's FEATURESTYLE (64px, cycle_align 1) at
narrow 0.125, the iresnet50 encoder JAX builds, ModSize 32 then 64 after
step 2 (tests/torch_family_train.py). Both frameworks start each
step from the same seeded TrainState, loaded into the port by
`convert.load_jax_train_state` (strict, nothing left over), with the same
noise (JAX's fed through `intercept_methods`), path cotangent and z. The
path-length phase hands decode_samm encode's (adapted features, content)
in both.

Tolerances, as tests/test_torch_train.py holds E4E: every logged loss
within LOSS_RTOL 1e-4 relative; every trainable leaf's gradient within
GRAD_RTOL 1e-3 of its max|ref| (or of NOISE_FLOOR x the net's largest
gradient); the updates and the EMA by that file's rule.

Narrow 0.125, not the families' 1.0: narrow 1.0 is there for
inject_content's 512 generator channels at 16px, and the shipped file
trains without injection. At narrow 1.0 the file took ~145 s of the
150 s a tier-1 file may take, and at ModSize 64 its 64px SAMM block (256
channels) makes JAX's gradient of that block's body0 conv1 kernel move by
5e-4 of its max when the input moves one float32 step (the port's: 1e-5);
the port lay 1.7e-3 from it. At narrow 0.125 the steps agree within 5.5e-5
(G) and 5.2e-4 (D)."""

import pytest

from test_torch_families import FEATURESTYLE
from torch_family_train import FamilyCase, check_step, micro_family_opt
from torch_parity import release_freed_memory  # noqa: F401 (autouse)

from ood_gan_inversion_tpu.archs.ood_featurestyle import OODFaceGANFeatureStyle as JFS

FS = dict(FEATURESTYLE, narrow=0.125)


@pytest.fixture(scope="module")
def featurestyle():
    return FamilyCase(micro_family_opt("FeatureStyle_Face.yml", FS), 5, JFS, FS, decodes=0)


def test_featurestyle_split_step0_matches_jax(featurestyle):
    """Step 0: R1 in the D phase, the path-length regularizer's double
    backward through the decode of (W+, (features, content))."""
    check_step(featurestyle, 0, {"l_d_r1", "l_g_path", "path_length"})


def test_featurestyle_fused_step_past_milestone_matches_jax(featurestyle):
    """Step 3: past the first milestone, ModSize 64 (both SAMM scales)."""
    assert featurestyle.jm.schedule_at(3) == (10, 64)
    check_step(featurestyle, 3, {"l_bin", "l_area"})
