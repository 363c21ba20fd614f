"""The port's training entry point (train.py's train_pipeline, what
`python -m ood_gan_inversion_tpu_torch.run_train` runs) on the ReStyle
and FeatureStyle shipped files, options/train/ReStyle_Face.yml and
FeatureStyle_Face.yml, cut to micro size on the CPU through --force_yml
only (64px, narrow 0.125, a 4-layer IR-SE trunk, ReStyle's enc_cycle 2,
the discriminators narrowed) over synthetic 64px PNGs: 2 iterations, the
final validation of 1 image and the final save; then ReStyle's run
resumed (--auto_resume) to iteration 3, whose logged losses equal those
of an uninterrupted 3-iteration run, bit for bit."""

import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from ood_gan_inversion_tpu_torch.losses import id_loss
from ood_gan_inversion_tpu_torch.models import OODFaceGANModel
from ood_gan_inversion_tpu_torch.nn.irse import ArcFaceBackbone
from ood_gan_inversion_tpu_torch.train import train_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = {"ReStyle_Face.yml": ["network_g:enc_cycle=2", "network_g:encoder_num_layers=4"],
         "FeatureStyle_Face.yml": []}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """2 train and 1 val seeded 64px PNGs."""
    d = tmp_path_factory.mktemp("family_pipeline")
    rs = np.random.RandomState(3)
    for sub, n in (("train", 2), ("val", 1)):
        os.makedirs(d / sub)
        for i in range(n):
            cv2.imwrite(str(d / sub / f"{i}.png"), (rs.rand(64, 64, 3) * 255).astype(np.uint8))
    yield d
    shutil.rmtree(d, ignore_errors=True)


def args(yml, data, exp, total, *extra):
    return ["--opt", f"options/train/{yml}", "--device", "cpu", "--force_yml",
            f"datasets:train:dataroot_gt_list=[{data}/train]",
            f"datasets:val:dataroot_gt={data}/val", "path:pretrain_network_g=~",
            "path:pretrain_network_d=~", f"path:experiments_root={exp}",
            f"train:total_iter={total}", "val:val_freq=1000", "logger:print_freq=1",
            "logger:save_checkpoint_freq=1000", "logger:use_tb_logger=false",
            "datasets:train:num_worker_per_gpu=1", "datasets:train:gt_size=64",
            "datasets:val:gt_size=64", "network_g:out_size=64",
            "network_g:channel_multiplier=1", "network_g:narrow=0.125",
            "network_d:out_size=64", "network_d:channel_multiplier=1", "network_d:narrow=0.125",
            "network_d2:chn=10", "network_d2:n_mlp=2", *MICRO[yml], *extra]


@pytest.fixture
def logged(monkeypatch):
    """{iteration: logs} of every train_step the pipeline takes; the
    identity loss's ArcFace built with a 4-layer trunk, as the train tests
    cut it."""
    seen = {}
    step = OODFaceGANModel.train_step

    def record(self, batch, it, **kw):
        seen[it] = {k: v.clone() for k, v in step(self, batch, it, **kw).items()}
        return seen[it]

    monkeypatch.setattr(id_loss, "ArcFaceBackbone", lambda num_layers: ArcFaceBackbone(4))
    monkeypatch.setattr(OODFaceGANModel, "train_step", record)
    monkeypatch.chdir(ROOT)
    return seen


def check_run(run, yml, exp, logged):
    """2 iterations from 0 with finite losses, the final validation of the
    1 val image and the final save."""
    assert (run.start_iter, run.current_iter) == (0, 2) and sorted(logged) == [1, 2]
    assert all(bool(torch.isfinite(v)) for logs in logged.values() for v in logs.values())
    assert run.model.net_g.ENCODER == yml.split("_")[0]
    assert set(run.val_results) == {"psnr", "ssim", "lpips"} and len(run.val_seconds) == 1
    assert len(run.save_seconds) == 1
    assert os.path.isfile(exp / "training_states" / "state_2.pth")
    assert os.path.isfile(exp / "models" / "net_2.pth")


def test_featurestyle_train_pipeline_trains_validates_and_saves(data, tmp_path, logged):
    run = train_pipeline(str(tmp_path), args=args("FeatureStyle_Face.yml", data,
                                                  tmp_path / "exp", 2))
    check_run(run, "FeatureStyle_Face.yml", tmp_path / "exp", logged)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_restyle_train_pipeline_and_auto_resume_logs_the_uninterrupted_losses(
        data, tmp_path, logged):
    """2 iterations (checked as the FeatureStyle run), then --auto_resume
    to 3: iteration 3's losses are those of one uninterrupted 3-iteration
    run. A resumed run restarts its sampler at epoch 0 (as JAX's does), so
    the loader runs unshuffled and without flips: every epoch is the same
    one batch of both images."""
    fixed = ("datasets:train:use_shuffle=false", "datasets:train:use_hflip=false")
    run = train_pipeline(str(tmp_path), args=args("ReStyle_Face.yml", data, tmp_path / "a", 2,
                                                  *fixed))
    check_run(run, "ReStyle_Face.yml", tmp_path / "a", logged)
    resumed = train_pipeline(str(tmp_path), args=["--auto_resume"] + args(
        "ReStyle_Face.yml", data, tmp_path / "a", 3, *fixed))
    assert (resumed.start_iter, resumed.current_iter) == (2, 3)
    after_resume = logged.pop(3)
    train_pipeline(str(tmp_path), args=args("ReStyle_Face.yml", data, tmp_path / "b", 3, *fixed))
    assert set(after_resume) == set(logged[3])
    for k, v in after_resume.items():
        assert torch.equal(v, logged[3][k]), k
    shutil.rmtree(tmp_path, ignore_errors=True)
