"""Each configuration names its reference module, and every path to a
reference goes through that name: a new family's reference and
configuration are new files and entries only; a name without a file, or a
configuration without the key, is refused; and the lookup leaves the seeded
weights and the FLOP counts of the present configurations as they were."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from conftest import micro_cell
from portbench import reference, run
from portbench.metrics.mfu_pct import model_flops_per_image
from portbench.weights import make_state_dict

STUB = '''"""A reference of no real family: a 1x1 conv on the image, a linear map of
its channel means to the latents, one decode with one noise layer."""

import torch
import torch.nn.functional as F
from torch import nn


class Decoder(nn.Module):
    def noise_shapes(self):
        return [(1, 1, 4, 4)]


class Stub(nn.Module):
    def __init__(self, width, out_size, **_):
        super().__init__()
        self.mix = nn.Parameter(torch.empty(3, 3, 1, 1))
        self.to_lats = nn.Parameter(torch.empty(width, 3))
        self.generator = Decoder()

    def init_specs(self):
        return {"mix": ("normal", 1.0), "to_lats": ("uniform", 0.5, 1.0)}

    def make_noise(self, seed, device):
        g = torch.Generator(device=device).manual_seed(int(seed))
        return [[torch.randn(s, generator=g, device=device) for s in self.generator.noise_shapes()]]

    def n_decodes(self):
        return 1

    def forward(self, x, noises):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.mix)
        lats = F.linear(y.mean(dim=(2, 3)), self.to_lats)
        gen = y + noises[0][0].mean()
        mask = torch.sigmoid(gen[:, :1])
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return {"image": nhwc(gen), "mask": nhwc(mask), "gen_image": nhwc(gen), "lats": lats}


def build(network_g):
    return Stub(**network_g)


def batch_noise(model, seeds, device):
    draws = [model.make_noise(s, device) for s in seeds]
    return [[torch.cat([d[0][0] for d in draws])]]
'''

STUB_CONFIG = {
    "name": "stub_face", "source": "https://example.org/stub", "reference": "stub",
    "dtype": "float32", "network_g": {"width": 8, "out_size": 16},
    "micro": {"width": 4}, "engine": {}, "check_block": 2,
    "limits": {"lats_err": 0.0, "gen_image_err": 0.0, "mask_err": 0.0, "image_err": 0.0}}

# run from the copy's root, which the copy's portbench finds as its ROOT
PROBE = '''
import json, sys
import numpy as np
import torch
import portbench
from portbench import check, reference, run
from portbench.metrics.mfu_pct import model_flops_per_image
from portbench.weights import make_state_dict

cell = run.resolve(run.ROOT, "stub_b2")
config = cell["config"]
a, b = make_state_dict(config, 5, "cpu"), make_state_dict(config, 5, "cpu")
ref, model = check.reference(config, 5, torch.device("cpu"))
imgs = [np.full((16, 16, 3), 0.25 * k, np.float32) for k in range(3)]
outs = check.run_reference(ref, model, imgs, [1, 2, 3], torch.device("cpu"), 2)
print(json.dumps({
    "portbench": portbench.__file__, "reference": reference.module(config).__file__,
    "check_reference": ref.__file__,
    "state": {k: list(v.shape) for k, v in a.items()},
    "repeat": all(torch.equal(a[k], b[k]) for k in a),
    "to_lats_range": [float(a["to_lats"].min()), float(a["to_lats"].max())],
    "flops": model_flops_per_image(config),
    "outputs": {k: list(v.shape) for k, v in outs.items()},
    "end_to_end": [m["name"] for m in cell["end_to_end"]],
    "per_layer": [m["name"] for m in cell["per_layer"]]}))
'''


def _tree(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_joins_with_new_files_and_entries_only(tmp_path):
    pkg = run.PKG
    shutil.copytree(pkg, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree(tmp_path / "portbench")
    (tmp_path / "portbench/reference/stub.py").write_text(STUB)
    (tmp_path / "portbench/configs/stub_face.json").write_text(json.dumps(STUB_CONFIG))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub_face", "source": STUB_CONFIG["source"],
                             "file": "portbench/configs/stub_face.json", "reduced": [],
                             "why": "a stub family"})
    bench["workloads"].append({"name": "stub_b2", "config": "stub_face",
                               "traffic": bench["workloads"][0]["traffic"], "chips": 1,
                               "why": "a stub cell"})
    # the new cell joins an existing end-to-end metric and its per-layer metric
    joined = {"img_per_s", "mfu_pct"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in joined:
            m["workloads"].append("stub_b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    stub = str(tmp_path / "portbench/reference/stub.py")
    assert got["portbench"].startswith(str(tmp_path))
    assert got["reference"] == got["check_reference"] == stub
    assert got["state"] == {"mix": [3, 3, 1, 1], "to_lats": [8, 3]} and got["repeat"]
    assert 0.5 <= got["to_lats_range"][0] < got["to_lats_range"][1] <= 1.5
    # the stub's 1x1 conv at 16 px and its 3 -> 8 map, two FLOPs a multiply-add
    assert got["flops"] == 2 * 3 * 3 * 16 * 16 + 2 * 3 * 8
    assert got["outputs"] == {"lats": [3, 8], "gen_image": [3, 16, 16, 3],
                              "mask": [3, 16, 16, 1], "image": [3, 16, 16, 3]}
    assert set(got["end_to_end"]) == {"img_per_s", "setup_s"}
    assert got["per_layer"] == ["mfu_pct"]
    # no file of the benchmark was edited: the copy's old files are as they were
    after = _tree(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {p.relative_to(tmp_path / "portbench") for p in (
        tmp_path / "portbench/reference/stub.py", tmp_path / "portbench/configs/stub_face.json")}


@pytest.mark.parametrize("name", ["no_such", "__init__", "../model", "model.py", 7])
def test_a_reference_without_its_file_is_refused(name):
    config = {"name": "cfg_x", "reference": name, "network_g": {}}
    with pytest.raises(ValueError, match=r"cfg_x.*no reference") as e:
        reference.module(config)
    assert repr(name) in str(e.value)


@pytest.mark.parametrize("use", [reference.module, lambda c: make_state_dict(c, 1, "cpu"),
                                 model_flops_per_image],
                         ids=["lookup", "make_state_dict", "model_flops_per_image"])
def test_a_configuration_without_a_reference_is_refused(use):
    # no fall back to the E4E / ReStyle reference, whose network_g this is
    config = json.loads((run.PKG / "configs/e4e_face.json").read_text())
    del config["reference"]
    with pytest.raises(ValueError, match=r"'e4e_face' names no reference"):
        use(config)


def _digest(state):
    h = hashlib.sha256()
    for key, v in state.items():
        h.update(key.encode())
        h.update(repr(tuple(v.shape)).encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# the seed-77 weights at each configuration's micro size, as the harness
# drew them before configurations named their reference: every key, shape
# and bit
@pytest.mark.parametrize("workload, n_keys, digest", [
    ("e4e_f32_b8", 323, "92a80e6fd4edc9f1dedbce73752967a4d7238ebe70d5341758e0482a388e6e54"),
    ("restyle_f32_b4", 299, "0a856faee358e88c69bf1ed83f2a2e5655fd1866ac3afac58f8ee67acf544c14")],
    ids=["e4e_f32_b8", "restyle_f32_b4"])
def test_seeded_weights_are_bit_for_bit_as_pinned(workload, n_keys, digest):
    state = make_state_dict(micro_cell(workload)["config"], 77, "cpu")
    assert len(state) == n_keys and _digest(state) == digest


# GFLOP per 1024px image of the full-size references (PERF.md, section 3)
@pytest.mark.parametrize("config, gflop", [("e4e_face", 1306.86), ("restyle_face", 2281.30)])
def test_full_size_flop_counts_are_as_pinned(config, gflop):
    cfg = json.loads((run.PKG / "configs" / f"{config}.json").read_text())
    assert model_flops_per_image(cfg) / 1e9 == pytest.approx(gflop, abs=0.01)
