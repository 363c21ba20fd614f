"""The port's options, logger, image codec, OGIPack IO and data pipeline
(utils/options.py, utils/logger.py, utils/img_util.py, runtime/packio.py,
data/) against the JAX package on the CPU, on seeded synthetic images.

Tolerances: option dicts, sampler indices, item paths, the log line and
pack bytes are equal; an item's `gt` is bit for bit JAX's where no resize
happens and within 1e-5 absolute through the bilinear resize (a float32
matrix product against OpenCV's INTER_LINEAR); the image reader gives
JAX's pixels exactly."""

import io
import os
import os.path as osp
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from ood_gan_inversion_tpu.data import build_dataloader as j_build_dataloader
from ood_gan_inversion_tpu.data import build_dataset as j_build_dataset
from ood_gan_inversion_tpu.data.face_dataset import pad_square as j_pad_square
from ood_gan_inversion_tpu.data.loader import EnlargedSampler as JSampler
from ood_gan_inversion_tpu.runtime.packio import PackReader as JPackReader
from ood_gan_inversion_tpu.runtime.packio import write_pack as j_write_pack
from ood_gan_inversion_tpu.utils import img_util as j_img_util
from ood_gan_inversion_tpu.utils import logger as j_logger
from ood_gan_inversion_tpu.utils.options import parse_options as j_parse_options
from ood_gan_inversion_tpu_torch.data import build_dataloader, build_dataset
from ood_gan_inversion_tpu_torch.data.face_dataset import pad_square
from ood_gan_inversion_tpu_torch.data.file_client import FileClient
from ood_gan_inversion_tpu_torch.data.loader import EnlargedSampler
from ood_gan_inversion_tpu_torch.runtime import packio
from ood_gan_inversion_tpu_torch.utils import img_util, logger as p_logger
from ood_gan_inversion_tpu_torch.utils.options import (copy_opt_file, load_yaml, make_exp_dirs,
                                                       parse_options)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
OPTION_FILES = sorted(
    osp.relpath(osp.join(d, f), ROOT)
    for d, _, files in os.walk(osp.join(ROOT, "options")) for f in files if f.endswith(".yml"))
RESIZE_ATOL = 1e-5


# --- options ---------------------------------------------------------------------
@pytest.mark.parametrize("path", OPTION_FILES)
def test_parse_options_reads_every_option_file_as_jax(path, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    is_train = path.startswith(osp.join("options", "train"))
    argv = ["--opt", path, "--seed", "1"]
    assert parse_options(str(tmp_path), is_train, argv)[0] == \
        j_parse_options(str(tmp_path), is_train, argv)[0]


FORCE_VALUES = ["~", "4", "/tmp/x/y", "[1, 2]", "[/data/a,/data/b]", "true", "Off", "2e-5",
                "!!float 2e-5", "1.5", "-3", ".5", "1e5", "1.e+5", "0x1F", "017", "1_000",
                "10:30", "calculate_lpips", "lower", "{a: 1, 'b': [x, 'y z']}", "{a:1}", "",
                "'quoted # not a comment'", "[a, [b, c], {d: e}]", "null", "-.inf", "a: b"]


@pytest.mark.parametrize("value", FORCE_VALUES)
def test_force_yml_values_match_jax(value, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    argv = ["--opt", "options/train/micro_debug.yml", "--force_yml", f"train:new_key={value}"]
    try:
        ref = j_parse_options(str(tmp_path), True, argv)[0]
    except Exception as e:  # noqa: BLE001 -- the port refuses what JAX refuses
        with pytest.raises(type(e)):
            parse_options(str(tmp_path), True, argv)
        return
    assert parse_options(str(tmp_path), True, argv)[0] == ref


def test_load_yaml_without_pyyaml_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)       # import yaml now raises
    with pytest.raises(ImportError, match="PyYAML"):
        load_yaml("a: 1")


ARGVS = {
    "plain": ["--opt", "options/train/E4E_Face.yml", "--seed", "3"],
    "force": ["--opt", "options/train/micro_debug.yml", "--force_yml",
              "datasets:train:dataroot_gt=/data/x", "train:total_iter=12", "val:val_freq=~",
              "network_g:ModSize=256", "logger:print_freq=5", "new:key:deep=[1, 2]",
              "train:optim_g:lr=0.0003"],
    "debug": ["--opt", "options/train/E4E_Face.yml", "--debug", "--auto_resume"],
    "seedless_yaml_seed": ["--opt", "options/train/ReStyle_Face.yml"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_options_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    argv = ARGVS[name]
    opt, parsed = parse_options(str(tmp_path), True, argv)
    jopt, jparsed = j_parse_options(str(tmp_path), True, argv)
    assert opt == jopt
    assert parsed.device == "cuda" and vars(jparsed) == {
        k: v for k, v in vars(parsed).items() if k != "device"}
    assert parse_options(str(tmp_path), False, argv + ["--device", "cpu"])[0] == \
        j_parse_options(str(tmp_path), False, argv)[0]


def test_copy_opt_file_and_exp_dirs(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    opt, parsed = parse_options(str(tmp_path), True, ["--opt", "options/train/micro_debug.yml"])
    make_exp_dirs(opt)
    copy_opt_file(parsed.opt, opt["path"]["experiments_root"])
    for key in ("experiments_root", "models", "training_states", "visualization"):
        assert osp.isdir(opt["path"][key])
    snap = open(osp.join(opt["path"]["experiments_root"], "micro_debug.yml")).read()
    assert snap.startswith("# GENERATE TIME: ")
    assert load_yaml(snap) == load_yaml(open("options/train/micro_debug.yml"))


# --- logger ------------------------------------------------------------------------
class _Lines:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


@pytest.mark.parametrize("log_vars", [
    {"epoch": 0, "iter": 1, "lrs": [2e-5], "l_d": 1.25, "l_g": np.float32(0.5)},
    {"epoch": 12, "iter": 123456, "lrs": [2e-5, 1.5e-6], "l_total": torch.tensor(3.0),
     "real_score": -0.25},
    {"iter": 7},
])
def test_message_logger_matches_jax(log_vars):
    opt = {"name": "OOD_faceGAN_e4e", "logger": {"print_freq": 1}, "train": {"total_iter": 10}}
    out = []
    for mod in (p_logger, j_logger):
        ml = mod.MessageLogger(opt, 1)
        ml.logger = _Lines()
        ml(dict(log_vars))
        out.append(ml.logger.lines)
    assert out[0] == out[1] and len(out[0]) == 1


def test_avg_timer_and_tb_logger_gate(tmp_path, monkeypatch):
    t = p_logger.AvgTimer()
    t.record()
    t.record()
    assert t.count == 2 and t.get_avg_time() >= 0.0
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert p_logger.init_tb_logger(str(tmp_path)) is None


# --- image codec ---------------------------------------------------------------------
def _png_cases():
    rs = np.random.RandomState(0)
    base = (np.cumsum(rs.randint(-3, 4, (37, 53, 4)), axis=1) % 256).astype(np.uint8)
    cases = {}
    for name, img in {"bgr": base[..., :3], "gray": base[..., 0], "bgra": base,
                      "bgr16": base[..., :3].astype(np.uint16) * 257 + 3,
                      "noise": rs.randint(0, 256, (20, 31, 3)).astype(np.uint8)}.items():
        cases[name] = cv2.imencode(".png", img)[1].tobytes()
    for mode in ("P", "L", "LA", "1", "RGBA"):
        b = io.BytesIO()
        Image.fromarray(base[..., 2::-1].copy()).convert(mode).save(b, "PNG")
        cases["pil_" + mode] = b.getvalue()
    return cases


PNG_CASES = _png_cases()


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_image_reader_matches_jax(name, tmp_path):
    data = PNG_CASES[name]
    path = str(tmp_path / "a.png")
    open(path, "wb").write(data)
    ref = j_img_util.imread(path)
    np.testing.assert_array_equal(img_util.imread(path), ref)
    np.testing.assert_array_equal(img_util.imdecode(data), ref)
    np.testing.assert_array_equal(img_util.imread(path, float32=False),
                                  cv2.imdecode(np.frombuffer(data, np.uint8),
                                               cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("shape", [(21, 17), (21, 17, 3), (21, 17, 4)])
def test_image_writer_matches_jax(shape, tmp_path):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    img_util.imwrite(img, str(tmp_path / "sub" / "b.png"))
    j_img_util.imwrite(img, str(tmp_path / "jax" / "b.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "sub" / "b.png"), cv2.IMREAD_UNCHANGED),
                                  img)
    assert open(tmp_path / "sub" / "b.png", "rb").read() == \
        open(tmp_path / "jax" / "b.png", "rb").read()


def test_image_codec_without_opencv_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)        # import cv2 now raises
    with pytest.raises(ImportError, match="cv2"):
        img_util.imread(str(tmp_path / "a.png"))
    with pytest.raises(ImportError, match="cv2"):
        img_util.imwrite(np.zeros((4, 4, 3), np.uint8), str(tmp_path / "a.png"))


@pytest.mark.parametrize("hw,size", [((64, 64), 32), ((37, 53), 64), ((100, 80), 48),
                                     ((16, 16), 64)])
def test_resizes_match_opencv(hw, size):
    img = np.random.RandomState(2).rand(*hw, 3).astype(np.float32)
    ref = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
    assert np.abs(img_util.resize_linear(img, size) - ref).max() <= RESIZE_ATOL
    ref = cv2.resize(img[..., 0], (size, size), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(img_util.resize_nearest(img[..., 0], size), ref)


@pytest.mark.parametrize("hw", [(30, 50), (51, 20), (16, 16)])
def test_pad_square_matches_jax(hw):
    img = np.random.RandomState(3).rand(*hw, 3).astype(np.float32)
    np.testing.assert_array_equal(pad_square(img), j_pad_square(img))


# --- OGIPack -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Synthetic PNGs: 8 square 40px, 5 non-square, and 3 identity folders
    of 1-4 views, each image seeded."""
    d = tmp_path_factory.mktemp("torch_data")
    rs = np.random.RandomState(0)
    os.makedirs(d / "sq")
    for i in range(8):
        cv2.imwrite(str(d / "sq" / f"{i}.png"), rs.randint(0, 256, (40, 40, 3)).astype(np.uint8))
    os.makedirs(d / "rect")
    for i in range(5):
        h, w = (30, 44) if i % 2 else (48, 26)
        cv2.imwrite(str(d / "rect" / f"{i}.png"), rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
    for ident, n in enumerate((4, 1, 3)):
        os.makedirs(d / "ids" / str(ident))
        for j in range(n):
            cv2.imwrite(str(d / "ids" / str(ident) / f"{j}.png"),
                        rs.randint(0, 256, (40, 40, 3)).astype(np.uint8))
    items = [(f"{i}.png", open(d / "sq" / f"{i}.png", "rb").read()) for i in range(8)]
    j_write_pack(str(d / "jax.ogipack"), items)
    packio.write_pack(str(d / "port.ogipack"), items)
    return d, items


@pytest.mark.parametrize("jax_native", [True, False])
def test_packio_reads_jax_packs_and_jax_reads_the_ports(images, jax_native):
    """The port's reader against JAX's native and pure-Python readers."""
    d, items = images
    assert open(d / "jax.ogipack", "rb").read() == open(d / "port.ogipack", "rb").read()
    for mine, theirs in ((packio.PackReader(str(d / "jax.ogipack")),
                          JPackReader(str(d / "jax.ogipack"), native=jax_native)),
                         (JPackReader(str(d / "port.ogipack"), native=jax_native),
                          packio.PackReader(str(d / "port.ogipack")))):
        assert len(mine) == len(theirs) == len(items)
        for i, (name, blob) in enumerate(items):
            assert mine.name(i) == theirs.name(i) == name
            assert mine.read(i) == theirs.read(i) == blob
            mine.prefetch(i)
        mine.close()
        theirs.close()


@pytest.mark.parametrize("name", ["sq/0.png", "missing.ogipack"])
def test_packio_refuses_a_file_that_is_not_a_pack(images, name):
    d, _ = images
    with pytest.raises(IOError, match="OGIPACK"):
        packio.PackReader(str(d / name))


def test_packio_failed_native_build_raises(monkeypatch):
    def no_compiler():
        raise OSError("no g++")
    monkeypatch.setattr(packio, "_lib", None)
    monkeypatch.setattr(packio, "build_native", no_compiler)
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        packio.PackReader("unused.ogipack")


def test_packio_builds_its_library_under_build():
    so = packio.build_native()
    assert osp.exists(so) and osp.join("build", "packio") in so


def test_file_client_backends(images, tmp_path):
    d, items = images
    assert FileClient("disk").get(str(d / "sq" / "3.png")) == items[3][1]
    fc = FileClient("packed", db_path=str(d / "jax.ogipack"))
    assert fc.get("5.png") == fc.get(5) == items[5][1]
    with pytest.raises(ImportError, match="lmdb"):
        FileClient("lmdb", db_path=str(tmp_path))
    with pytest.raises(ImportError, match="mc"):
        FileClient("memcached", server_list_cfg="", client_cfg="")
    with pytest.raises(ValueError):
        FileClient("s3")


# --- sampler, datasets, loader ------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("ratio", [1, 3])
@pytest.mark.parametrize("shards", [1, 4])
def test_enlarged_sampler_matches_jax(seed, ratio, shards):
    for epoch in (0, 1, 5):
        for shard in range(shards):
            mine = EnlargedSampler(10, shards, shard, ratio=ratio, seed=seed)
            theirs = JSampler(10, shards, shard, ratio=ratio, seed=seed)
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(mine) == list(theirs) and len(mine) == len(theirs)
    assert isinstance(mine, torch.utils.data.Sampler)
    assert list(EnlargedSampler(7, shuffle=False)) == list(JSampler(7, shuffle=False))


DATASETS = {
    "mix_id K=1 hflip": ("sq", {"mode": "mix_id", "max_length": 1, "use_hflip": True}),
    "mix_id K=2 hflip": ("sq", {"mode": "mix_id", "max_length": 2, "use_hflip": True}),
    "mix_id K=2 resize": ("sq", {"mode": "mix_id", "max_length": 2, "gt_size": 64}),
    "mix_id fix_input": ("sq", {"mode": "mix_id", "max_length": 3, "fix_input": True}),
    "sep_id K=2": ("ids", {"mode": "sep_id", "max_length": 2, "use_hflip": True}),
    "sep_id K=3 fix": ("ids", {"mode": "sep_id", "max_length": 3, "fix_input": True}),
    "car pad": ("rect", {"type": "Car_Dataset", "mode": "mix_id", "gt_size": 32,
                         "use_hflip": True}),
    "packed": ("jax.ogipack", {"mode": "mix_id", "max_length": 2, "use_hflip": True,
                               "io_backend": {"type": "packed"}}),
    "packed python resize": ("jax.ogipack", {"mode": "mix_id", "gt_size": 48,
                                             "io_backend": {"type": "packed", "native": False}}),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_match_jax(images, name):
    d, _ = images
    root, extra = DATASETS[name]
    opt = {"type": "Face_Dataset", "dataroot_gt": str(d / root), "random_seed": 11,
           "phase": "train", **extra}
    mine, theirs = build_dataset(opt), j_build_dataset(opt)
    assert len(mine) == len(theirs)
    resized = "gt_size" in extra
    for i in list(range(len(mine))) * 2:
        a, b = mine[i], theirs[i]
        assert set(a) == set(b) and a["gt_path"] == b["gt_path"]
        for k in ("gt", "lr", "lq_size", "deg_type"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if resized:
                assert np.abs(a[k] - b[k]).max() <= RESIZE_ATOL, k
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _loader_opt(images, workers):
    d, _ = images
    ds = {"type": "Face_Dataset", "dataroot_gt": str(d / "sq"), "mode": "mix_id",
          "max_length": 2, "use_hflip": True, "random_seed": 4, "phase": "train"}
    lo = {"batch_size_per_gpu": 3, "num_worker_per_gpu": workers,
          "dataset_enlarge_ratio": 2, "use_shuffle": True}
    return ds, lo


def test_prefetch_loader_one_worker_matches_jax(images):
    ds, lo = _loader_opt(images, 1)
    mine = build_dataloader(build_dataset(ds), lo, seed=9)
    theirs = j_build_dataloader(j_build_dataset(ds), lo, seed=9)
    assert len(mine) == len(theirs) == 5
    for epoch in (0, 1):
        mine.sampler.set_epoch(epoch)
        theirs.sampler.set_epoch(epoch)
        got, ref = list(mine), list(theirs)
        assert len(got) == len(ref) == 5
        for a, b in zip(got, ref):
            assert a["gt_path"] == b["gt_path"]
            for k in ("gt", "lr", "lq_size", "deg_type"):
                np.testing.assert_array_equal(a[k], b[k])
    val = build_dataloader(build_dataset(ds), {}, is_train=False)
    jval = j_build_dataloader(j_build_dataset(ds), {}, is_train=False)
    assert [b["gt_path"] for b in val] == [b["gt_path"] for b in jval]


def test_prefetch_loader_several_workers_shapes_and_count(images):
    ds, lo = _loader_opt(images, 4)
    loader = build_dataloader(build_dataset(ds), lo, seed=9)
    batches = list(loader)
    assert len(batches) == len(loader) == 5
    for b in batches:
        assert b["gt"].shape == (3, 2, 40, 40, 3) and b["lq_size"].shape == (3, 2)
        assert len(b["gt_path"]) == 3
    # stopping early ends the loader's threads
    it = iter(loader)
    next(it)
    it.close()


def test_prefetch_loader_surfaces_item_errors_in_order(images):
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise RuntimeError("item 2")
            return {"x": np.full((2,), i, np.float32)}

    loader = build_dataloader(Broken(), {"batch_size_per_gpu": 1, "num_worker_per_gpu": 3,
                                         "use_shuffle": False})
    it = iter(loader)
    assert [float(next(it)["x"][0, 0]) for _ in range(2)] == [0.0, 1.0]
    with pytest.raises(RuntimeError, match="item 2"):
        next(it)


@pytest.mark.cuda
def test_pinned_batches_on_card(images):
    """On the card: the train loader's batches hold page-locked tensors
    under pin_keys, with the unpinned batches' values, and numpy arrays
    elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds, lo = _loader_opt(images, 1)
    pinned = list(build_dataloader(build_dataset(ds), lo, seed=9, pin_keys=("gt",)))
    plain = list(build_dataloader(build_dataset(ds), lo, seed=9))
    for a, b in zip(pinned, plain):
        assert a["gt"].is_pinned() and isinstance(a["lr"], np.ndarray)
        np.testing.assert_array_equal(a["gt"].numpy(), b["gt"])
        assert torch.equal(a["gt"].to("cuda", non_blocking=True).cpu(), a["gt"])
