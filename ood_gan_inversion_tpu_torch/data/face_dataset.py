"""Face / Car folder datasets (counterpart of data/face_dataset.py), numpy
on the host. Items are {'gt': (K, H, W, C), 'lr': (K, H, W, C),
'lq_size': (K,), 'deg_type': (K,), 'gt_path': [...]} with K = max_length
views: 'mix_id' takes K random images (or repeats one), 'sep_id' K views
of one identity folder; hflip augmentation; RGB in [-1, 1]; resized to
gt_size bilinearly (half-pixel centres, `utils/img_util.resize_linear`).
A failed read is retried 3 times, 1 s apart, each on a fresh random
index. The draws come from `random.Random(random_seed)` in the JAX
package's order, so that a seed gives the same items in both."""

import os
import os.path as osp
import random
import time

import numpy as np

from ..utils.img_util import imdecode, imread, resize_linear
from ..utils.logger import get_root_logger
from ..utils.registry import DATASET_REGISTRY
from .file_client import FileClient

IMG_EXTS = (".png", ".jpg", ".jpeg")


def _scan_folder(folder, mode):
    names = os.listdir(folder)
    if mode == "mix_id":
        names = [n for n in names if n.lower().endswith(IMG_EXTS)]
        try:
            names.sort(key=lambda x: int(osp.splitext(x)[0]))
        except ValueError:
            names.sort()
    else:
        try:
            names.sort(key=lambda x: int(x))
        except ValueError:
            names.sort()
    return [osp.join(folder, n) for n in names]


def pad_square(img, value=0):
    """HWC padded with `value` to a centred square."""
    h, w = img.shape[:2]
    length = max(h, w)
    ph, pw = (length - h) // 2, (length - w) // 2
    pads = [(ph, length - h - ph), (pw, length - w - pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pads, mode="constant", constant_values=value)


@DATASET_REGISTRY.register(name="Face_Dataset")
class FaceDataset:
    pad_to_square = False

    def __init__(self, opt):
        self.opt = opt
        self.mode = opt.get("mode", "mix_id")
        self.gt_size = opt.get("gt_size", None)
        self.max_length = opt.get("max_length", 1)
        self.fix_input = opt.get("fix_input", False)
        self.use_hflip = opt.get("use_hflip", False)
        self.mean = np.asarray(opt.get("mean", [0.5, 0.5, 0.5]), np.float32)
        self.std = np.asarray(opt.get("std", [0.5, 0.5, 0.5]), np.float32)
        self.rng = random.Random(opt.get("random_seed", None))

        io = opt.get("io_backend", {"type": "disk"}) or {"type": "disk"}
        self.io_type = io.get("type", "disk")
        sl = opt.get("slice", [0, None])
        if self.io_type == "packed":
            # dataroot_gt is an .ogipack file; keys are image names. The
            # reader is always the native one (JAX's `native` key chooses
            # between two readers of the same bytes)
            self.client = FileClient("packed", db_path=opt["dataroot_gt"])
            names = self.client.backend.keys()
            try:
                names.sort(key=lambda x: int(osp.splitext(x)[0]))
            except ValueError:
                names.sort()
            self.gt_paths = names[sl[0]:sl[1]]
        else:
            self.client = None
            folders = opt.get("dataroot_gt_list") or [opt["dataroot_gt"]]
            folders = [osp.expanduser(f) for f in folders]
            self.gt_paths = []
            for f in folders:
                self.gt_paths.extend(_scan_folder(f, self.mode))
            self.gt_paths = self.gt_paths[sl[0]:sl[1]]
        if not self.gt_paths:
            raise ValueError("No images found for dataset")

    def __len__(self):
        return len(self.gt_paths)

    def _paths_for(self, index):
        p = self.gt_paths[index]
        if self.mode == "mix_id":
            if self.fix_input or self.max_length == 1:
                return [p] * self.max_length
            idx = self.rng.sample(range(len(self)), self.max_length)
            return [self.gt_paths[i] for i in idx]
        # sep_id: p is an identity folder
        names = [n for n in os.listdir(p) if n.lower().endswith(IMG_EXTS)]
        names.sort(key=lambda x: int(osp.splitext(x)[0]))
        if self.fix_input:
            pick = self.rng.randrange(len(names))
            return [osp.join(p, names[pick])] * self.max_length
        if len(names) >= self.max_length:
            sample = self.rng.sample(range(len(names)), self.max_length)
        else:
            sample = list(range(len(names))) + [
                self.rng.randrange(len(names))
                for _ in range(self.max_length - len(names))]
        sample.sort()
        return [osp.join(p, names[j]) for j in sample]

    def _load(self, path):
        if self.client is not None:
            img = imdecode(self.client.get(path))
        else:
            img = imread(path, float32=True)
        if self.pad_to_square:
            img = pad_square(img)
        if self.gt_size is not None and img.shape[:2] != (self.gt_size, self.gt_size):
            img = resize_linear(img, self.gt_size)
        return img

    def __getitem__(self, index):
        retry = 3
        imgs, paths = None, None
        while retry > 0:
            try:
                paths = self._paths_for(index)
                imgs = [self._load(p) for p in paths]
                break
            except (OSError, ValueError, KeyError) as e:
                get_root_logger().warning(
                    f"Dataset read error: {e}, retries left {retry - 1}")
                index = self.rng.randrange(len(self))
                time.sleep(1)
                retry -= 1
        if imgs is None:
            raise IOError(f"Failed to load item {index} after retries")

        if self.use_hflip and self.rng.random() < 0.5:
            imgs = [img[:, ::-1, :].copy() for img in imgs]

        gt = np.stack([(img - self.mean) / self.std for img in imgs], 0)
        k = gt.shape[0]
        return {
            "gt": gt.astype(np.float32),
            "lr": gt.astype(np.float32),
            "lq_size": np.full((k,), gt.shape[1], np.float32),
            "deg_type": np.ones((k,), np.float32),
            "gt_path": paths,
        }


@DATASET_REGISTRY.register(name="Car_Dataset")
class CarDataset(FaceDataset):
    """Non-face domains: the same pipeline with square padding."""
    pad_to_square = True
