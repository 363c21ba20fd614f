"""The one load generator: images and request seeds from a traffic file's
parameters and the run's seed.

A traffic file (`portbench/traffic/<name>.json`) gives:
  loop           the load loop's kind, a module `portbench/loops/<loop>.py`
  batch          images per call
  ahead          calls queued before the oldest one's outputs are read
  pool           images made at set-up, that the calls draw from
  image_size     the side of each square RGB image, pixels
  image_coarse   the side of the random field each image is upsampled from
  check_batches  calls of the window whose outputs the check compares
Every seed gives the same sizes and the same number of calls; the seed
changes the pixels, the draws from the pool and the request seeds.
"""

import numpy as np
import torch
import torch.nn.functional as F


def child_seeds(seed, n=4):
    """n independent 63-bit seeds from the run's seed (any whole number)."""
    state = np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(n, dtype=np.uint64)
    return [int(s) >> 1 for s in state]


def image_pool(seed, traffic, device):
    """`pool` HWC float32 images in [0, 1] as numpy arrays on the host: a
    smooth random field (bilinear from image_coarse px) plus fine noise,
    made on `device` in one draw."""
    n, size, coarse = traffic["pool"], traffic["image_size"], traffic["image_coarse"]
    g = torch.Generator(device=device).manual_seed(seed)
    field = torch.rand((n, 3, coarse, coarse), generator=g, device=device)
    fine = torch.rand((n, 3, size, size), generator=g, device=device)
    img = F.interpolate(field, size=(size, size), mode="bilinear", align_corners=False)
    img = (0.85 * img + 0.15 * fine).permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return list(img)


class Requests:
    """The calls of a run, in order: each a list of pool indices (distinct)
    and as many distinct request seeds."""

    def __init__(self, seed, traffic):
        self.rng = np.random.default_rng(seed)
        self.batch, self.pool = traffic["batch"], traffic["pool"]
        if self.batch > self.pool:
            raise ValueError(f"batch {self.batch} > pool {self.pool}")

    def next(self):
        idx = self.rng.choice(self.pool, self.batch, replace=False).tolist()
        seeds = []
        while len(seeds) < self.batch:
            s = int(self.rng.integers(0, 2 ** 62))
            if s not in seeds:
                seeds.append(s)
        return idx, seeds
