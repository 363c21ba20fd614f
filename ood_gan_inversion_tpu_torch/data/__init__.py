"""Data layer of the port (counterpart of data/): datasets by their YAML
`type`, and the sampler + prefetch loader."""

from ..utils.registry import DATASET_REGISTRY
from .face_dataset import CarDataset, FaceDataset
from .loader import EnlargedSampler, PrefetchLoader


def build_dataset(dataset_opt: dict):
    opt = dict(dataset_opt)
    return DATASET_REGISTRY.get(opt["type"])(opt)


def build_dataloader(dataset, dataset_opt, num_shards=1, shard_index=0,
                     seed=0, is_train=True, pin_keys=()):
    """The train loader: shard striding, the enlarge ratio and threaded
    prefetch; the validation loader: batch 1, in order, one thread.
    pin_keys: the batch entries stacked into page-locked tensors (for a
    card)."""
    if is_train:
        batch = dataset_opt.get("batch_size_per_gpu", 1)
        workers = dataset_opt.get("num_worker_per_gpu", 2)
        ratio = dataset_opt.get("dataset_enlarge_ratio", 1)
        sampler = EnlargedSampler(len(dataset), num_shards, shard_index,
                                  ratio=ratio, seed=seed,
                                  shuffle=dataset_opt.get("use_shuffle", True))
        return PrefetchLoader(dataset, sampler, batch_size=batch,
                              num_workers=workers, drop_last=True, pin_keys=pin_keys)
    sampler = EnlargedSampler(len(dataset), 1, 0, ratio=1, shuffle=False)
    return PrefetchLoader(dataset, sampler, batch_size=1, num_workers=1,
                          drop_last=False, pin_keys=pin_keys)

