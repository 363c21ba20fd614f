"""Host-side input pipeline (counterpart of data/loader.py): the sharded,
enlarged, epoch-seeded sampler and a threaded prefetch loader.

Decoding and augmentation run in a pool of threads that stays ahead of
the train step; batches come out in sampler order. The arrays under
`pin_keys` (the entries the train step reads) are stacked straight into
page-locked tensors, so that the train loop's `to(device,
non_blocking=True)` copies them to the card without blocking the host;
the rest stay numpy arrays.
"""

import queue
import threading

import numpy as np
import torch
from torch.utils.data import Sampler


class EnlargedSampler(Sampler):
    """Epoch-seeded permutation (`np.random.default_rng(seed + epoch)`, the
    JAX package's order), an enlarge ratio for iteration-based training, and
    shard-strided subsampling."""

    def __init__(self, dataset_len, num_shards=1, shard_index=0, ratio=1,
                 seed=0, shuffle=True):
        self.dataset_len = dataset_len
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.ratio = ratio
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0
        total = int(np.ceil(dataset_len * ratio / num_shards)) * num_shards
        self.num_samples = total // num_shards
        self.total_size = total

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            indices = g.permutation(self.total_size)
        else:
            indices = np.arange(self.total_size)
        indices = indices % self.dataset_len
        indices = indices[self.shard_index:self.total_size:self.num_shards]
        return iter(indices.tolist())

    def __len__(self):
        return self.num_samples


def default_collate(items, pin_keys=()):
    """Arrays stacked along a new batch axis (into page-locked tensors under
    pin_keys), anything else listed."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            if key in pin_keys:
                t = torch.empty((len(vals),) + vals[0].shape,
                                dtype=torch.from_numpy(vals[0][:0]).dtype, pin_memory=True)
                np.stack(vals, 0, out=t.numpy())
                out[key] = t
            else:
                out[key] = np.stack(vals, 0)
        else:
            out[key] = vals
    return out


class PrefetchLoader:
    """Iterates batches; `num_workers` threads decode items ahead of time."""

    def __init__(self, dataset, sampler, batch_size=1, num_workers=2,
                 drop_last=True, prefetch_batches=3, pin_keys=()):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.pin_keys = tuple(pin_keys)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        idx_q: queue.Queue = queue.Queue()
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches *
                                         self.batch_size + self.num_workers)
        indices = list(self.sampler)
        if self.drop_last:
            indices = indices[:len(indices) - len(indices) % self.batch_size]
        for i, idx in enumerate(indices):
            idx_q.put((i, idx))

        stop = threading.Event()

        def put(entry):
            while not stop.is_set():
                try:
                    out_q.put(entry, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            while not stop.is_set():
                try:
                    i, idx = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    put((i, self.dataset[idx]))
                except Exception as e:  # noqa: BLE001 -- raised in the consumer, in order
                    put((i, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        buffered = {}
        want = 0
        batch = []
        received = 0
        total = len(indices)
        try:
            while received < total:
                i, item = out_q.get()
                buffered[i] = item
                received += 1
                while want in buffered:
                    item = buffered.pop(want)
                    want += 1
                    if isinstance(item, Exception):
                        raise item
                    batch.append(item)
                    if len(batch) == self.batch_size:
                        yield default_collate(batch, self.pin_keys)
                        batch = []
        finally:
            # a consumer that stops early (or an error) ends the threads
            stop.set()
            for t in threads:
                t.join()
        if batch and not self.drop_last:
            yield default_collate(batch, self.pin_keys)
