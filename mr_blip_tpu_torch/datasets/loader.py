"""Batching loaders: sharded sampling, background prefetch, ratio mixing
(the port's counterpart of ``mr_blip_tpu/datasets/loader.py``).

Replacements for the reference loader stack
(``lavis/datasets/datasets/dataloader_utils.py:15-163`` + torch DataLoader
with DistributedSampler):

* :class:`DataLoader` — deterministic per-process sharding
  (``order[rank::world_size]`` of an epoch-seeded shuffle that every rank
  draws alike; with ``drop_last``, training, only whole global batches of
  ``world_size · batch_size`` rows, so that every rank takes as many steps:
  ``parallel/mesh.py::rank_rows``) with a background thread pool decoding
  samples ahead (the host-side analog of DataLoader workers).
* :class:`PrefetchLoader` — copies the next batch's frames into pinned host
  memory and on to the card on a side CUDA stream while the current batch
  computes (the JAX package puts it on the device one batch ahead); on the
  CPU it passes batches through unchanged.
* :class:`IterLoader` — infinite iterator that bumps the epoch on wrap.
* :class:`MultiIterLoader` — ratio-weighted sampling across loaders.
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from mr_blip_tpu_torch.parallel.mesh import rank_rows


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 2,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 42,
        collate_fn=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0
        self.collate_fn = collate_fn or getattr(
            dataset, "collater", None
        ) or _default_collate

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> List[int]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        return rank_rows(order, self.rank, self.world_size,
                         self.batch_size if self.drop_last else None)

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = self._indices()
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # Pipeline: keep up to num_workers batches in flight.
            pending = []
            it = iter(batches)

            def submit_next():
                try:
                    b = next(it)
                except StopIteration:
                    return None
                return pool.submit(
                    lambda idxs: self.collate_fn([self.dataset[i] for i in idxs]), b
                )

            for _ in range(self.num_workers):
                fut = submit_next()
                if fut:
                    pending.append(fut)
            while pending:
                fut = pending.pop(0)
                nxt = submit_next()
                if nxt:
                    pending.append(nxt)
                yield fut.result()


def _default_collate(samples):
    from mr_blip_tpu_torch.datasets.base_dataset import default_collate

    return default_collate(samples)


class PrefetchLoader:
    """Keeps the next batch's host-to-device copy in flight.

    Only the frames are copied: the one array of a batch the model reads on
    the device (timestamps, durations and strings feed the host-side prompt
    assembly and stay numpy). They are copied into pinned memory and issued
    to ``device`` on a side stream; the consumer's stream waits on that copy
    before the batch is yielded, and the tensor is marked as used by the
    consumer's stream so that its memory is not reused while a kernel still
    reads it. On the CPU, batches pass through unchanged.
    """

    KEY = "video"

    def __init__(self, loader, device="cuda"):
        self.loader = loader
        self.device = torch.device(device)

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def _put(self, batch, stream):
        batch = dict(batch)
        with torch.cuda.stream(stream):
            value = batch.get(self.KEY)
            if isinstance(value, np.ndarray):
                pinned = torch.from_numpy(np.ascontiguousarray(value)).pin_memory()
                batch[self.KEY] = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return batch, done

    def _ready(self, put):
        batch, done = put
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        value = batch.get(self.KEY)
        if isinstance(value, torch.Tensor) and value.is_cuda:
            value.record_stream(consumer)
        return batch

    def __iter__(self):
        if self.device.type != "cuda":
            yield from self.loader
            return
        stream = torch.cuda.Stream(self.device)
        it = iter(self.loader)
        try:
            ahead = self._put(next(it), stream)
        except StopIteration:
            return
        for batch in it:
            nxt = self._put(batch, stream)  # copies overlap the consumer's work
            yield self._ready(ahead)
            ahead = nxt
        yield self._ready(ahead)


class IterLoader:
    """Infinite wrapper; bumps epoch on wrap (dataloader_utils.py:127-162)."""

    def __init__(self, dataloader, use_distributed: bool = False):
        self._dataloader = dataloader
        self.iter_loader = iter(self._dataloader)
        self._epoch = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    def __next__(self):
        try:
            return next(self.iter_loader)
        except StopIteration:
            self._epoch += 1
            if hasattr(self._dataloader, "set_epoch"):
                self._dataloader.set_epoch(self._epoch)
            self.iter_loader = iter(self._dataloader)
            return next(self.iter_loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self._dataloader)


class MultiIterLoader:
    """Sample from several loaders with given ratios (dataloader_utils.py:15-43)."""

    def __init__(self, loaders: Sequence, ratios: Optional[Sequence[float]] = None,
                 seed: int = 0):
        for loader in loaders:
            assert hasattr(loader, "__next__"), "Loader {} has no __next__".format(loader)
        if ratios is None:
            ratios = [1.0] * len(loaders)
        total = sum(ratios)
        self.loaders = list(loaders)
        self.ratios = [r / total for r in ratios]
        self._rng = random.Random(seed)

    def __next__(self):
        loader_idx = self._rng.choices(
            range(len(self.loaders)), self.ratios, k=1
        )[0]
        return next(self.loaders[loader_idx])

    def __iter__(self):
        return self
