"""Annotation-list datasets and batch collation (the port's copy of
``mr_blip_tpu/datasets/base_dataset.py``).

Counterpart of the reference ``lavis/datasets/datasets/base_dataset.py``:
JSON annotation files are concatenated, every record gets an
``instance_id``, and collation stacks numpy/scalars and keeps strings as
lists.  ``ConcatDataset`` intersects sample keys like the reference's
custom collater (base_dataset.py:64-83).
"""

from __future__ import annotations

import json
from typing import Iterable, List

import numpy as np


def default_collate(samples: List[dict]) -> dict:
    if not samples:
        return {}
    keys = samples[0].keys()
    batch = {}
    for k in keys:
        vals = [s[k] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            batch[k] = np.stack(vals)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            batch[k] = np.asarray(vals)
        else:
            batch[k] = vals
    return batch


class BaseDataset:
    def __init__(self, vis_processor=None, text_processor=None,
                 vis_root=None, ann_paths=()):
        self.vis_root = vis_root
        self.annotation = []
        for ann_path in ann_paths:
            with open(ann_path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                loaded = list(loaded.values())
            self.annotation.extend(loaded)

        self.vis_processor = vis_processor
        self.text_processor = text_processor
        self._add_instance_ids()

    def __len__(self):
        return len(self.annotation)

    def collater(self, samples):
        return default_collate(samples)

    def set_processors(self, vis_processor, text_processor):
        self.vis_processor = vis_processor
        self.text_processor = text_processor

    def _add_instance_ids(self, key="instance_id"):
        for idx, ann in enumerate(self.annotation):
            ann[key] = str(idx)


class ConcatDataset:
    """Concatenation that collates only the keys shared by all sub-datasets."""

    def __init__(self, datasets: Iterable):
        self.datasets = list(datasets)
        self._lengths = [len(d) for d in self.datasets]
        self._offsets = np.cumsum([0] + self._lengths)

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets[1:], idx, side="right"))
        return self.datasets[d][idx - self._offsets[d]]

    def collater(self, samples):
        shared_keys = set.intersection(*(set(s.keys()) for s in samples))
        samples = [{k: s[k] for k in shared_keys} for s in samples]
        return default_collate(samples)
