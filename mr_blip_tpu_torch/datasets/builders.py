"""Dataset builders: YAML build_info -> per-split dataset objects (the port's
counterpart of ``mr_blip_tpu/datasets/builders.py``: the base builder, the
moment-retrieval, MR-questions and MC-VideoQA builders; the TAL builder
waits for its dataset).

Mirrors the reference builder layer
(``lavis/datasets/builders/base_dataset_builder.py:23-226`` +
``moment_retrieval_builder.py`` + ``video_qa_builder.py``): builders are
registered by dataset name, resolve a default config YAML, construct
train/eval processors from the config, and instantiate one dataset per
split from ``build_info.annotations.<split>.storage`` and
``build_info.videos.storage``.
"""

from __future__ import annotations

import logging
import os
import warnings

from mr_blip_tpu_torch.common import utils
from mr_blip_tpu_torch.common.config import load_yaml
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets.mr_datasets import (
    MCVideoQADataset,
    MomentRetrievalDataset,
    MomentRetrievalQuestionsDataset,
)
from mr_blip_tpu_torch.processors.text_processors import BaseProcessor


class BaseDatasetBuilder:
    train_dataset_cls = None
    eval_dataset_cls = None
    data_type = "videos"

    DATASET_CONFIG_DICT = {}

    def __init__(self, cfg=None):
        if cfg is None:
            self.config = load_yaml(self.default_config_path())["datasets"]
            self.config = next(iter(self.config.values()))
        elif isinstance(cfg, str):
            self.config = load_yaml(cfg)["datasets"]
            self.config = next(iter(self.config.values()))
        else:
            self.config = cfg
        self.vis_processors = {"train": BaseProcessor(), "eval": BaseProcessor()}
        self.text_processors = {"train": BaseProcessor(), "eval": BaseProcessor()}

    @classmethod
    def default_config_path(cls, type="default"):
        rel = cls.DATASET_CONFIG_DICT.get(type)
        return utils.get_abs_path(rel) if rel else None

    def build_datasets(self):
        # Downloads are deployment-specific; annotation/video paths are
        # expected to exist locally (process-0 gating would wrap here).
        logging.info("Building datasets...")
        return self.build()

    @staticmethod
    def _build_proc_from_cfg(cfg):
        if cfg is None:
            return None
        proc_cls = registry.get_processor_class(cfg["name"])
        assert proc_cls is not None, f"unknown processor {cfg['name']!r}"
        return proc_cls.from_config(cfg)

    def build_processors(self):
        vis_proc_cfg = self.config.get("vis_processor")
        txt_proc_cfg = self.config.get("text_processor")
        if vis_proc_cfg is not None:
            for split in ("train", "eval"):
                proc = self._build_proc_from_cfg(vis_proc_cfg.get(split))
                if proc is not None:
                    self.vis_processors[split] = proc
        if txt_proc_cfg is not None:
            for split in ("train", "eval"):
                proc = self._build_proc_from_cfg(txt_proc_cfg.get(split))
                if proc is not None:
                    self.text_processors[split] = proc

    def build(self):
        self.build_processors()
        build_info = self.config["build_info"]
        ann_info = build_info["annotations"]
        vis_info = build_info.get(self.data_type)

        datasets = {}
        for split in ann_info.keys():
            if split not in ("train", "val", "test"):
                continue
            is_train = split == "train"

            vis_processor = self.vis_processors["train" if is_train else "eval"]
            text_processor = self.text_processors["train" if is_train else "eval"]

            ann_paths = ann_info[split]["storage"]
            if isinstance(ann_paths, str):
                ann_paths = [ann_paths]
            ann_paths = [
                p if os.path.isabs(p) else utils.get_cache_path(p)
                for p in ann_paths
            ]

            vis_path = vis_info["storage"]
            if not os.path.isabs(vis_path) and not vis_path.startswith("synthetic"):
                vis_path = utils.get_cache_path(vis_path)
            if not os.path.exists(vis_path) and not vis_path.startswith("synthetic"):
                warnings.warn(f"storage path {vis_path} does not exist.")

            dataset_cls = self.train_dataset_cls if is_train else self.eval_dataset_cls
            datasets[split] = dataset_cls(
                vis_processor=vis_processor,
                text_processor=text_processor,
                ann_paths=ann_paths,
                vis_root=vis_path,
            )
        return datasets


class MomentRetrievalBuilder(BaseDatasetBuilder):
    train_dataset_cls = MomentRetrievalDataset
    eval_dataset_cls = MomentRetrievalDataset


class MomentRetrievalQuestionsBuilder(BaseDatasetBuilder):
    train_dataset_cls = MomentRetrievalQuestionsDataset
    eval_dataset_cls = MomentRetrievalQuestionsDataset


class MCVideoQABuilder(BaseDatasetBuilder):
    train_dataset_cls = MCVideoQADataset
    eval_dataset_cls = MCVideoQADataset


def _mr_builder(name, config="default"):
    @registry.register_builder(name)
    class _Builder(MomentRetrievalBuilder):
        DATASET_CONFIG_DICT = {"default": f"configs/datasets/{name}/defaults.yaml"}

    _Builder.__name__ = f"{name}_builder"
    return _Builder


def _qa_builder(name):
    @registry.register_builder(name)
    class _Builder(MCVideoQABuilder):
        DATASET_CONFIG_DICT = {"default": f"configs/datasets/{name}/defaults.yaml"}

    _Builder.__name__ = f"{name}_builder"
    return _Builder


# Moment retrieval (reference moment_retrieval_builder.py:37-104)
QVHBuilder = _mr_builder("qvh")
Charades_STABuilder = _mr_builder("charades_sta")
Charades_STA_seconds_decimal_Builder = _mr_builder("charades_sta-seconds_decimal")
Charades_STA_relative_decimal_Builder = _mr_builder("charades_sta-relative_decimal")
Charades_STA_relative_integer_Builder = _mr_builder("charades_sta-relative_integer")
ANetBuilder = _mr_builder("anet")
TACoSBuilder = _mr_builder("tacos")
TACoSRelativeIntegerBuilder = _mr_builder("tacos-relative_integer")
MixedBuilder = _mr_builder("mixed")


@registry.register_builder("qvhQ")
class QVHQBuilder(MomentRetrievalQuestionsBuilder):
    DATASET_CONFIG_DICT = {"default": "configs/datasets/qvhQ/defaults.yaml"}


# Multiple-choice VideoQA (reference video_qa_builder.py:62-110)
NextQABuilder = _qa_builder("nextqa")
NextGQABuilder = _qa_builder("nextgqa")
STARBuilder = _qa_builder("star")
TVQABuilder = _qa_builder("tvqa")
How2QABuilder = _qa_builder("how2qa")
VLEPBuilder = _qa_builder("vlep")


# SeViLA-style QVH VideoQA view (reference video_qa_builder.py:104-110)
@registry.register_builder("qvh_sevilla")
class QVHSevillaBuilder(MCVideoQABuilder):
    DATASET_CONFIG_DICT = {"default": "configs/datasets/qvh/defaults.yaml"}
