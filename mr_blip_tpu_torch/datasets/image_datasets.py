"""Image caption and retrieval datasets and their builders (the port's copy
of the caption and retrieval half of ``mr_blip_tpu/datasets/image_datasets.py``).

Compact counterparts of the reference LAVIS image dataset layer
(``lavis/datasets/datasets/{caption_datasets,retrieval_datasets}.py`` +
their builders): annotation schema ``{image, caption, image_id}``, the image
decoded through the port's ``datasets/video_reader.py`` single-frame path
(any FFmpeg-readable image works through the same library; a
``synthetic://`` image needs no FFmpeg), CLIP normalization as the video
processors apply it. Every image is read at ``image_size`` (224) whatever
the config's processors say, as in the JAX package. The image-QA,
classification, pretraining-pair and image-folder datasets wait for their
families (ROADMAP Queue 1).
"""

from __future__ import annotations

import os

import numpy as np

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets.base_dataset import BaseDataset
from mr_blip_tpu_torch.datasets.builders import BaseDatasetBuilder
from mr_blip_tpu_torch.datasets.video_reader import VideoReader
from mr_blip_tpu_torch.processors.video_processors import normalize_clip


def load_image(path: str, image_size: int = 224) -> np.ndarray:
    """(H, W, C) float32 normalized image via the native decoder."""
    vr = VideoReader(path, width=image_size, height=image_size)
    frame = vr.get_batch([0])[0]
    vr.close()
    return normalize_clip(frame.astype(np.float32))


class CaptionDataset(BaseDataset):
    """{image, caption, image_id} records (caption_datasets.py)."""

    image_size = 224

    def __getitem__(self, index):
        ann = self.annotation[index]
        image = load_image(os.path.join(self.vis_root, ann["image"]),
                           self.image_size)
        caption = ann["caption"]
        if self.text_processor is not None:
            caption = self.text_processor(caption)
        return {
            "image": image,
            "text_input": caption,
            "image_id": ann.get("image_id", ann.get("instance_id")),
            "gt_captions": ann.get("gt_captions", [ann["caption"]]),
        }


class RetrievalDataset(CaptionDataset):
    """Caption records + an ``i2t_gt`` map for gallery evaluation."""

    @property
    def i2t_gt(self):
        mapping = {}
        img_index = {}
        for t_idx, ann in enumerate(self.annotation):
            i_idx = img_index.setdefault(ann["image"], len(img_index))
            mapping.setdefault(i_idx, []).append(t_idx)
        return mapping


class CaptionBuilder(BaseDatasetBuilder):
    data_type = "images"
    train_dataset_cls = CaptionDataset
    eval_dataset_cls = CaptionDataset


class RetrievalBuilder(BaseDatasetBuilder):
    data_type = "images"
    train_dataset_cls = RetrievalDataset
    eval_dataset_cls = RetrievalDataset


def _make(name, base):
    @registry.register_builder(name)
    class _B(base):
        DATASET_CONFIG_DICT = {"default": f"configs/datasets/{name}/defaults.yaml"}

    _B.__name__ = f"{name}_builder"
    return _B


# Caption (reference coco builder)
COCOCaptionBuilder = _make("coco_caption", CaptionBuilder)
# Retrieval (reference coco/flickr retrieval builders)
COCORetrievalBuilder = _make("coco_retrieval", RetrievalBuilder)
Flickr30kBuilder = _make("flickr30k", RetrievalBuilder)
