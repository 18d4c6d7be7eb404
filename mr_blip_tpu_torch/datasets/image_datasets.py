"""Image caption, retrieval, QA, classification, pretraining-pair and
image-folder datasets and their builders (the port's copy of
``mr_blip_tpu/datasets/image_datasets.py``).

Compact counterparts of the reference LAVIS image dataset layer
(``lavis/datasets/datasets/{caption_datasets,retrieval_datasets,
vqa_datasets}.py``, the classification, image-text-pair and image-folder
builders): annotation schemas ``{image, caption, image_id}``, ``{image,
question, answers}``, ``{image[, image2], sentence, label}``, ``{image,
caption}`` and ``{image, label}``, the image decoded through the port's
``datasets/video_reader.py`` single-frame path (any FFmpeg-readable image
works through the same library; a ``synthetic://`` image needs no FFmpeg),
CLIP normalization as the video processors apply it. Every image is read at
``image_size`` (224) whatever the config's processors say, as in the JAX
package.
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


class ImageQADataset(BaseDataset):
    """{image, question, answers} records (vqa_datasets.py)."""

    image_size = 224

    def __getitem__(self, index):
        ann = self.annotation[index]
        image = load_image(os.path.join(self.vis_root, ann["image"]),
                           self.image_size)
        question = ann["question"]
        if self.text_processor is not None:
            question = self.text_processor(question)
        return {
            "image": image,
            "text_input": question,
            "question_id": ann.get("question_id", ann.get("instance_id")),
            "answers": ann.get("answers", [ann.get("answer", "")]),
        }


class CaptionBuilder(BaseDatasetBuilder):
    data_type = "images"
    train_dataset_cls = CaptionDataset
    eval_dataset_cls = CaptionDataset


class RetrievalBuilder(BaseDatasetBuilder):
    data_type = "images"
    train_dataset_cls = RetrievalDataset
    eval_dataset_cls = RetrievalDataset


class ImageQABuilder(BaseDatasetBuilder):
    data_type = "images"
    train_dataset_cls = ImageQADataset
    eval_dataset_cls = ImageQADataset


def _make(name, base):
    @registry.register_builder(name)
    class _B(base):
        DATASET_CONFIG_DICT = {"default": f"configs/datasets/{name}/defaults.yaml"}

    _B.__name__ = f"{name}_builder"
    return _B


class ClassificationDataset(BaseDataset):
    """{image[, image2], sentence, label} records — NLVR2 (two images) and
    SNLI-VE (one) (reference classification_builder.py + nlvr_datasets /
    snli_ve_datasets)."""

    image_size = 224

    def __getitem__(self, index):
        ann = self.annotation[index]
        sentence = ann.get("sentence", ann.get("text_input", ""))
        if self.text_processor is not None:
            sentence = self.text_processor(sentence)
        out = {
            "image": load_image(os.path.join(self.vis_root, ann["image"]),
                                self.image_size),
            "text_input": sentence,
            "label": int(ann["label"]),
            "instance_id": ann.get("instance_id", index),
        }
        if "image2" in ann:  # NLVR pairs
            out["image2"] = load_image(
                os.path.join(self.vis_root, ann["image2"]), self.image_size)
        return out


class ImageTextPairDataset(BaseDataset):
    """Bare {image, caption} pretraining pairs (reference
    image_text_pair_builder.py: CC3M/CC12M/SBU/VG/LAION)."""

    image_size = 224

    def __getitem__(self, index):
        ann = self.annotation[index]
        caption = ann["caption"]
        if self.text_processor is not None:
            caption = self.text_processor(caption)
        return {
            "image": load_image(os.path.join(self.vis_root, ann["image"]),
                                self.image_size),
            "text_input": caption,
        }


class ImageFolderDataset(BaseDataset):
    """Class-per-directory layout (reference imagefolder_builder.py /
    ImageNet): annotation rows {image, label} OR, when the annotation list
    is empty, the directory tree under ``vis_root`` is scanned (sorted
    class-name -> index, torchvision ImageFolder convention)."""

    image_size = 224
    IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".avi", ".mp4")

    def __init__(self, vis_processor=None, text_processor=None,
                 vis_root=None, ann_paths=()):
        super().__init__(vis_processor, text_processor, vis_root, ann_paths)
        if not self.annotation and vis_root and os.path.isdir(vis_root):
            classes = sorted(
                d for d in os.listdir(vis_root)
                if os.path.isdir(os.path.join(vis_root, d))
            )
            self.classnames = classes
            for label, cls in enumerate(classes):
                cdir = os.path.join(vis_root, cls)
                for fname in sorted(os.listdir(cdir)):
                    if fname.lower().endswith(self.IMAGE_EXTS):
                        self.annotation.append(
                            {"image": os.path.join(cls, fname),
                             "label": label}
                        )

    def __getitem__(self, index):
        ann = self.annotation[index]
        return {
            "image": load_image(os.path.join(self.vis_root, ann["image"]),
                                self.image_size),
            "label": int(ann["label"]),
            "instance_id": ann.get("instance_id", index),
        }


class ClassificationBuilder(BaseDatasetBuilder):
    data_type = "images"
    train_dataset_cls = ClassificationDataset
    eval_dataset_cls = ClassificationDataset


class ImageTextPairBuilder(BaseDatasetBuilder):
    data_type = "images"
    train_dataset_cls = ImageTextPairDataset
    eval_dataset_cls = ImageTextPairDataset


class ImageFolderBuilder(BaseDatasetBuilder):
    data_type = "images"
    train_dataset_cls = ImageFolderDataset
    eval_dataset_cls = ImageFolderDataset


# Caption (reference coco/nocaps builders)
COCOCaptionBuilder = _make("coco_caption", CaptionBuilder)
NoCapsBuilder = _make("nocaps", CaptionBuilder)
# Retrieval (reference coco/flickr retrieval builders)
COCORetrievalBuilder = _make("coco_retrieval", RetrievalBuilder)
Flickr30kBuilder = _make("flickr30k", RetrievalBuilder)
# Image QA (reference coco_vqa/okvqa/aokvqa/gqa builders)
COCOVQABuilder = _make("coco_vqa", ImageQABuilder)
OKVQABuilder = _make("ok_vqa", ImageQABuilder)
AOKVQABuilder = _make("aok_vqa", ImageQABuilder)
GQABuilder = _make("gqa", ImageQABuilder)
# Classification (reference classification_builder.py)
NLVRBuilder = _make("nlvr", ClassificationBuilder)
SNLIVEBuilder = _make("snli_ve", ClassificationBuilder)
# Image-text pretraining pairs (reference image_text_pair_builder.py)
CC3MBuilder = _make("conceptual_caption_3m", ImageTextPairBuilder)
CC12MBuilder = _make("conceptual_caption_12m", ImageTextPairBuilder)
SBUCaptionBuilder = _make("sbu_caption", ImageTextPairBuilder)
VGCaptionBuilder = _make("vg_caption", ImageTextPairBuilder)
LAIONBuilder = _make("laion2B_multi", ImageTextPairBuilder)
# Folder-of-classes (reference imagefolder_builder.py / ImageNet)
ImageNetBuilder = _make("imagenet", ImageFolderBuilder)
VGVQABuilder = _make("vg_vqa", ImageQABuilder)
