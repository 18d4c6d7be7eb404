"""The moment-retrieval dataset (the port's copy of the MR part of
``mr_blip_tpu/datasets/mr_datasets.py``; its TAL, MR-questions and
MC-VideoQA datasets are not ported yet).

The sample dict matches the reference dataset
(``lavis/datasets/datasets/moment_retrieval_dataset.py:8-126``) with frames
channels-last:
``video (T, H, W, C) float32``, ``timestamps`` per frame in seconds
(``round(idx / fps, 2)``), prompt strings, and stringified
``relevant_windows`` targets.
"""

from __future__ import annotations

import os

import numpy as np

from mr_blip_tpu_torch.datasets.base_dataset import BaseDataset

TASK_PROMPT = (
    "Given the video and the query, find the relevant windows.\nRelevant windows: "
)


def _as_model_frames(frms):
    """Preserve uint8 passthrough (normalize-on-device fast path): a uint8
    cast to float32 here would skip the model's dtype-keyed on-device CLIP
    normalization and feed raw 0-255 floats. Pre-normalized processor
    output stays float32."""
    frms = np.asarray(frms)
    return frms if frms.dtype == np.uint8 else frms.astype(np.float32)


def _video_path(vis_root, vname):
    vname = str(vname)
    if vname.startswith("synthetic://"):
        return vname
    if os.path.splitext(vname)[1]:
        return os.path.join(vis_root, vname)
    return os.path.join(vis_root, vname + ".mp4")


class MomentRetrievalDataset(BaseDataset):
    def __getitem__(self, index):
        ann = self.annotation[index]

        clip = None
        if "start" in ann:
            clip = [float(ann["start"]), float(ann["end"])]

        video_path = _video_path(self.vis_root, ann["video"])
        frms, indices, fps = self.vis_processor(video_path, clip_proposal=clip)
        query = ann["query"]
        relevant_windows = str(ann["relevant_windows"])

        timestamps = np.asarray(
            [round(float(idx / fps), 2) for idx in indices], np.float64
        )

        return {
            "video": _as_model_frames(frms),
            "duration": float(ann["duration"]),
            "query_id": ann["qid"],
            "timestamps": timestamps,
            "video_prompt_end": "<extra_id_0>",
            "query_prompt": "Query: " + query + "\n",
            "task_prompt": TASK_PROMPT,
            "relevant_windows": relevant_windows,
        }
