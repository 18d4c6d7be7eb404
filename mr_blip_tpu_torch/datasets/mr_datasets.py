"""Moment-retrieval, MR-questions (qvhQ) and MC-VideoQA datasets (the port's
copy of ``mr_blip_tpu/datasets/mr_datasets.py`` but for its TAL dataset).

Sample dict contracts match the reference datasets
(``lavis/datasets/datasets/moment_retrieval_dataset.py:8-126`` and
``mc_video_vqa_datasets.py:34-128``) with frames channels-last:
``video (T, H, W, C) float32``, ``timestamps`` per frame in seconds
(``round(idx / fps, 2)``), prompt strings, and stringified
``relevant_windows`` targets.
"""

from __future__ import annotations

import os
import random

import numpy as np

from mr_blip_tpu_torch.datasets.base_dataset import BaseDataset

ANS_MAPPING = {0: "A", 1: "B", 2: "C", 3: "D", 4: "E"}

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


class MomentRetrievalQuestionsDataset(BaseDataset):
    """MR with multiple-choice option hints folded into the query (qvhQ)."""

    def __getitem__(self, index):
        ann = self.annotation[index]

        clip = None
        if "start" in ann:
            clip = [float(ann["start"]), float(ann["end"])]

        video_path = _video_path(self.vis_root, ann["video"])
        frms, indices, fps = self.vis_processor(video_path, clip_proposal=clip)
        query = ann["query"]
        relevant_windows = str(ann["relevant_windows"])

        if "num_option" in ann:
            hints = "Options: ("
            for j in range(ann["num_option"]):
                hints += ann[f"a{j}"] + " "
            hints = hints[:-1] + ")"
            query_prompt = "Query: " + query + " " + hints + "\n"
        else:
            query_prompt = "Query: " + query + "\n"

        timestamps = np.asarray(
            [round(float(idx / fps), 2) for idx in indices], np.float64
        )

        return {
            "video": _as_model_frames(frms),
            "duration": float(ann["duration"]),
            "query_id": ann["qid"],
            "timestamps": timestamps,
            "video_prompt_end": "<extra_id_0>",
            "query_prompt": query_prompt,
            "task_prompt": TASK_PROMPT,
            "relevant_windows": relevant_windows,
        }


class MCVideoQADataset(BaseDataset):
    """NextQA / NExT-GQA multiple-choice QA with optional GT grounding.

    Undecodable videos are retried with a random re-draw, like the
    reference's defensive loop (mc_video_vqa_datasets.py:49-109).
    """

    def __getitem__(self, index):
        result = None
        attempts = 0
        while result is None:
            ann = self.annotation[index]
            qid = ann["qid"]
            q = ann["question"]

            clip = None
            if "start" in ann:
                clip = [float(ann["start"]), float(ann["end"])]

            prompt = "Question: " + q
            for j in range(ann["num_option"]):
                prompt += " Option {}: ".format(ANS_MAPPING[j]) + ann[f"a{j}"]
            hints = "Options: ("
            for j in range(ann["num_option"]):
                hints += ann[f"a{j}"] + " "
            hints = hints[:-1] + ")"
            qa_prompt = (
                prompt
                + " Considering the information presented in the frames, "
                "select the correct answer from the options."
            )
            loc_prompt = "Query: " + q + " " + hints + "\n"
            answers = "Option " + ANS_MAPPING[int(ann["answer"])]

            try:
                vpath = _video_path(self.vis_root, ann["video"])
                frms, indices, fps = self.vis_processor(vpath, clip_proposal=clip)
                assert len(frms) == self.vis_processor.n_frms
                duration = float(ann["duration"])
                timestamps = np.asarray(
                    [round(float(idx / fps), 2) for idx in indices], np.float64
                )
                result = True
            except Exception:
                attempts += 1
                if attempts > 10:
                    raise
                index = random.randint(0, len(self.annotation) - 1)
                continue

            relevant_windows = np.asarray(
                ann.get("relevant_windows", [[0.0, duration]]), np.float64
            )

        return {
            "video": _as_model_frames(frms),
            "duration": duration,
            "question_id": qid,
            "timestamps": timestamps,
            "video_prompt_end": "<extra_id_0>",
            "query_prompt": loc_prompt,
            "task_prompt": TASK_PROMPT,
            "qa_input": qa_prompt,
            "qa_output": answers,
            "relevant_windows": relevant_windows,
            "video_path": vpath,
        }
