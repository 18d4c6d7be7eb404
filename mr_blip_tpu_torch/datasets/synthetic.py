"""Synthetic dataset generation for smoke tests and benchmarks (the port's
copy of the moment-retrieval part of ``mr_blip_tpu/datasets/synthetic.py``;
its TAL and QA generators wait for those datasets, its encoded benchmark
clips for the FFmpeg reader).

Creates annotation JSONs in the unified MR schema
({qid, video, duration, query|question+options, relevant_windows}) whose
``video`` fields use the ``synthetic://`` scheme, so the whole
train/eval pipeline runs hermetically with deterministic generated frames.
"""

from __future__ import annotations

import json
import os
import random


def make_mr_annotations(
    out_dir: str,
    n_train: int = 8,
    n_val: int = 4,
    n_test: int = 4,
    n_video_frames: int = 60,
    fps: float = 10.0,
    height: int = 96,
    width: int = 128,
    seed: int = 0,
):
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)

    def record(qid):
        duration = n_video_frames / fps
        s = round(rng.uniform(0, duration * 0.6), 1)
        e = round(min(duration, s + rng.uniform(0.5, duration * 0.4)), 1)
        return {
            "qid": f"q{qid}",
            "video": f"synthetic://{n_video_frames}x{height}x{width}@{fps}#{qid}",
            "duration": duration,
            "query": f"action number {qid} happening",
            "relevant_windows": [[s, e]],
        }

    paths = {}
    offset = 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        anns = [record(offset + i) for i in range(n)]
        offset += n
        path = os.path.join(out_dir, f"{split}.json")
        with open(path, "w") as f:
            json.dump(anns, f)
        paths[split] = path
    return paths
