"""Synthetic dataset generation for smoke tests and benchmarks (the port's
copy of ``mr_blip_tpu/datasets/synthetic.py`` but for its TAL generator,
which waits for the TAL dataset).

Creates annotation JSONs in the unified MR schema
({qid, video, duration, query|question+options, relevant_windows}) whose
``video`` fields use the ``synthetic://`` scheme, so the whole
train/eval pipeline runs hermetically with deterministic generated frames;
``make_benchmark_clips`` encodes real clips (``datasets/video_reader.py::
write_test_video``, FFmpeg) for the annotations of the ``make_benchmark_*``
generators.
"""

from __future__ import annotations

import json
import os
import random
import tempfile


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


def make_qa_annotations(
    out_dir: str,
    n_train: int = 8,
    n_val: int = 4,
    n_test: int = 4,
    n_video_frames: int = 60,
    fps: float = 10.0,
    height: int = 96,
    width: int = 128,
    seed: int = 0,
    with_grounding: bool = True,
):
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    qtypes = ["TN", "TC", "CH", "CW", "TP"]

    def record(qid):
        duration = n_video_frames / fps
        rec = {
            "qid": f"{rng.choice(qtypes)}_{qid}",
            "video": f"synthetic://{n_video_frames}x{height}x{width}@{fps}#{qid}",
            "duration": duration,
            "question": f"what happens in clip {qid}?",
            "num_option": 5,
            "answer": rng.randint(0, 4),
        }
        for j in range(5):
            rec[f"a{j}"] = f"answer choice {j}"
        if with_grounding:
            s = round(rng.uniform(0, duration * 0.5), 1)
            rec["relevant_windows"] = [[s, round(s + 1.5, 1)]]
        return rec

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


def make_benchmark_clips(
    out_dir: str | None = None,
    n_clips: int = 4,
    seconds: int = 150,
    fps: float = 30.0,
    width: int = 640,
    height: int = 360,
    gop: int = 60,
    codec: str = "libx264",
):
    """Encode real benchmark clips at QVH-like geometry.

    Unlike the ``synthetic://`` scheme these exercise the full native
    decode path — demux, seek-to-keyframe, decode-forward, swscale — with
    realistic web-video keyframe spacing (``gop``). ``codec="libx264"``
    encodes H.264 with B-frames (what real QVH/Charades videos are).
    Cached across runs, by default under ``$TMPDIR/mrblip_bench_clips``.
    Returns the clip paths.
    """
    from mr_blip_tpu_torch.datasets.video_reader import write_test_video

    if out_dir is None:
        out_dir = os.path.join(tempfile.gettempdir(), "mrblip_bench_clips")
    os.makedirs(out_dir, exist_ok=True)
    ext = "mp4" if codec == "libx264" else "avi"
    paths = []
    for i in range(n_clips):
        p = os.path.join(
            out_dir,
            f"clip{i}_{seconds}s_{width}x{height}_g{gop}_{codec}.{ext}"
            if codec != "mpeg4" else
            f"clip{i}_{seconds}s_{width}x{height}_g{gop}.{ext}",
        )
        if not os.path.exists(p):
            write_test_video(p, w=width, h=height,
                             n_frames=int(seconds * fps), fps=fps, gop=gop,
                             codec=codec)
        paths.append(p)
    return paths


def make_benchmark_annotations(clip_paths, out_path, n_queries=16, seed=0):
    """MR eval annotations over real encoded benchmark clips."""
    rng = random.Random(seed)
    anns = []
    for qid in range(n_queries):
        clip = clip_paths[qid % len(clip_paths)]
        from mr_blip_tpu_torch.datasets.video_reader import VideoReader

        vr = VideoReader(clip)
        duration = len(vr) / vr.get_avg_fps()
        vr.close()
        s = round(rng.uniform(0, duration * 0.6), 1)
        e = round(min(duration, s + rng.uniform(2, duration * 0.3)), 1)
        anns.append({
            "qid": f"bench{qid}",
            "video": clip,
            "duration": duration,
            "query": f"benchmark query {qid} about an action",
            "relevant_windows": [[s, e]],
        })
    with open(out_path, "w") as f:
        json.dump(anns, f)
    return out_path


def make_benchmark_qa_annotations(clip_paths, out_path, n_queries=16, seed=0):
    """MC-VideoQA (NExT-GQA-style) annotations over real encoded clips."""
    rng = random.Random(seed)
    from mr_blip_tpu_torch.datasets.video_reader import VideoReader

    anns = []
    for qid in range(n_queries):
        clip = clip_paths[qid % len(clip_paths)]
        vr = VideoReader(clip)
        duration = len(vr) / vr.get_avg_fps()
        vr.close()
        s = round(rng.uniform(0, duration * 0.6), 1)
        rec = {
            "qid": f"TC_bench{qid}",
            "video": clip,
            "duration": duration,
            "question": f"what does the person do in scene {qid}?",
            "num_option": 5,
            "answer": rng.randint(0, 4),
            "relevant_windows": [[s, round(s + 4.0, 1)]],
        }
        for j in range(5):
            rec[f"a{j}"] = f"benchmark answer choice {j}"
        anns.append(rec)
    with open(out_path, "w") as f:
        json.dump(anns, f)
    return out_path
