"""Device profile of one generate batch of the port, stage by stage.

    python3 -m mr_blip_tpu_torch.profile_inference [--int8] [--frames N]
        [--relpos-in-kernel] [--img-size 364] [--qa]
        [--out output/profile_inference]

Needs one CUDA card. Builds the flagship ``BLIP2_MR`` (EVA ViT-g/14 +
Q-Former base + Flan-T5-XL at published widths and depths, random weights,
bf16, beam 5; with ``--int8`` after ``quantize_for_inference()``), runs one
warm-up batch of 4 videos x 60 uint8 frames (``--frames N`` for another
frame count; ``--relpos-in-kernel`` for the long-context mode, e.g. with
``--frames 240``; ``--img-size 364`` for the resolution of BLIP-2's finetuned
checkpoints, where the ViT's attention runs the bias-free flash kernel), then
runs each stage of one batch (frames -> Q-Former, T5 encode, decode) once
unprofiled and once under ``torch.profiler``. With ``--qa`` the model is the
two-stage grounded-QA one (``qformer_freeze_lora_QA_with_localizer``, the
answerer over as many frames as the localizer) and the stages are the
localizer (generate and frame crop) and the answerer. Per stage it prints one
JSON line:

* ``wall_s``: host clock of the unprofiled run, synchronized at both ends;
* ``device_s``: union of the kernel, memcpy and memset intervals in the
  profiled run's trace (overlapping intervals count once);
* ``span_s``: first to last event of the profiled run's trace;
* ``busy``: ``device_s / span_s``, the device's busy share under the
  profiler (at most 1; the profiler slows the host, so a host-bound stage
  reads lower here than unprofiled);
* ``kernels``, ``top``: the number of device intervals, and the kernels with
  the most device time (name, calls, ms).

The Chrome traces are written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR

# The generate configuration the smoke run and this profile drive.
# min_new_tokens=12 keeps beam search near a real span string's length with
# random weights, which would otherwise stop after ~2 steps.
FLAGSHIP = dict(img_size=224, vit_model="eva_vit_g", t5_model="flan-t5-xl",
                task="lora", num_beams=5, max_new_tokens=50, min_new_tokens=12,
                compute_dtype="bfloat16", vocab_size=32128, seed=0)
BATCH, N_FRAMES = 4, 60
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TOP_KERNELS = 8


QA_TASK = "qformer_freeze_lora_QA_with_localizer"


def make_samples(batch: int, n_frames: int, seed: int, img_size: int = 224) -> dict:
    """A generate batch: random uint8 frames at ``img_size``², evenly spaced
    timestamps over 150 s, and the same query and task prompt per video."""
    rng = np.random.default_rng(seed)
    duration = 150.0
    return {
        "video": rng.integers(0, 256, (batch, n_frames, img_size, img_size, 3),
                              dtype=np.uint8),
        "timestamps": np.stack(
            [np.linspace(0.0, duration, n_frames, endpoint=False)] * batch),
        "duration": np.full((batch,), duration),
        "query_id": [f"q{i}" for i in range(batch)],
        "video_prompt_end": ["<extra_id_0>"] * batch,
        "query_prompt": ["Query: a person is doing something interesting\n"] * batch,
        "task_prompt": [
            "Given the video and the query, find the relevant windows.\n"
            "Relevant windows: "] * batch,
        "relevant_windows": ["[[10, 25]]"] * batch,
    }


def make_qa_samples(batch: int, n_frames: int, seed: int, img_size: int = 224) -> dict:
    """A grounded-QA batch: ``make_samples`` plus a five-option question per
    video in the layout of the NExT-GQA prompts."""
    samples = make_samples(batch, n_frames, seed, img_size)
    del samples["query_id"]
    options = " ".join(f"Option {letter}: {text}." for letter, text in zip(
        "ABCDE", ("cooking", "reading a book", "playing the guitar",
                  "walking a dog", "painting a wall")))
    samples["question_id"] = [f"q{i}" for i in range(batch)]
    samples["qa_input"] = [
        f"Question: what is the person doing? {options} Considering the "
        "information presented in the frame, select the correct answer from "
        "the options."] * batch
    samples["qa_output"] = [f"Option {'ABCDE'[i % 5]}" for i in range(batch)]
    return samples


def trace_summary(path: Path) -> dict:
    """Device seconds (interval union), span and top kernels of a trace."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") in _DEVICE_CATS)
    if not device:
        raise RuntimeError(f"{path}: the trace holds no device interval")
    busy_us, cur_start, cur_end = 0.0, device[0][0], device[0][1]
    for start, end in device[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    span_us = (max(float(e["ts"]) + float(e["dur"]) for e in events)
               - min(float(e["ts"]) for e in events))
    per_kernel = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") == "kernel":
            per_kernel[e["name"]][0] += 1
            per_kernel[e["name"]][1] += float(e["dur"])
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:_TOP_KERNELS]
    return {
        "device_s": busy_us / 1e6,
        "span_s": span_us / 1e6,
        "busy": busy_us / span_us,
        "kernels": len(device),
        "top": [[name[:80], calls, us / 1e3] for name, (calls, us) in ranked],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="output/profile_inference",
                    help="directory for the Chrome traces")
    ap.add_argument("--int8", action="store_true",
                    help="profile the int8 inference mode "
                         "(quantize_for_inference) instead of bf16")
    ap.add_argument("--frames", type=int, default=N_FRAMES,
                    help="frames per video (default %(default)s)")
    ap.add_argument("--relpos-in-kernel", action="store_true",
                    help="the long-context mode: the T5 encoder's rel-pos bias "
                         "computed inside its flash kernels")
    ap.add_argument("--img-size", type=int, default=FLAGSHIP["img_size"],
                    help="frame side in pixels (default %(default)s; 364 sends the "
                         "ViT's attention to the bias-free flash kernel)")
    ap.add_argument("--qa", action="store_true",
                    help="profile the two-stage grounded-QA path (localizer, "
                         "answerer) instead of the generate stages")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_inference: no CUDA device")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    config = dict(FLAGSHIP, img_size=args.img_size)
    if args.qa:
        config.update(task=QA_TASK, num_frames_for_answer=args.frames)
    model = BLIP2_MR(**config, device="cuda",
                     relpos_in_kernel=args.relpos_in_kernel)
    if args.int8:
        model.quantize_for_inference()
    make = make_qa_samples if args.qa else make_samples
    warm_up = make(BATCH, args.frames, 0, args.img_size)
    (model.videoQA_generate if args.qa else model.generate)(warm_up)
    tag = "".join((f"_{args.frames}f" if args.frames != N_FRAMES else "",
                   f"_{args.img_size}px" if args.img_size != FLAGSHIP["img_size"] else "",
                   "_relpos" if args.relpos_in_kernel else "",
                   "_int8" if args.int8 else ""))

    def profile_stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        trace = out / f"{name}{tag}.json"
        prof.export_chrome_trace(str(trace))
        print(json.dumps({"stage": name, "int8": args.int8, "frames": args.frames,
                          "img_size": args.img_size,
                          "relpos_in_kernel": args.relpos_in_kernel,
                          "wall_s": wall, **trace_summary(trace)}), flush=True)
        return result

    samples = make(BATCH, args.frames, 1, args.img_size)
    if args.qa:
        handle = profile_stage("qa_localizer", lambda: model.videoQA_redecode(
            model.videoQA_dispatch(samples)))
        profile_stage("qa_answerer", lambda: model.videoQA_collect(dict(handle)))
        return
    with torch.inference_mode():
        batch = model.prepare_mr_batch(samples)
        tensors = model._to_device(batch)
        enc_bias = model._encoder_bias_for(batch)
        frames = profile_stage("frames_to_qformer",
                               lambda: model.frames_to_t5(tensors))
        enc, attn = profile_stage(
            "t5_encode", lambda: model.encode_t5(tensors, frames, enc_bias))
        profile_stage("decode", lambda: model.decode(enc, attn))


if __name__ == "__main__":
    main()
