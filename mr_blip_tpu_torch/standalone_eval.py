"""Offline QVHighlights scorer, the port's counterpart of
``standalone_eval/eval.py`` (the reference's CLI), with the same flags and
the same JSON:

    python -m mr_blip_tpu_torch.standalone_eval --submission_path preds.jsonl \\
        --gt_path gt.jsonl --save_path metrics.json [--not_verbose]

Scores moment retrieval (R1@IoU, mAP by GT-window length range) and, when
``pred_saliency_scores`` are present, highlight detection (HL-Hit1,
HL-mAP), through ``metrics/moment_retrieval.py::eval_submission`` in
``"qvh"`` mode. Needs no JAX and no scikit-learn.
"""

from __future__ import annotations

import argparse
import json

from mr_blip_tpu_torch.metrics.moment_retrieval import eval_submission, load_jsonl


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Moments and Highlights Evaluation Script")
    parser.add_argument("--submission_path", type=str, help="path to generated prediction file")
    parser.add_argument("--gt_path", type=str, help="path to GT file")
    parser.add_argument("--save_path", type=str, help="path to save the results")
    parser.add_argument("--not_verbose", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    verbose = not args.not_verbose
    results = eval_submission(load_jsonl(args.submission_path), load_jsonl(args.gt_path),
                              verbose=verbose, mode="qvh")
    if verbose:
        print(json.dumps(results, indent=4))
    with open(args.save_path, "w") as f:
        f.write(json.dumps(results, indent=4))
    return results


if __name__ == "__main__":
    main()
