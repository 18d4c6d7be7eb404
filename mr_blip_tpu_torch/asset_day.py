"""Asset day: one command from the reference's released checkpoints to a
PASS/FAIL parity verdict, the port's counterpart of ``scripts/asset_day.sh``
(``docs/asset_day_runbook.md``). Needs no JAX, ``transformers`` or
``sentencepiece``.

    python -m mr_blip_tpu_torch.asset_day --eva-vit eva_vit_g.pth \\
        --blip2 blip2_pretrained_flant5xl.pth \\
        --t5 <HF flan-t5-xl directory, with its tokenizer> \\
        --lora <mr-BLIP finetuned checkpoint> \\
        [--out <dir>] [--int8] [--tolerance 1.0]

The chain, each step a gate: (1) ``port_weights`` (no tensor may be
skipped), (2) the vocabulary facts of the T5 directory's tokenizer
(``text/vocab_facts.py::check_vocab``), (3) ``evaluate`` on
``configs/projects/eval/charades.yaml`` in bf16, (4) its metrics against
``BASELINE.md`` (``asset_gates.py baseline``), (5) with ``--int8``,
``charades_int8.yaml`` and the drift gate (``asset_gates.py int8``). The
last line is ``ASSET-DAY: PASS`` or ``ASSET-DAY: FAIL <reason>``; the exit
code is 0, 1 at a failed gate, 2 on missing arguments.

Beyond the shell script's flags: ``--model-type`` and ``--device`` go to
``port_weights`` (``tiny`` and ``cpu`` rehearse the chain on small files),
``--options`` are appended to each evaluation's overrides (the dataset's
annotation and video storages, say). ``evaluate`` writes no ``log.txt`` of
its own in evaluate-only mode, so the chain writes its returned test logs
there, one JSON line a split as ``RunnerBase.log_stats`` writes them, for
the gates to read.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import shutil
import sys
import tempfile

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "projects", "eval")
CHARADES = os.path.join(_CONFIGS, "charades.yaml")
CHARADES_INT8 = os.path.join(_CONFIGS, "charades_int8.yaml")


class GateFailed(Exception):
    """A step's gate failed; the message is the verdict's reason."""


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Asset-day parity chain (port).")
    parser.add_argument("--eva-vit")
    parser.add_argument("--blip2")
    parser.add_argument("--t5", help="HF Flan-T5 directory, tokenizer included")
    parser.add_argument("--lora", help="the mr-BLIP finetuned checkpoint")
    parser.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "asset_day"))
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--tolerance", type=float, default=1.0)
    parser.add_argument("--model-type", default="pretrain_flant5xl")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--options", nargs="+", default=[],
                        help="extra evaluation overrides, key=value")
    return parser.parse_args(argv)


def _port(args, params):
    from mr_blip_tpu_torch import port_weights

    log_path = os.path.join(args.out, "port.log")
    handler = logging.FileHandler(log_path, mode="w")
    handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
    root = logging.getLogger()
    root.addHandler(handler)
    level = root.level
    root.setLevel(min(level, logging.INFO))
    try:
        port_weights.main([
            "--arch", "blip2_mr", "--model-type", args.model_type,
            "--eva-vit", args.eva_vit, "--blip2", args.blip2, "--t5", args.t5,
            "--lora", args.lora, "--tokenizer-path", args.t5, "--output", params,
            "--device", args.device])
    except Exception as err:  # the gate's verdict; the traceback goes to the log
        logging.exception("port_weights failed")
        raise GateFailed(f"port_weights failed: {type(err).__name__}: {err}") from err
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()
    with open(log_path) as f:
        if "tensors skipped" in f.read():
            raise GateFailed(f"port skipped tensors (any skip is a bug; see {log_path})")
    if not os.path.exists(params) or os.path.getsize(params) == 0:
        raise GateFailed("no params written")


def _vocab(args):
    from mr_blip_tpu_torch.text.tokenizer import HFT5Tokenizer
    from mr_blip_tpu_torch.text.vocab_facts import check_vocab

    try:
        facts = check_vocab(HFT5Tokenizer(args.t5))
    except ValueError as err:
        raise GateFailed(f"real-vocab assertions failed: {err}") from err
    with open(os.path.join(args.out, "vocab.log"), "w") as f:
        json.dump(facts, f, indent=1, default=str)
    for line in facts["failures"]:
        print(f"  {line}")
    if facts["failures"]:
        raise GateFailed("real-vocab assertions failed")
    print(f"  answer ids {facts['answer_ids']}, annoying {facts['annoying']}, "
          f"space-flavoured {facts['annoying_space']}")


def _evaluate(args, params, cfg_path, tag):
    from mr_blip_tpu_torch import evaluate

    out_dir = os.path.join(args.out, tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        logs = evaluate.main([
            "--cfg-path", cfg_path, "--options", f"model.finetuned={params}",
            "model.load_finetuned=True", "model.params_dtype=bfloat16",
            f"model.tokenizer_path={args.t5}", f"run.output_dir={out_dir}", *args.options])
    except Exception as err:  # the gate's verdict; the traceback is logged
        logging.exception("evaluate failed")
        raise GateFailed(f"evaluate ({tag}) failed: {type(err).__name__}: {err}") from err
    jobs = sorted(glob.glob(os.path.join(out_dir, "*", "")))
    if not logs or not jobs:
        raise GateFailed(f"no metrics written ({tag})")
    with open(os.path.join(jobs[-1], "log.txt"), "a") as f:
        for split, stats in logs.items():
            if isinstance(stats, dict):
                f.write(json.dumps({f"{split}_{k}": v for k, v in stats.items()},
                                   default=float) + "\n")
    return out_dir


def run(args) -> None:
    from mr_blip_tpu_torch import asset_gates

    os.makedirs(args.out, exist_ok=True)
    params = os.path.join(args.out, "params.pth")
    print(f"== [1/5] port checkpoints -> {params}", flush=True)
    _port(args, params)
    print("== [2/5] real-vocab tokenizer facts (text/vocab_facts.py)", flush=True)
    _vocab(args)
    print("== [3/5] Charades-STA eval, bf16 (20 frames, beam 5)", flush=True)
    bf16_dir = _evaluate(args, params, CHARADES, "eval_charades")
    print(f"== [4/5] metric gate vs BASELINE.md (tolerance {args.tolerance} points)",
          flush=True)
    if not asset_gates.gate_baseline(bf16_dir, args.tolerance):
        raise GateFailed("metric gate (see above)")
    if args.int8:
        print("== [5/5] int8 quality gate (each metric within 0.5 of bf16)", flush=True)
        int8_dir = _evaluate(args, params, CHARADES_INT8, "eval_charades_int8")
        if not asset_gates.gate_int8(bf16_dir, int8_dir):
            raise GateFailed("int8 drift gate")
    else:
        print("== [5/5] int8 gate skipped (pass --int8 to run; required before calling "
              "int8 the production serving path)")


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (args.eva_vit and args.blip2 and args.t5 and args.lora):
        print("ASSET-DAY: FAIL missing one of --eva-vit --blip2 --t5 --lora (see header)")
        return 2
    try:
        run(args)
    except GateFailed as err:
        print(f"ASSET-DAY: FAIL {err}")
        return 1
    print("ASSET-DAY: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
