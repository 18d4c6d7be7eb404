"""Port the reference's PyTorch checkpoints into one file the port loads.

    python -m mr_blip_tpu_torch.port_weights \\
        --arch blip2_mr --model-type pretrain_flant5xl \\
        [--eva-vit eva_vit_g.pth] \\
        [--blip2 blip2_pretrained_flant5xl.pth] \\
        [--t5 /path/to/flan-t5-xl]          # an HF directory (every shard) or a state file
        [--lora checkpoint_best.pth] \\
        --output model.pth [--device cpu]

It builds the model with ``models.load_model`` (random weights from its
seed; the card unless ``--device cpu``), grafts in every tensor the sources
hold, non-strict and shape-checked as the reference loads them (a source
left out keeps the random weights), and writes ``torch.save`` of the
model's ``state_dict``: ``model.pretrained`` (or ``finetuned``) in a config,
or ``load_model(..., checkpoint=...)``, reads the file as it is. Needs no
JAX, ``transformers``, ``peft`` or ``safetensors``.

Unlike ``scripts/port_weights.py``, which reads the first weight file of an
HF directory only, every shard is read (the index's ``weight_map`` where one
exists), as ``from_pretrained`` does in the reference.
"""

from __future__ import annotations

import argparse
import logging

import torch

from mr_blip_tpu_torch.models import load_model, port


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Port the reference's PyTorch checkpoints into a torch.save "
                    "state dict of the port's model.")
    parser.add_argument("--arch", default="blip2_mr")
    parser.add_argument("--model-type", default="pretrain_flant5xl")
    parser.add_argument("--eva-vit", help="LAVIS eva_vit_g.pth")
    parser.add_argument("--blip2", help="BLIP-2 stage-2 checkpoint (.pth)")
    parser.add_argument("--t5", help="HF T5 model directory or state file")
    parser.add_argument("--lora", help="PEFT LoRA adapters or the finetuned checkpoint")
    parser.add_argument("--tokenizer-path", help="local tokenizer directory")
    parser.add_argument("--vocab-size", type=int,
                        help="the model's vocabulary (default: the rows of the --t5 "
                             "checkpoint's shared.weight when no tokenizer is given)")
    parser.add_argument("--device", default="cuda",
                        help="where the model is built (default: the card)")
    parser.add_argument("--output", required=True)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    t5_sd = port.load_hf_state_dict(args.t5) if args.t5 else None
    build_kw = {}
    if args.vocab_size:
        build_kw["vocab_size"] = args.vocab_size
    elif t5_sd is not None and not args.tokenizer_path and "shared.weight" in t5_sd:
        # Without a tokenizer asset the model would take the fallback
        # tokenizer's vocabulary and skip a 32,128-row embedding.
        build_kw["vocab_size"] = int(t5_sd["shared.weight"].shape[0])
        logging.info("inferred vocab_size=%d from %s", build_kw["vocab_size"], args.t5)
    model = load_model(args.arch, args.model_type, tokenizer_path=args.tokenizer_path,
                       device=args.device, **build_kw)
    params = port.port_checkpoints(
        model.state_dict(),
        eva_vit=port.load_torch_state_dict(args.eva_vit) if args.eva_vit else None,
        blip2=port.load_torch_state_dict(args.blip2) if args.blip2 else None,
        t5=t5_sd,
        finetuned=port.load_torch_state_dict(args.lora) if args.lora else None)
    del t5_sd
    model.load_state_dict(params)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, args.output)
    logging.info("wrote %s", args.output)
    return args.output


if __name__ == "__main__":
    main()
