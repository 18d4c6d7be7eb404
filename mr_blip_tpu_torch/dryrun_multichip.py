"""Pipeline-parallel dry run (the port's counterpart of the pp case of
``__graft_entry__.py::dryrun_multichip``).

    python -m torch.distributed.run --standalone --nproc_per_node=S \\
        -m mr_blip_tpu_torch.dryrun_multichip [--options run.device=cpu]

Every rank is one stage of a tiny T5 (LoRA rank 2 on every Linear, S
encoder and S decoder blocks: one of each a stage) in fp32 on 2·S rows.
One AdamW step (lr 1e-3, optax's defaults: weight decay 1e-4 on every
tensor) through ``t5_pipeline_forward`` with M = S microbatches is held
against the same step in one process (each rank runs the whole model alone
first): the loss within 1e-4 + 1e-4·|loss| and the fp64 sum of |every
tensor| after the update within 1e-5 relative, the JAX dry run's bars. Rank
0 prints the line and every rank exits 1 on a miss. ``run.device`` is the
card by default (``cuda:LOCAL_RANK``; two ranks on one card need
``run.dist_backend=gloo``); ``run.device=cpu`` runs on the host over gloo.
The dp, dp x tp and sp cases have their own checks under ``torchrun``
(``tests/test_torch_dp.py``, ``tests/test_torch_tp.py``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

LR = 1e-3
WEIGHT_DECAY = 1e-4  # optax.adamw's default
LOSS_TOL = 1e-4
CHECKSUM_TOL = 1e-5
SEQ, TARGET = 6, 5


def parse_options(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--options", nargs="+", default=[],
                        help="run.device=..., run.dist_backend=..., run.dist_timeout_s=...")
    run = {"device": "cuda", "dist_timeout_s": 300}
    for item in parser.parse_args(argv).options:
        key, _, value = item.partition("=")
        if not key.startswith("run."):
            raise ValueError(f"--options {item!r}: only run.* keys")
        run[key[4:]] = value
    return run


def random_state(model, seed: int = 0):
    """Every tensor of ``model`` redrawn from a numpy seed: norm weights
    1 + 0.1 noise, the rest 0.1 noise (the LoRA deltas and rel-pos tables
    nonzero, so that each one has a gradient)."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in model.state_dict().items():
        noise = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        state[name] = torch.from_numpy(1.0 + 0.1 * noise if name.endswith("norm.weight")
                                       else 0.1 * noise)
    return state


def checksum(tensors) -> float:
    """fp64 sum of |every element|."""
    return float(sum(t.detach().double().abs().sum().item() for t in tensors))


def main(argv=None) -> int:
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.models.t5 import (
        T5ForConditionalGeneration,
        cross_entropy_lm_loss,
        shift_right,
        t5_tiny_config,
    )
    from mr_blip_tpu_torch.models.t5_pipeline import (
        build_stage_model,
        stage_state_dict,
        t5_pipeline_forward,
    )

    run = parse_options(sys.argv[1:] if argv is None else argv)
    if not dist_utils.init_distributed_mode(dict(run, distributed=True)):
        raise SystemExit("dryrun_multichip: run it under python -m torch.distributed.run "
                         "with --nproc_per_node >= 2 (one process a stage)")
    dev = dist_utils.local_device(run["device"])
    rank, pp = dist_utils.get_rank(), dist_utils.get_world_size()
    cfg = t5_tiny_config(lora_rank=2, num_layers=pp, num_decoder_layers=pp)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2 * pp, SEQ, cfg.d_model)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2 * pp, TARGET)))
    x, labels = x.to(dev), labels.to(dev)
    dec_ids = shift_right(labels, cfg.decoder_start_token_id, cfg.pad_token_id)
    ones = torch.ones_like(labels)

    def step(model, loss_fn):
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY)
        loss = loss_fn(model)
        loss.backward()
        opt.step()
        return float(loss.detach())

    # Deterministic, as the pipelined path (eval mode: no LoRA dropout).
    whole = T5ForConditionalGeneration(cfg, device=dev, dtype=torch.float32).eval()
    state = random_state(whole)
    whole.load_state_dict(state)
    ref_loss = step(whole, lambda m: cross_entropy_lm_loss(
        m.decode(dec_ids, m.encode(x), decoder_mask=None, encoder_mask=None), labels, ones))
    ref_ck = checksum(whole.state_dict().values())
    del whole

    stage = build_stage_model(cfg, pp, device=dev, dtype=torch.float32)
    stage.load_state_dict(stage_state_dict(state, cfg, pp, rank))
    loss = step(stage, lambda m: cross_entropy_lm_loss(t5_pipeline_forward(
        cfg, m, x, dec_ids, num_microbatches=pp, compute_dtype=torch.float32), labels, ones))
    # Each rank's blocks once, the replicated tensors (the same on every
    # rank: checked) once.
    blocks = {k: v for k, v in stage.state_dict().items() if ".block." in k}
    shared = {k: v for k, v in stage.state_dict().items() if ".block." not in k}
    part = torch.tensor([checksum(blocks.values())], dtype=torch.float64, device=dev)
    torch.distributed.all_reduce(part)
    shared_ck = torch.tensor([checksum(shared.values())], dtype=torch.float64, device=dev)
    spread = torch.stack([shared_ck, -shared_ck])
    torch.distributed.all_reduce(spread, op=torch.distributed.ReduceOp.MAX)
    ck = float(part) + float(shared_ck)
    ok = (np.isfinite(loss)
          and abs(loss - ref_loss) < LOSS_TOL + LOSS_TOL * abs(ref_loss)
          and abs(ck - ref_ck) < CHECKSUM_TOL + CHECKSUM_TOL * abs(ref_ck)
          and float(spread[0]) == -float(spread[1]))
    if rank == 0:
        if ok:
            print(f"dryrun_multichip pp={pp} (GPipe over the full T5 stack, one process a "
                  f"stage, {dist_utils.run_device(run['device'])}): OK, loss={loss:.4f} "
                  f"(loss + updated params match one process)", flush=True)
        else:
            print(f"dryrun_multichip pp={pp}: MISMATCH, loss {loss} vs one process "
                  f"{ref_loss}, post-step params checksum {ck} vs {ref_ck}, replicated "
                  f"tensors equal over the ranks {float(spread[0]) == -float(spread[1])}",
                  flush=True)
    dist_utils.destroy()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
