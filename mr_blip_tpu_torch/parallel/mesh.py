"""Data (dp) and sequence (sp) parallelism over ``torch.distributed`` (the
port's counterpart of ``mr_blip_tpu/parallel/mesh.py``).

The JAX package builds one ``(dp, tp)`` mesh in one process and lets GSPMD
insert the collectives: parameters replicated over ``dp`` (sharded over
``tp`` by ``sharding_rules.py``), the batch's leading axis sharded over
``dp``. The port runs one process per rank (``torchrun``) and places the
collectives itself. ``make_mesh(tp=t)``'s grid is
``common/dist.py::init_model_parallel(t)``: the world as ``dp x t`` ranks,
tensor-parallel groups of ``t`` consecutive ranks (``parallel/tensor.py``
shards the language model over them) and data-parallel groups of the ranks
``t`` apart. Every helper below works over the data-parallel group (the
world without tensor parallelism); the ranks of one tensor-parallel group
read the same rows. The helpers:

* :func:`rank_rows` — the rank's share of a loader's rows: ``shard_batch``'s
  placement of a global batch's rows over ``dp`` (the loader passes the dp
  rank and size). In training the tail that
  does not fill a global batch is dropped, so every rank takes as many
  micro-batches and the union of the ranks' i-th batches is the JAX
  package's i-th global batch.
* :func:`global_sum` — a micro-batch's target-token count over the dp ranks:
  the JAX loss is the mean over every target token of the global batch
  (``mr_blip_tpu/models/t5.py::cross_entropy_lm_loss`` on the sharded
  batch), so each rank divides its token-loss sum by this count.
* :func:`all_reduce_grads` — the gradient psum GSPMD inserts into the
  sharded train step: once per update, bucketed, over the dp group.
* :func:`gather_frames` — sp's all-gather of the flat ``B·T`` frame axis
  after the Q-Former (``encode_frames``' ``P("dp")`` constraint), with a
  backward that sums the replicated T5's gradient over the ranks.
* :func:`assert_replicated` — all-gathered fingerprints of tensors that
  every rank of the world must hold bit-equal (the replicated parameters).

Not carried over: ``replicate`` (every rank builds the same weights from the
constructor's seed or the same checkpoint; :func:`assert_replicated` checks
it), and ``pad_batch_to_multiple`` (the port never pads a batch: a rank's share
of an evaluation split may be one row shorter than another's).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence

import torch
import torch.distributed as tdist

from mr_blip_tpu_torch.common import dist as dist_utils

# Gradients are all-reduced in flat fp32 buckets of at most this many bytes.
BUCKET_BYTES = 32 << 20


def rank_rows(order: Sequence[int], rank: int, world: int,
              batch_size: int | None = None) -> List[int]:
    """Rank ``rank``'s rows of ``order``: ``order[rank::world]``. With
    ``batch_size`` (training, ``drop_last``) only the first
    ``len(order) // (world * batch_size)`` global batches of
    ``world * batch_size`` rows are shared out."""
    if batch_size:
        whole = world * batch_size
        order = order[:len(order) // whole * whole]
    return [int(i) for i in order[rank::world]]


def frame_share(n: int, rank: int, world: int) -> tuple[int, int]:
    """(start, stop) of rank ``rank``'s contiguous share of ``n`` frames:
    shares differ by at most one frame (T = 5 on two ranks: 0-2, 2-5)."""
    if n < world:
        raise ValueError(f"sequence_parallel: {n} frames cannot be shared over "
                         f"{world} ranks")
    return rank * n // world, (rank + 1) * n // world


def global_sum(value: torch.Tensor) -> torch.Tensor:
    """A copy of ``value`` summed over the dp ranks (``value`` itself in one
    process)."""
    if not dist_utils.is_dist_avail_and_initialized():
        return value
    return dist_utils.all_reduce(value.detach().clone(), group=dist_utils.dp_group())


def all_reduce_grads(params: Iterable[torch.Tensor],
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum every parameter's ``.grad`` over the dp ranks, in place: flat fp32
    buckets of at most ``bucket_bytes``, one ``all_reduce`` each. The
    parameters without a gradient are left out, as the optimizer leaves
    them; every rank's backward reaches the same ones."""
    bucket, size = [], 0
    for p in params:
        if p.grad is None:
            continue
        nbytes = p.grad.numel() * 4
        if bucket and size + nbytes > bucket_bytes:
            _reduce_bucket(bucket)
            bucket, size = [], 0
        bucket.append(p.grad)
        size += nbytes
    if bucket:
        _reduce_bucket(bucket)


def _reduce_bucket(grads: List[torch.Tensor], group=None) -> None:
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist_utils.all_reduce(flat, group=group or dist_utils.dp_group())
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


class _GatherFrames(torch.autograd.Function):
    """Forward: every dp rank's share of the flat frame axis, concatenated in
    rank order. Backward: the gradient summed over the dp ranks, then this
    rank's share: under sp each rank's loss is 1/world of the replicated
    loss, so the sum is the whole loss's gradient of these frames."""

    @staticmethod
    def forward(ctx, share, n):
        world, rank = dist_utils.dp_size(), dist_utils.dp_rank()
        bounds = [frame_share(n, r, world) for r in range(world)]
        longest = max(stop - start for start, stop in bounds)
        padded = share.new_zeros((longest,) + share.shape[1:])
        padded[:share.shape[0]] = share
        parts = [torch.empty_like(padded) for _ in range(world)]
        tdist.all_gather(parts, padded, group=dist_utils.dp_group())
        ctx.share = bounds[rank]
        return torch.cat([part[:stop - start]
                          for part, (start, stop) in zip(parts, bounds)])

    @staticmethod
    def backward(ctx, grad):
        total = dist_utils.all_reduce(grad.to(torch.float32, copy=True),
                                      group=dist_utils.dp_group())
        start, stop = ctx.share
        return total[start:stop].to(grad.dtype), None


def gather_frames(share: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) from every dp rank's (share of n, ...) rows
    (:func:`frame_share`), differentiable."""
    return _GatherFrames.apply(share.contiguous(), n)


def fingerprint(tensors: Dict[str, torch.Tensor]) -> str:
    """sha256 of the names and bytes of ``tensors`` (bit-equality)."""
    digest = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        digest.update(name.encode())
        digest.update(str(t.dtype).encode())
        digest.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def assert_replicated(tensors: Dict[str, torch.Tensor], what: str) -> str:
    """Raise unless every rank holds ``tensors`` bit-equal (all-gathered
    fingerprints); returns this rank's fingerprint."""
    mine = fingerprint(tensors)
    prints = dist_utils.all_gather_object(mine)
    if len(set(prints)) != 1:
        raise RuntimeError(f"{what}: the ranks disagree (fingerprints "
                           f"{[p[:12] for p in prints]})")
    return mine
