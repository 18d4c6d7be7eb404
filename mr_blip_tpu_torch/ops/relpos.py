"""T5 relative-position bucketing (counterpart of ``mr_blip_tpu/ops/relpos.py``).

Bit-exact with the JAX version: the same float32 operations in the same
order, with the ``log`` denominator as a host-side double.
"""

from __future__ import annotations

import math

import torch


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5 bucket function; ``relative_position`` = key_pos - query_pos."""
    ret = torch.zeros_like(relative_position, dtype=torch.int32)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


def clamped_bucket_table(num_buckets: int, max_distance: int) -> torch.Tensor:
    """The bidirectional bucket of every relative position clamped to
    [-max_distance, max_distance]: (2 * max_distance + 1,) int32, entry
    ``c`` for ``rel = c - max_distance``. The bucket function is constant
    beyond ``max_distance`` on either side, so
    ``table[clamp(rel, -max_distance, max_distance) + max_distance]`` is the
    bucket of any ``rel``; the rel-pos flash kernels look their bias up
    through it and never evaluate the logarithm themselves."""
    rel = torch.arange(-max_distance, max_distance + 1)
    return relative_position_bucket(rel, True, num_buckets, max_distance)


def materialize_relpos_bias(table: torch.Tensor, q_positions: torch.Tensor,
                            k_positions: torch.Tensor, bidirectional: bool,
                            num_buckets: int, max_distance: int) -> torch.Tensor:
    """(1, H, Nq, Nk) additive bias from a (num_buckets, H) table."""
    rel = k_positions[None, :] - q_positions[:, None]
    buckets = relative_position_bucket(
        rel, bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance,
    )
    return table[buckets.long()].permute(2, 0, 1)[None]
