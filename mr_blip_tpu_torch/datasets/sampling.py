"""Frame-index sampling (the port's copy of
``mr_blip_tpu/datasets/sampling.py``).

Replicates the reference ``load_video`` index math exactly
(``lavis/datasets/data_utils.py:30-85``): the [start, end) frame range
(optionally a ``clip_proposal`` in seconds, converted via fps) is split into
``n_frms`` equal intervals; ``random`` draws one index per interval (train),
``uniform`` takes interval midpoints (eval), ``headtail`` draws half from
each video half.  Short videos repeat the last index.
"""

from __future__ import annotations

import random as rnd
from typing import List, Optional, Sequence

import numpy as np


def sample_frame_indices(
    vlen: int,
    fps: float,
    n_frms: int,
    sampling: str = "uniform",
    clip_proposal: Optional[Sequence[float]] = None,
    rng: Optional[rnd.Random] = None,
) -> List[int]:
    rng = rng or rnd
    n_frms = min(n_frms, vlen)

    if clip_proposal is None:
        start, end = 0, vlen
    else:
        start, end = int(clip_proposal[0] * fps), int(clip_proposal[1] * fps)
        start = max(start, 0)
        end = min(end, vlen)

    intervals = np.linspace(start=start, stop=end, num=n_frms + 1).astype(int)
    ranges = list(zip(intervals[:-1], intervals[1:]))

    if sampling == "random":
        indices = [
            x[0] if x[0] == x[1] else rng.choice(range(x[0], x[1])) for x in ranges
        ]
    elif sampling == "uniform":
        indices = []
        for x in ranges:
            index = (x[0] + x[1]) // 2
            indices.append(index if index < vlen else vlen - 1)
    elif sampling == "headtail":
        indices_h = sorted(rng.sample(range(vlen // 2), n_frms // 2))
        indices_t = sorted(rng.sample(range(vlen // 2, vlen), n_frms // 2))
        indices = indices_h + indices_t
    else:
        raise NotImplementedError(f"sampling={sampling!r}")

    if len(indices) < n_frms:
        indices = indices + [indices[-1]] * (n_frms - len(indices))
    return [int(i) for i in indices]
