"""Data, sequence, tensor and pipeline parallelism over ``torch.distributed``
(the port's counterpart of ``mr_blip_tpu/parallel/``): ``mesh.py`` for dp and
sp, ``tensor.py`` for tp, ``pipeline.py`` for pp."""

from mr_blip_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    assert_replicated,
    frame_share,
    gather_frames,
    global_sum,
    rank_rows,
)

__all__ = ["all_reduce_grads", "assert_replicated", "frame_share", "gather_frames",
           "global_sum", "rank_rows"]
