"""Process helpers over ``torch.distributed`` (the port's counterpart of
``mr_blip_tpu/common/dist.py``).

A world of one process initializes no process group, as the JAX package
does with one process, whatever ``run.distributed`` says; every helper then
degrades to the single-process answer. More than one process
(``WORLD_SIZE`` > 1) is not ported yet: multi-process evaluation and
training over NCCL are ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import functools
import logging
import os

import torch.distributed as tdist


def init_distributed_mode(run_cfg=None) -> bool:
    """False for one process; raises for more (not ported yet)."""
    if tdist.is_available() and tdist.is_initialized():
        return True
    if run_cfg is not None and not run_cfg.get("distributed", True):
        return False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: multi-process evaluation and training over "
            "torch.distributed are not ported yet (ROADMAP Queue 1 item 8)")
    logging.info("single process: no process group")
    return False


def is_dist_avail_and_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def get_rank() -> int:
    return tdist.get_rank() if is_dist_avail_and_initialized() else 0


def get_world_size() -> int:
    return tdist.get_world_size() if is_dist_avail_and_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def main_process(func):
    """Run ``func`` only on process 0 (reference ``main_process`` decorator)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)
        return None

    return wrapper


def barrier():
    if is_dist_avail_and_initialized():
        tdist.barrier()


def all_gather_object(obj):
    """Gather a python object from every process (rank-ordered list)."""
    if not is_dist_avail_and_initialized():
        return [obj]
    out = [None] * get_world_size()
    tdist.all_gather_object(out, obj)
    return out
