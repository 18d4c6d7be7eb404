"""Process helpers over ``torch.distributed`` (the port's counterpart of
``mr_blip_tpu/common/dist.py``, reference ``lavis/common/dist_utils.py``).

A world of one process initializes no process group, as the JAX package
does with one process, whatever ``run.distributed`` says; every helper then
degrades to the single-process answer. Under ``torchrun`` (``WORLD_SIZE`` >
1, ``RANK`` and ``LOCAL_RANK`` in the environment, ``env://`` rendezvous)
``init_distributed_mode`` joins the process group with the backend
``run.dist_backend`` (``nccl`` on the card by default, ``gloo`` for
``run.device=cpu``) and a finite ``run.dist_timeout_s``, so that a
collective a rank never reaches raises instead of stalling. There is no
fallback: a host without a card when ``run.device`` is ``cuda``, a backend
that fails to start and a collective that times out all raise.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os

import torch
import torch.distributed as tdist

DEFAULT_TIMEOUT_S = 1800


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_distributed_mode(run_cfg=None) -> bool:
    """Join the process group when ``WORLD_SIZE`` > 1; False for one
    process. On the card every rank is pinned to ``cuda:LOCAL_RANK`` and
    local rank 0 builds the kernels while the other ranks wait."""
    if is_dist_avail_and_initialized():
        return True
    run_cfg = {} if run_cfg is None else run_cfg
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1:
        logging.info("single process: no process group")
        return False
    if not run_cfg.get("distributed", True):
        raise ValueError(
            f"WORLD_SIZE={world} but run.distributed=False: set "
            "run.distributed=True to train or evaluate over the process group")
    rank, local_rank = _env_int("RANK", 0), _env_int("LOCAL_RANK", 0)
    device = str(run_cfg.get("device", "cuda"))
    on_card = device.startswith("cuda")
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"WORLD_SIZE={world}, run.device={device!r}: no CUDA device on "
                "this host; pass run.device=cpu to run the ranks on the host")
        torch.cuda.set_device(local_device(device))
    backend = run_cfg.get("dist_backend") or ("nccl" if on_card else "gloo")
    timeout = datetime.timedelta(
        seconds=float(run_cfg.get("dist_timeout_s", DEFAULT_TIMEOUT_S)))
    tdist.init_process_group(backend=backend, init_method="env://",
                             world_size=world, rank=rank, timeout=timeout)
    logging.info("process group: rank %d of %d (local %d), %s, timeout %s",
                 rank, world, local_rank, backend, timeout)
    if on_card:
        build_kernels_once()
    return True


def build_kernels_once():
    """Local rank 0 builds the kernel library while the other ranks wait at
    a barrier; they then load the library it built."""
    if _env_int("LOCAL_RANK", 0) == 0:
        from mr_blip_tpu_torch.ops import _cuda

        _cuda.build()
    barrier()


def local_device(device="cuda") -> torch.device:
    """``device`` with this process's card: ``cuda`` becomes
    ``cuda:LOCAL_RANK`` under a launcher that sets ``LOCAL_RANK`` (with more
    local ranks than cards, ``cuda:LOCAL_RANK % cards``: two ranks on one
    card share it, which ``gloo`` allows and ``nccl`` refuses); the CPU and
    an explicit index are returned as they are."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("run.device='cuda': no CUDA device on this host")
        return torch.device("cuda", _env_int("LOCAL_RANK", 0) % cards)
    return device


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
    if not is_dist_avail_and_initialized():
        return
    if tdist.get_backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def all_reduce(tensor: torch.Tensor, op=None) -> torch.Tensor:
    """Sum (or ``op``) ``tensor`` over the ranks, in place; returned."""
    if is_dist_avail_and_initialized():
        tdist.all_reduce(tensor, op=tdist.ReduceOp.SUM if op is None else op)
    return tensor


def broadcast(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place; returned."""
    if is_dist_avail_and_initialized():
        tdist.broadcast(tensor, src=src)
    return tensor


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not is_dist_avail_and_initialized():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj):
    """Gather a python object from every process (rank-ordered list)."""
    if not is_dist_avail_and_initialized():
        return [obj]
    out = [None] * get_world_size()
    tdist.all_gather_object(out, obj)
    return out


def destroy():
    """Leave the process group (the entry points call it before they
    return, so that a process can start another run)."""
    if is_dist_avail_and_initialized():
        tdist.destroy_process_group()
