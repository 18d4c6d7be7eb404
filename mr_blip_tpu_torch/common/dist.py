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

Tensor parallelism (``run.tp`` = t > 1) splits the world of ``dp x t``
ranks into groups, the counterpart of ``make_mesh(tp=t)``'s (dp, tp) grid:
ranks ``i·t .. i·t + t - 1`` form tensor-parallel group ``i`` (they hold
the shards of one model and read the same rows), and ranks ``j, j + t,
j + 2t, ...`` form data-parallel group ``j`` (they hold the same shard and
read other rows). ``tp_group`` / ``dp_group`` and their sizes and ranks
answer for the calling rank; without tensor parallelism the dp group is the
world and the tp group is None.
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
        tp = int(run_cfg.get("tp", 1))
        if tp > 1:
            raise ValueError(
                f"run.tp={tp} in one process: tensor parallelism runs one process "
                f"a shard; launch python -m torch.distributed.run "
                f"--nproc_per_node={tp} -m mr_blip_tpu_torch.train|evaluate ... "
                f"--options run.distributed=True run.tp={tp}")
        logging.info("single process: no process group")
        return False
    if not run_cfg.get("distributed", True):
        raise ValueError(
            f"WORLD_SIZE={world} but run.distributed=False: set "
            "run.distributed=True to train or evaluate over the process group")
    rank, local_rank = _env_int("RANK", 0), _env_int("LOCAL_RANK", 0)
    device = run_device(run_cfg.get("device", "cuda"))
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
    init_model_parallel(int(run_cfg.get("tp", 1)))
    if on_card:
        build_kernels_once()
    return True


_MODEL_PARALLEL = {"tp": 1, "tp_group": None, "dp_group": None}


def init_model_parallel(tp: int = 1):
    """Split the world into tensor-parallel groups of ``tp`` consecutive
    ranks and data-parallel groups of the ranks ``tp`` apart (a collective:
    every rank calls it with the same ``tp``). ``tp`` 1 sets the groups back
    to none (the dp group is then the world)."""
    world, rank = get_world_size(), get_rank()
    if tp < 1 or world % tp:
        raise ValueError(f"run.tp={tp} does not divide the world of {world} ranks")
    _MODEL_PARALLEL.update(tp=1, tp_group=None, dp_group=None)
    if tp == 1:
        return
    for i in range(world // tp):
        ranks = list(range(i * tp, (i + 1) * tp))
        group = tdist.new_group(ranks)
        if rank in ranks:
            _MODEL_PARALLEL["tp_group"] = group
    for j in range(tp):
        ranks = list(range(j, world, tp))
        group = tdist.new_group(ranks)
        if rank in ranks:
            _MODEL_PARALLEL["dp_group"] = group
    _MODEL_PARALLEL["tp"] = tp
    logging.info("tensor parallelism: %d x %d (dp x tp), rank %d: tp rank %d, dp "
                 "rank %d", world // tp, tp, rank, tp_rank(), dp_rank())


def tp_size() -> int:
    return _MODEL_PARALLEL["tp"]


def tp_rank() -> int:
    return get_rank() % tp_size()


def tp_group():
    """This rank's tensor-parallel group (None without tensor parallelism)."""
    return _MODEL_PARALLEL["tp_group"]


def dp_size() -> int:
    return get_world_size() // tp_size()


def dp_rank() -> int:
    return get_rank() // tp_size()


def dp_group():
    """This rank's data-parallel group (None: the world)."""
    return _MODEL_PARALLEL["dp_group"]


def build_kernels_once():
    """Local rank 0 builds the kernel library while the other ranks wait at
    a barrier; they then load the library it built."""
    if _env_int("LOCAL_RANK", 0) == 0:
        from mr_blip_tpu_torch.ops import _cuda

        _cuda.build()
    barrier()


_TPU_READ: list = []


def run_device(device="cuda") -> str:
    """``run.device`` as a torch device name. The zoo configs' ``tpu`` (the
    JAX package's accelerator) means the accelerator here, the card: read as
    ``cuda``, with a log line saying so. Any other name torch does not know
    raises ``ValueError`` naming the key."""
    name = str(device)
    if name == "tpu":
        if not _TPU_READ:
            logging.info("run.device: 'tpu' read as the accelerator here, 'cuda'")
            _TPU_READ.append(True)
        return "cuda"
    try:
        torch.device(name)
    except RuntimeError as err:
        raise ValueError(f"run.device={name!r}: not a device ({err}); use cuda, "
                         "cuda:N or cpu") from None
    return name


def local_device(device="cuda") -> torch.device:
    """``device`` (``run_device``) with this process's card: ``cuda`` becomes
    ``cuda:LOCAL_RANK`` under a launcher that sets ``LOCAL_RANK`` (with more
    local ranks than cards, ``cuda:LOCAL_RANK % cards``: two ranks on one
    card share it, which ``gloo`` allows and ``nccl`` refuses); the CPU and
    an explicit index are returned as they are."""
    device = torch.device(run_device(device))
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


def all_reduce(tensor: torch.Tensor, op=None, group=None) -> torch.Tensor:
    """Sum (or ``op``) ``tensor`` over the ranks of ``group`` (default: the
    world), in place; returned."""
    if is_dist_avail_and_initialized():
        tdist.all_reduce(tensor, op=tdist.ReduceOp.SUM if op is None else op,
                         group=group)
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
    _MODEL_PARALLEL.update(tp=1, tp_group=None, dp_group=None)
    if is_dist_avail_and_initialized():
        tdist.destroy_process_group()
