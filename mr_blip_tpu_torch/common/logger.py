"""Training logging: smoothed meters and the iteration logger.

The port's copy of ``mr_blip_tpu/common/logger.py`` (analog of the
reference's ``lavis/common/logger.py``): ``SmoothedValue`` tracks
windowed/global statistics of host-side floats, ``MetricLogger.log_every``
wraps an iterable with iter/data timing and ETA, and ``setup_logger``
configures INFO logging on process 0 only.  The device-memory figure is
``torch.cuda.max_memory_allocated`` when a card is in use.
"""

from __future__ import annotations

import datetime
import logging
import time
from collections import defaultdict, deque

import numpy as np

from mr_blip_tpu_torch.common import dist as dist_utils


class SmoothedValue:
    """Track a series of values with windowed median/avg and global avg."""

    def __init__(self, window_size=20, fmt=None):
        if fmt is None:
            fmt = "{median:.4f} ({global_avg:.4f})"
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum count/total across processes (reference: logger.py:37-48)."""
        if not dist_utils.is_dist_avail_and_initialized():
            return
        gathered = dist_utils.all_gather_object([self.count, self.total])
        self.count = int(sum(g[0] for g in gathered))
        self.total = float(sum(g[1] for g in gathered))

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


def _device_peak_memory_gb() -> float | None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.max_memory_allocated() / (1024**3)
    return None


class MetricLogger:
    def __init__(self, delimiter="\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v.item())
            assert isinstance(v, (float, int))
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'"
        )

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def global_avg(self):
        return self.delimiter.join(
            f"{name}: {meter.global_avg:.4f}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable, print_freq, header=None):
        header = header or ""
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        space_fmt = ":" + str(len(str(total))) + "d" if total else ""

        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta_seconds = iter_time.global_avg * (total - i)
                    eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
                else:
                    eta_string = "?"
                mem = _device_peak_memory_gb()
                mem_str = f" max mem: {mem:.2f} GB" if mem is not None else ""
                count_str = (
                    ("{0" + space_fmt + "}/{1}").format(i, total) if total else str(i)
                )
                logging.info(
                    f"{header} [{count_str}] eta: {eta_string} {self} "
                    f"time: {iter_time} data: {data_time}{mem_str}"
                )
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        logging.info(
            f"{header} Total time: {datetime.timedelta(seconds=int(total_time))} "
            f"({total_time / max(i, 1):.4f} s / it)"
        )


def setup_logger():
    logging.basicConfig(
        level=logging.INFO if dist_utils.is_main_process() else logging.WARN,
        format="%(asctime)s [%(levelname)s] %(message)s",
        force=True,
    )
