"""Experiment tracking: W&B-compatible facade with a local JSONL backend (the
port's copy of ``mr_blip_tpu/common/tracking.py``).

The reference logs train loss/lr per iter, eval metric panels, and sample
tables to Weights & Biases (blip2_mr.py:546-567, moment_retrieval.py:71-85,
blip2_mr_models/utils.py:86-239).  This shim keeps that surface:

    tracker = init(project="mr_BLIP", name="QVH", config={...}, out_dir=...)
    tracker.log({"train/loss": 1.23})
    tracker.log_table("samples", columns=[...], rows=[...])

When the real ``wandb`` package is importable and ``WANDB_MODE`` is not
"disabled", events mirror to it; otherwise everything lands in
``<out_dir>/events.jsonl`` (machine-readable, plot-friendly).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from mr_blip_tpu_torch.common import dist as dist_utils

_run = None


class Tracker:
    def __init__(self, project: str, name: str, config: Optional[dict],
                 out_dir: str, wandb_run=None):
        self.project = project
        self.name = name
        self.out_dir = out_dir
        self._wandb = wandb_run
        os.makedirs(out_dir, exist_ok=True)
        self._path = os.path.join(out_dir, "events.jsonl")
        self._step = 0
        if config:
            self._write({"type": "config", "config": config})

    def _write(self, event: Dict[str, Any]):
        event.setdefault("ts", time.time())
        with open(self._path, "a") as f:
            f.write(json.dumps(event, default=str) + "\n")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        self._step = step if step is not None else self._step + 1
        self._write({"type": "metrics", "step": self._step, **metrics})
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_table(self, key: str, columns: List[str], rows: List[list]):
        self._write({"type": "table", "key": key, "columns": columns, "rows": rows})
        if self._wandb is not None:
            import wandb

            table = wandb.Table(columns=columns)
            for row in rows:
                table.add_data(*row)
            self._wandb.log({key: table})

    def finish(self):
        self._write({"type": "finish"})
        if self._wandb is not None:
            self._wandb.finish()


def init(project: str, name: str, config: Optional[dict] = None,
         out_dir: str = "output", enabled: bool = True) -> Optional[Tracker]:
    """Process-0-only tracker construction; returns None elsewhere (and
    then ``get()`` returns None too, not an earlier run's tracker)."""
    global _run
    _run = None
    if not enabled or not dist_utils.is_main_process():
        return None
    wandb_run = None
    if os.environ.get("WANDB_MODE", "disabled") != "disabled":
        try:
            import wandb

            wandb_run = wandb.init(project=project, name=name, config=config)
        except Exception:
            wandb_run = None
    _run = Tracker(project, name, config, out_dir, wandb_run)
    return _run


def get() -> Optional[Tracker]:
    return _run
