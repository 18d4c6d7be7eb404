"""Preemption-tolerant training: SIGTERM-safe checkpoint and resume (the
port's copy of ``mr_blip_tpu/common/preempt.py``).

The reference has no in-framework preemption handling — ``torch.
distributed.run`` restarts processes externally and anything since the
last end-of-epoch checkpoint is lost (reference ``runner_base.py:572-644``
saves/resumes at epoch granularity only). Spot and preemptible machines
and maintenance drains deliver SIGTERM with a grace window (30 s+), and a
50-epoch QVH run *will* see one. This module turns that signal into a
clean mid-epoch stop:

* :class:`PreemptionGuard` installs a SIGTERM handler that sets a flag —
  the handler does nothing else (async-signal-safe), so a signal landing
  while kernels are in flight cannot corrupt anything.
* The train inner loop polls the guard at step boundaries (optimizer
  state is only ever observed between whole steps) and raises
  :class:`TrainingPreempted`.
* ``RunnerBase.train`` catches it, writes the full resume state (weights,
  AdamW moments, the partially accumulated gradients, the step counters)
  with ``epoch_complete=False`` so resume re-runs the interrupted epoch,
  and re-raises for the entry point to exit with code 143.

Multi-process consistency: every process must stop at the SAME step
(rank 0 writes the checkpoint; a rank that kept stepping would desync the
params it holds from what was saved, and a collective with a missing
participant hangs the rest of the grace window away). ``should_stop``
therefore allgathers the local flag every ``sync_every`` steps and stops
iff ANY process saw the signal — all processes reach the same verdict at
the same step boundary because the allgather itself is a collective.
"""

from __future__ import annotations

import logging
import signal
import threading

from mr_blip_tpu_torch.common import dist as dist_utils


class TrainingPreempted(Exception):
    """Raised at a step boundary after a preemption signal; carries the
    epoch/iteration where training stopped."""

    def __init__(self, epoch: int, inner_iter: int):
        super().__init__(
            f"preempted at epoch {epoch}, iter {inner_iter} (state is at a "
            "step boundary; resume re-runs this epoch)"
        )
        self.epoch = epoch
        self.inner_iter = inner_iter


class PreemptionGuard:
    """Flag-only signal handler + synchronized stop decision.

    ``install()`` is idempotent and chain-preserving: a previously
    installed Python-level handler still runs after the flag is set, and
    ``uninstall()`` restores it.
    """

    def __init__(self, sync_every: int = 8):
        self._flag = threading.Event()
        self._prev = {}
        self.sync_every = max(1, int(sync_every))

    # ------------------------------------------------------------- signals
    def install(self, signals=(signal.SIGTERM,)):
        for sig in signals:
            if sig in self._prev:
                continue
            prev = signal.getsignal(sig)
            signal.signal(sig, self._make_handler(prev))
            self._prev[sig] = prev
        return self

    def _make_handler(self, prev):
        def handler(signum, frame):
            self._flag.set()
            logging.warning(
                "received signal %d: finishing the current step, then "
                "checkpointing for resume", signum,
            )
            if callable(prev) and prev not in (
                signal.SIG_IGN, signal.SIG_DFL, signal.default_int_handler,
            ):
                prev(signum, frame)

        return handler

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    # -------------------------------------------------------------- polling
    def request(self):
        """Programmatic preemption (tests; cooperative shutdown)."""
        self._flag.set()

    def requested_locally(self) -> bool:
        return self._flag.is_set()

    def should_stop(self, step: int, last: bool = False) -> bool:
        """Synchronized stop decision for step boundary ``step`` (``last``:
        the epoch's last step).

        Single-process: the local flag. Multi-process: every
        ``sync_every`` steps and at the epoch's last step, allgather the
        flag and stop iff any process has it — between sync points the
        answer is always False, so all processes agree on the exact stop
        step (every rank takes as many steps an epoch, and reads
        ``sync_every`` from the same config). The epoch's last step syncs
        too, so that an epoch shorter than ``sync_every`` still stops.
        """
        if not dist_utils.is_dist_avail_and_initialized():
            return self._flag.is_set()
        if step % self.sync_every != self.sync_every - 1 and not last:
            return False
        flags = dist_utils.all_gather_object(bool(self._flag.is_set()))
        return any(flags)


_guard: PreemptionGuard | None = None


def install_guard(sync_every: int = 8) -> PreemptionGuard:
    """Install (or fetch) the process-wide guard."""
    global _guard
    if _guard is None:
        _guard = PreemptionGuard(sync_every=sync_every).install()
    return _guard


def get_guard() -> PreemptionGuard | None:
    return _guard


def uninstall_guard():
    """Restore the handlers the guard replaced and forget it, so that an
    entry point called again in the same process starts unpreempted."""
    global _guard
    if _guard is not None:
        _guard.uninstall()
        _guard = None
