"""The runners, ``runner_base.py`` (epochs: training, validation, checkpoints,
resume and preemption, evaluation) and ``runner_iter.py`` (inner epochs keyed
by iterations), both registered on import, and the training step: AdamW over
the trainable parameters, gradient accumulation and the per-step dropout
generator (``train_state.py``)."""

from mr_blip_tpu_torch.runners import runner_base, runner_iter  # noqa: F401  (registers)
