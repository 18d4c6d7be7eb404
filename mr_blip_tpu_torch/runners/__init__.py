"""The evaluation half of the runner (``runner_base.py``) and the training
step: AdamW over the trainable parameters, gradient accumulation and the
per-step dropout generator (``train_state.py``)."""
