"""The training step: AdamW over the trainable parameters, gradient
accumulation and the per-step dropout generator."""
