"""Framework-neutral helpers copied from the JAX package (learning-rate
schedules)."""
