"""Host-side text utilities, copied from ``mr_blip_tpu.text`` (they import
only ``re``, ``ast`` and ``numpy``, so the port carries its own copy rather
than importing the JAX package)."""
