"""mr_blip_tpu_torch: the PyTorch + CUDA port of ``mr_blip_tpu``.

Module paths mirror the JAX package (``models/t5.py`` here is the
counterpart of ``mr_blip_tpu/models/t5.py``). The package imports
``torch`` and never ``jax``: the JAX package is the reference the port is
tested against, not a dependency.

The hand-written Hopper kernels live in ``csrc/``; ``ops/_cuda.py`` builds
them with ``nvcc`` on first use and binds them with ``ctypes``.
"""

__version__ = "0.1.0"
