"""mr_blip_tpu_torch: the PyTorch + CUDA port of ``mr_blip_tpu``.

Module paths mirror the JAX package (``models/t5.py`` here is the
counterpart of ``mr_blip_tpu/models/t5.py``). The package imports
``torch`` and never ``jax``: the JAX package is the reference the port is
tested against, not a dependency. It needs neither pyyaml nor scikit-learn.

The hand-written Hopper kernels live in ``csrc/``; ``ops/_cuda.py`` builds
them with ``nvcc`` on first use and binds them with ``ctypes``.

Importing the package registers the port's models, tasks, dataset
builders, processors, LR schedulers and runners in its own registry
(``common/registry.py``), as importing the JAX package registers its own;
``python -m mr_blip_tpu_torch.train`` and ``python -m
mr_blip_tpu_torch.evaluate`` are the entry points.
"""

__version__ = "0.1.0"

MAX_INT = 2**31 - 1

from mr_blip_tpu_torch.common.utils import setup_library_paths as _setup_library_paths

_setup_library_paths()

from mr_blip_tpu_torch.common import optims as _optims  # noqa: E402  (registers)
from mr_blip_tpu_torch import processors as _processors  # noqa: E402
from mr_blip_tpu_torch.models import blip2_mr as _blip2_mr  # noqa: E402
from mr_blip_tpu_torch.models import blip2_fmr as _blip2_fmr  # noqa: E402
from mr_blip_tpu_torch.models import blip2_mr_opt as _blip2_mr_opt  # noqa: E402
from mr_blip_tpu_torch.datasets import builders as _builders  # noqa: E402
from mr_blip_tpu_torch.datasets import image_datasets as _image_datasets  # noqa: E402
from mr_blip_tpu_torch.models import blip_v1 as _blip_v1  # noqa: E402
from mr_blip_tpu_torch.models import clip as _clip  # noqa: E402
from mr_blip_tpu_torch.models import albef as _albef  # noqa: E402
from mr_blip_tpu_torch.models import zoo_wrappers as _zoo_wrappers  # noqa: E402
from mr_blip_tpu_torch import tasks as _tasks  # noqa: E402
from mr_blip_tpu_torch import runners as _runners  # noqa: E402
