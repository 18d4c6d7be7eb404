"""Misc host-side utilities (job ids, path helpers, cached file resolution);
the port's copy of ``mr_blip_tpu/common/utils.py``.

``library_root`` is the repo root (``configs/`` lives beside the package);
the cache root is the port's own, ``~/.cache/mr_blip_tpu_torch``.
"""

from __future__ import annotations

import os
from datetime import datetime

from mr_blip_tpu_torch.common.registry import registry

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CACHE_ROOT = "~/.cache/mr_blip_tpu_torch"


def now() -> str:
    return datetime.now().strftime("%Y%m%d%H%M")[:-1]


def get_abs_path(rel_path: str) -> str:
    root = registry.get_path("library_root") or _REPO_ROOT
    return os.path.join(root, rel_path)


def get_cache_path(rel_path: str) -> str:
    cache_root = registry.get_path("cache_root") or os.path.expanduser(_CACHE_ROOT)
    return os.path.expanduser(os.path.join(cache_root, rel_path))


def setup_library_paths():
    """Register library_root / cache_root once at import (reference
    lavis/__init__.py:21-31)."""
    if registry.get_path("library_root") is None:
        registry.register_path("library_root", _REPO_ROOT)
    if registry.get_path("cache_root") is None:
        registry.register_path("cache_root", os.path.expanduser(_CACHE_ROOT))
    registry.register("MAX_INT", 2**31 - 1)
