"""BaseModel: config-driven construction and checkpoint I/O (the port's
counterpart of ``mr_blip_tpu/models/base.py``, reference
``lavis/models/base_model.py:19-247``).

``from_config`` builds from a ConfigDict, ``default_config_path`` resolves
per-model YAML defaults, and checkpoints are ``torch.save`` state dicts with
non-strict loading: missing and extra keys are logged, not fatal. The
reference's checkpoints become such a file through ``python -m
mr_blip_tpu_torch.port_weights``. A Flax msgpack file is not read here (it
needs flax): convert the JAX parameters with
``models/convert.py::state_dict_from_jax`` on the JAX side and
``torch.save`` the result.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch

from mr_blip_tpu_torch.common.utils import get_abs_path


class BaseModel:
    """Mixin for registered model wrappers."""

    PRETRAINED_MODEL_CONFIG_DICT: Dict[str, str] = {}

    @classmethod
    def default_config_path(cls, model_type: str | None = None):
        if not cls.PRETRAINED_MODEL_CONFIG_DICT:
            return None
        if model_type is None:
            model_type = next(iter(cls.PRETRAINED_MODEL_CONFIG_DICT))
        rel = cls.PRETRAINED_MODEL_CONFIG_DICT.get(model_type)
        return get_abs_path(rel) if rel else None

    @classmethod
    def from_config(cls, cfg, device="cuda"):
        raise NotImplementedError

    # -- checkpoint I/O ------------------------------------------------------

    @staticmethod
    def load_params_nonstrict(state_dict: Dict[str, torch.Tensor], path: str
                              ) -> Dict[str, torch.Tensor]:
        """``state_dict`` with every tensor the file at ``path`` holds under
        the same name and shape replaced by the file's; missing keys keep
        their values, extra keys and shape mismatches are logged and
        dropped (the reference's ``load_state_dict(strict=False)``,
        base_model.py:40-57). A missing file raises FileNotFoundError."""
        if str(path).endswith(".msgpack"):
            raise ValueError(
                f"{path}: a Flax msgpack checkpoint is not read by the port; the "
                "reference's own .pth / HF checkpoints go through python -m "
                "mr_blip_tpu_torch.port_weights (no JAX needed), and a JAX "
                "parameter tree through mr_blip_tpu_torch/models/convert.py::"
                "state_dict_from_jax (after scan_utils.unstack_blip2_mr_params) "
                "and torch.save")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        missing = [k for k in state_dict if k not in loaded]
        unexpected = [k for k in loaded if k not in state_dict]
        if missing:
            logging.info("load_params: %d missing keys (kept)", len(missing))
        if unexpected:
            logging.info("load_params: %d unexpected keys (dropped)", len(unexpected))
        merged = dict(state_dict)
        for k, target in state_dict.items():
            if k not in loaded:
                continue
            if tuple(loaded[k].shape) != tuple(target.shape):
                logging.warning("load_params: shape mismatch at %s: %s vs %s (kept)",
                                k, tuple(loaded[k].shape), tuple(target.shape))
                continue
            merged[k] = loaded[k]
        return merged
