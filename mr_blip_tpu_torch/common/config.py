"""Hierarchical YAML config system (the port's copy of
``mr_blip_tpu/common/config.py``, which the port may not import).

Reproduces the reference config layering (``lavis/common/config.py:16-166``)
without OmegaConf: a project YAML's ``model:`` section merges over the model
class's default config (resolved via ``default_config_path``), each entry in
``datasets:`` merges over the dataset builder's default config, and CLI
``--options a.b=c`` dot-list overrides apply last.  Sections:

    run:       runner/task/optimizer options
    model:     arch + model hyperparameters
    datasets:  {dataset_name: {vis_processor, text_processor, build_info, ...}}

The YAML files are read by ``common/yaml_subset.py``, not pyyaml: the
subset every file under ``configs/`` uses, with the JAX package's float
resolution (``3e-4`` is a float); anything outside it raises.
"""

from __future__ import annotations

import ast
import json
import logging
import os
from typing import Any

from mr_blip_tpu_torch.common import yaml_subset


class ConfigDict(dict):
    """A dict with attribute access and recursive wrapping."""

    def __init__(self, data=None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = self._wrap(v)

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict(value)
        if isinstance(value, list):
            return [ConfigDict._wrap(v) for v in value]
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        self[key] = value

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, ConfigDict) else x for x in v]
            else:
                out[k] = v
        return out

    def copy(self):
        return ConfigDict(self.to_dict())


def deep_merge(base: dict, override: dict) -> ConfigDict:
    """Recursively merge ``override`` on top of ``base`` (override wins)."""
    out = ConfigDict(base if isinstance(base, dict) else {})
    for k, v in (override or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str) -> ConfigDict:
    return ConfigDict(yaml_subset.load(path) or {})


def _parse_value(raw: str) -> Any:
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def parse_options(options) -> ConfigDict:
    """Parse a CLI dot-list (``["run.lr=1e-4", "model.arch", "blip2_mr"]``).

    Accepts both ``key=value`` tokens and alternating ``key value`` pairs,
    matching the reference's ``--options`` ergonomics (config.py:114-126).
    """
    out = ConfigDict()
    if not options:
        return out

    pairs = []
    i = 0
    while i < len(options):
        token = options[i]
        if "=" in token:
            key, value = token.split("=", 1)
            pairs.append((key, value))
            i += 1
        else:
            if i + 1 >= len(options):
                raise ValueError(f"Dangling option key {token!r} without a value")
            pairs.append((token, options[i + 1]))
            i += 2

    for key, raw in pairs:
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = _parse_value(raw)
    return out


class Config:
    """Three-way layered configuration: defaults <- project YAML <- CLI options."""

    def __init__(self, args=None, cfg_path: str | None = None, options=None):
        if args is not None:
            cfg_path = getattr(args, "cfg_path", cfg_path)
            options = getattr(args, "options", options)

        self.config = ConfigDict()
        user_config = parse_options(options)

        project = load_yaml(cfg_path) if cfg_path else ConfigDict()
        project = deep_merge(project, user_config)

        runner_config = ConfigDict({"run": project.get("run", {})})
        model_config = self.build_model_config(project, user_config)
        dataset_config = self.build_dataset_config(project)

        self.config = deep_merge(
            deep_merge(runner_config, model_config), dataset_config
        )
        # re-apply user overrides so they win over every default layer
        self.config = deep_merge(self.config, user_config)

    @staticmethod
    def build_model_config(config: ConfigDict, user_config: ConfigDict) -> ConfigDict:
        model = config.get("model")
        if model is None:
            return ConfigDict()
        assert "arch" in model, "Missing model 'arch' in config."

        from mr_blip_tpu_torch.common.registry import registry

        model_cls = registry.get_model_class(model["arch"])
        default_model_config = ConfigDict()
        if model_cls is not None:
            model_type = model.get("model_type") or (
                user_config.get("model", {}) or {}
            ).get("model_type")
            default_path = model_cls.default_config_path(model_type=model_type)
            if default_path and os.path.exists(default_path):
                default_model_config = ConfigDict(
                    {"model": load_yaml(default_path).get("model", {})}
                )
        return deep_merge(default_model_config, ConfigDict({"model": model}))

    @staticmethod
    def build_dataset_config(config: ConfigDict) -> ConfigDict:
        datasets = config.get("datasets")
        if datasets is None:
            return ConfigDict()

        from mr_blip_tpu_torch.common.registry import registry

        dataset_config = ConfigDict({"datasets": {}})
        for dataset_name in datasets:
            builder_cls = registry.get_builder_class(dataset_name)
            defaults = ConfigDict()
            if builder_cls is not None:
                ds_type = datasets[dataset_name].get("type", "default")
                default_path = builder_cls.default_config_path(type=ds_type)
                if default_path and os.path.exists(default_path):
                    defaults = load_yaml(default_path).get("datasets", {}).get(
                        dataset_name, {}
                    )
            dataset_config["datasets"][dataset_name] = deep_merge(
                defaults, datasets[dataset_name]
            )
        return dataset_config

    # -- section accessors (reference: config.py run_cfg/model_cfg/datasets_cfg)
    @property
    def run_cfg(self) -> ConfigDict:
        return self.config.get("run", ConfigDict())

    @property
    def model_cfg(self) -> ConfigDict:
        return self.config.get("model", ConfigDict())

    @property
    def datasets_cfg(self) -> ConfigDict:
        return self.config.get("datasets", ConfigDict())

    def to_dict(self) -> dict:
        return self.config.to_dict()

    def pretty_print(self):
        logging.info("\n=====  Running Parameters    =====")
        logging.info(json.dumps(self.run_cfg.to_dict(), indent=4, default=str))
        logging.info("\n======  Dataset Attributes  ======")
        logging.info(json.dumps(self.datasets_cfg.to_dict(), indent=4, default=str))
        logging.info("\n======  Model Attributes  ======")
        logging.info(json.dumps(self.model_cfg.to_dict(), indent=4, default=str))
