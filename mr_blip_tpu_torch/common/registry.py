"""Central name -> class registry of the port (a copy of
``mr_blip_tpu/common/registry.py``, which the port may not import).

Everything in the framework is constructed by name lookup driven by YAML
configs, mirroring the reference registry's public surface
(``lavis/common/registry.py:9-329``): six class kinds (model, task, builder,
processor, lr_scheduler, runner) plus registered paths and arbitrary state.
This ``Registry`` is a class of its own with its own ``mapping``: the JAX
package's registry and this one live in one process without touching each
other.
"""

from __future__ import annotations


class Registry:
    mapping = {
        "builder_name_mapping": {},
        "task_name_mapping": {},
        "processor_name_mapping": {},
        "model_name_mapping": {},
        "lr_scheduler_name_mapping": {},
        "runner_name_mapping": {},
        "state": {},
        "paths": {},
    }

    @classmethod
    def _register(cls, kind: str, name: str, obj=None):
        def wrap(target):
            mapping = cls.mapping[kind]
            if name in mapping and mapping[name] is not target:
                raise KeyError(
                    f"Name '{name}' already registered for {mapping[name]}."
                )
            mapping[name] = target
            return target

        return wrap if obj is None else wrap(obj)

    # -- decorators ---------------------------------------------------------
    @classmethod
    def register_builder(cls, name):
        return cls._register("builder_name_mapping", name)

    @classmethod
    def register_task(cls, name):
        return cls._register("task_name_mapping", name)

    @classmethod
    def register_processor(cls, name):
        return cls._register("processor_name_mapping", name)

    @classmethod
    def register_model(cls, name):
        return cls._register("model_name_mapping", name)

    @classmethod
    def register_lr_scheduler(cls, name):
        return cls._register("lr_scheduler_name_mapping", name)

    @classmethod
    def register_runner(cls, name):
        return cls._register("runner_name_mapping", name)

    # -- paths / state ------------------------------------------------------
    @classmethod
    def register_path(cls, name, path):
        cls.mapping["paths"][name] = path

    @classmethod
    def register(cls, name, obj):
        """Register arbitrary state under a (possibly dotted) name."""
        path = name.split(".")
        current = cls.mapping["state"]
        for part in path[:-1]:
            current = current.setdefault(part, {})
        current[path[-1]] = obj

    # -- getters -------------------------------------------------------------
    @classmethod
    def get_builder_class(cls, name):
        return cls.mapping["builder_name_mapping"].get(name)

    @classmethod
    def get_task_class(cls, name):
        return cls.mapping["task_name_mapping"].get(name)

    @classmethod
    def get_processor_class(cls, name):
        return cls.mapping["processor_name_mapping"].get(name)

    @classmethod
    def get_model_class(cls, name):
        return cls.mapping["model_name_mapping"].get(name)

    @classmethod
    def get_lr_scheduler_class(cls, name):
        return cls.mapping["lr_scheduler_name_mapping"].get(name)

    @classmethod
    def get_runner_class(cls, name):
        return cls.mapping["runner_name_mapping"].get(name)

    @classmethod
    def list_models(cls):
        return sorted(cls.mapping["model_name_mapping"].keys())

    @classmethod
    def list_tasks(cls):
        return sorted(cls.mapping["task_name_mapping"].keys())

    @classmethod
    def list_processors(cls):
        return sorted(cls.mapping["processor_name_mapping"].keys())

    @classmethod
    def list_lr_schedulers(cls):
        return sorted(cls.mapping["lr_scheduler_name_mapping"].keys())

    @classmethod
    def list_runners(cls):
        return sorted(cls.mapping["runner_name_mapping"].keys())

    @classmethod
    def get_path(cls, name):
        return cls.mapping["paths"].get(name)

    @classmethod
    def get(cls, name, default=None, no_warning=False):
        path = name.split(".")
        current = cls.mapping["state"]
        for part in path:
            if not isinstance(current, dict) or part not in current:
                return default
            current = current[part]
        return current

    @classmethod
    def unregister(cls, name):
        return cls.mapping["state"].pop(name, None)


registry = Registry
