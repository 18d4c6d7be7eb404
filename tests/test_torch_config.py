"""The port's registry, config layering and YAML reader against the JAX
package's (``mr_blip_tpu/common/``), on the CPU.

The port reads YAML with a reader of its own (``common/yaml_subset.py``):
every file under ``configs/`` must give exactly pyyaml's dict under the JAX
package's ``_Yaml12Loader`` (values and their types), and a construct
outside the subset must raise. The layered ``Config`` of each
moment-retrieval project config, with ``--options`` overrides, must equal
the JAX package's.
"""

import math
from pathlib import Path

import pytest
import yaml

import mr_blip_tpu  # noqa: F401  (registers the JAX package's classes)
import mr_blip_tpu_torch  # noqa: F401  (registers the port's)
from mr_blip_tpu.common.config import Config as JaxConfig
from mr_blip_tpu.common.config import _Yaml12Loader
from mr_blip_tpu.common.registry import registry as jax_registry
from mr_blip_tpu_torch.common import yaml_subset
from mr_blip_tpu_torch.common.config import Config, ConfigDict, deep_merge, load_yaml, parse_options
from mr_blip_tpu_torch.common.config_validator import create_runner_config_validator
from mr_blip_tpu_torch.common.registry import registry

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "configs").rglob("*.yaml"))


def _typed(x):
    """Values with their types, so that 1, 1.0 and True differ."""
    if isinstance(x, dict):
        return {k: _typed(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_typed(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return ("float", "nan")
    return (type(x).__name__, x)


def test_configs_are_all_there():
    assert len(CONFIGS) == 107


@pytest.mark.parametrize("path", CONFIGS)
def test_load_yaml_equals_pyyaml(path):
    """Exact equality, types included, with the JAX package's loader."""
    with open(REPO / path) as f:
        want = yaml.load(f, Loader=_Yaml12Loader)
    got = yaml_subset.load(REPO / path)
    assert _typed(got) == _typed(want)
    assert load_yaml(REPO / path).to_dict() == (want or {})


@pytest.mark.parametrize("text", [
    "a: 3e-4", "a: -1.5e+3", "a: .5", "a: 1.", "a: 1_000", "a: .inf", "a: -.inf",
    "a: ~", "a:", "a: NULL", "a: TRUE", "a: false", "a: 'it''s'", 'a: "q\\"x"',
    "a: x#y  # comment", "a: [1, 'b c', \"d\", 2.5, null, True, [x, []]]",
    "# only a comment\na:\n  b:\n    c: 1\n  d: 2\ne: f",
])
def test_scalars_and_nesting_equal_pyyaml(text):
    assert _typed(yaml_subset.loads(text)) == _typed(yaml.load(text, Loader=_Yaml12Loader))


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a:\n  - 1", "- 1", "a: {b: 1}",
    "a: [1, {b: 2}]", "a: |\n  text", "a: >\n  text", "a: b\n  c", "a: 'x\n  y'",
    "---\na: 1", "%YAML 1.2\na: 1", "a: 1\na: 2", "a: yes", "a: off", "a: 0x10",
    "a: 010", "a: 1:30", "a: 2001-12-14", "a: [1,", "a: [1, ]", "  a: 1", "a:\n    b: 1\n  c: 2",
    "a: b: c", "key:value", "a: 'x' y", "<<: 1",
])
def test_outside_the_subset_raises(text):
    with pytest.raises(yaml_subset.YamlSubsetError):
        yaml_subset.loads(text)


# ------------------------------------------------------------- Config layering
MR_PROJECTS = [
    "eval/qvh", "eval/charades", "eval/charades_int8", "eval/anet",
    "eval/mixed_eval_qvh", "eval/mixed_eval_charades",
    "train/qvh", "train/charades", "train/anet", "train/tiny_synthetic",
]


def _options(project):
    name = next(iter(load_yaml(REPO / f"configs/projects/{project}.yaml")["datasets"]))
    return [f"datasets.{name}.build_info.annotations.test.storage=/data/test.json",
            f"datasets.{name}.build_info.videos.storage=synthetic",
            "model.load_finetuned=False", "run.output_dir=/tmp/out",
            "run.batch_size_eval", "2", "run.init_lr=1e-4", "model.num_beams=3"]


@pytest.mark.parametrize("project", MR_PROJECTS)
@pytest.mark.parametrize("with_options", [False, True])
def test_config_equals_jax(project, with_options):
    path = str(REPO / f"configs/projects/{project}.yaml")
    options = _options(project) if with_options else None
    got = Config(cfg_path=path, options=options).to_dict()
    want = JaxConfig(cfg_path=path, options=options).to_dict()
    assert _typed(got) == _typed(want)
    # the layers were read: model defaults and dataset defaults
    assert "vit_model" in got["model"]
    assert "build_info" in next(iter(got["datasets"].values()))
    if with_options:
        assert got["run"]["batch_size_eval"] == 2 and got["model"]["num_beams"] == 3


def test_qvh_dataset_defaults_keep_uint8_passthrough():
    cfg = Config(cfg_path=str(REPO / "configs/projects/eval/qvh.yaml"))
    assert cfg.datasets_cfg.qvh.vis_processor.eval.normalize is False
    assert cfg.model_cfg.compute_dtype == "bfloat16"
    assert cfg.run_cfg.init_lr == 3e-4 and isinstance(cfg.run_cfg.init_lr, float)


# ------------------------------------------- registry, merge, options (mirrors)
class TestRegistry:
    def test_register_and_get_model(self):
        @registry.register_model("torch_test_model_xyz")
        class M:
            pass

        assert registry.get_model_class("torch_test_model_xyz") is M
        assert "torch_test_model_xyz" in registry.list_models()
        assert jax_registry.get_model_class("torch_test_model_xyz") is None

    def test_duplicate_name_raises(self):
        @registry.register_task("torch_test_task_dup")
        class T1:
            pass

        with pytest.raises(KeyError):
            @registry.register_task("torch_test_task_dup")
            class T2:
                pass

    def test_state_dotted(self):
        registry.register("torch.a.b", 42)
        assert registry.get("torch.a.b") == 42
        assert registry.get("torch.a.missing", default="x") == "x"
        assert jax_registry.get("torch.a.b") is None

    def test_registries_are_separate(self):
        assert registry.mapping is not jax_registry.mapping
        from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
        from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR

        assert registry.get_model_class("blip2_mr") is BLIP2_MR
        assert jax_registry.get_model_class("blip2_mr") is JaxBLIP2_MR
        assert registry.get_path("library_root") == str(REPO)
        assert registry.get_path("cache_root").endswith("mr_blip_tpu_torch")
        for kind in ("tasks", "runners", "processors", "lr_schedulers"):
            port = [n for n in getattr(registry, f"list_{kind}")()
                    if not n.startswith("torch_test")]
            assert set(port) <= set(getattr(jax_registry, f"list_{kind}")()), kind
        assert "moment_retrieval" in registry.list_tasks()


class TestConfig:
    def test_deep_merge(self):
        base = {"run": {"lr": 1, "bs": 2}, "model": {"arch": "m"}}
        merged = deep_merge(base, {"run": {"lr": 3}})
        assert merged["run"]["lr"] == 3
        assert merged["run"]["bs"] == 2
        assert merged["model"]["arch"] == "m"

    def test_parse_options_equals_and_pairs(self):
        opts = parse_options(["run.lr=0.001", "model.arch", "blip2_mr", "run.flag=True"])
        assert opts["run"]["lr"] == 0.001
        assert opts["model"]["arch"] == "blip2_mr"
        assert opts["run"]["flag"] is True
        with pytest.raises(ValueError):
            parse_options(["run.dangling"])

    def test_config_from_yaml(self, tmp_path):
        cfg_file = tmp_path / "proj.yaml"
        cfg_file.write_text(
            "run:\n  task: moment_retrieval\n  lr_sched: linear_warmup_cosine_lr\n"
            "  init_lr: 0.0003\nmodel:\n  arch: nonexistent_arch_zz\n"
            "datasets:\n  fake_ds:\n    vis_processor:\n      train:\n        name: x\n"
        )
        cfg = Config(cfg_path=str(cfg_file), options=["run.init_lr=0.1"])
        assert cfg.run_cfg.task == "moment_retrieval"
        assert cfg.run_cfg.init_lr == 0.1  # CLI override wins
        assert cfg.model_cfg.arch == "nonexistent_arch_zz"
        assert "fake_ds" in cfg.datasets_cfg

    def test_attribute_access(self):
        c = ConfigDict({"a": {"b": 1}})
        assert c.a.b == 1
        with pytest.raises(AttributeError):
            _ = c.missing

    def test_run_config_validator(self):
        validator = create_runner_config_validator()
        run = dict(Config(cfg_path=str(REPO / "configs/projects/eval/qvh.yaml")).run_cfg)
        validator.validate(run)
        with pytest.raises(ValueError):
            validator.validate({"batch_size_eval": "four"})
        with pytest.raises(ValueError):
            validator.validate({"lr_sched": "no_such_schedule"})
