"""The port's evaluation entry point against the JAX package's, on the CPU.

``BLIP2_MR.from_config`` must hand its constructor what the JAX package's
hands its own for every key the port supports, raise ``NotImplementedError``
naming a ROADMAP item for every setting it cannot compute, accept the
TPU-only keys, and quantize after the checkpoint load. End to end, the JAX
package's evaluation of ``configs/projects/train/tiny_synthetic.yaml`` (its
runner, in this process, on one device as ``evaluate.py`` runs it) and
``mr_blip_tpu_torch.evaluate`` on the JAX model's weights, converted, must
write the same result rows and report the same metrics dict: identical, no
tolerance.
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import mr_blip_tpu  # noqa: F401
import mr_blip_tpu_torch  # noqa: F401
from mr_blip_tpu import tasks as jax_tasks
from mr_blip_tpu.common.config import Config as JaxConfig
from mr_blip_tpu.models import t5 as jt5
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.models.scan_utils import stack_blip2_mr_params, unstack_blip2_mr_params
from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
from mr_blip_tpu_torch import evaluate
from mr_blip_tpu_torch.common.config import Config, ConfigDict
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
from mr_blip_tpu_torch.models import t5 as tt5
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs/projects/train/tiny_synthetic.yaml")


class _Stop(Exception):
    pass


def _constructor_kwargs(cls, cfg, **kw):
    """What ``cls.from_config(cfg)`` passes to the constructor."""
    seen = {}

    class Probe(cls):
        def __init__(self, **kwargs):
            seen.update(kwargs)
            raise _Stop

    with pytest.raises(_Stop):
        Probe.from_config(cfg, **kw)
    return seen


def _model_cfg(path, options=()):
    return (Config(cfg_path=str(REPO / path), options=list(options)).model_cfg,
            JaxConfig(cfg_path=str(REPO / path), options=list(options)).model_cfg)


PORT_KEYS = ("img_size", "vit_model", "t5_model", "tokenizer_path", "num_query_token",
             "num_beams", "min_new_tokens", "max_txt_len", "max_new_tokens",
             "input_time_format", "task", "num_frames_for_answer", "resample_frames",
             "relpos_in_kernel",
             "compute_dtype", "init_params", "vocab_size", "use_grad_checkpoint")


@pytest.mark.parametrize("path,options", [
    ("configs/projects/eval/qvh.yaml", ()),
    ("configs/projects/eval/charades_int8.yaml", ()),
    ("configs/projects/eval/anet.yaml", ()),
    ("configs/projects/train/tiny_synthetic.yaml", ()),
    ("configs/projects/eval/qvh.yaml", ("model.model_type=pretrain_flant5xxl",)),
    ("configs/projects/train/tiny_synthetic.yaml",
     ("model.min_new_tokens=3", "model.vocab_size=512", "model.relpos_in_kernel=True",
      "model.params_dtype=float32", "model.num_frames_for_answer=8",
      "model.input_time_format=relative_integers", "model.max_len=77",
      "model.tokenizer_path=mock", "model.scan_layers=False",
      "model.remat_policy=dots_kernels", "model.drop_path_rate=0.1")),
    ("configs/projects/train/tiny_synthetic.yaml", ("model.min_len=5", "model.min_new_tokens=3")),
    ("configs/projects/train/qvh.yaml", ()),
    ("configs/projects/eval/nextGQA.yaml", ()),
    ("configs/projects/eval/nextQA.yaml", ()),
])
def test_from_config_constructor_values_equal_jax(path, options):
    cfg, jcfg = _model_cfg(path, options)
    got = _constructor_kwargs(BLIP2_MR, cfg, device="cpu")
    want = _constructor_kwargs(JaxBLIP2_MR, jcfg)
    assert got.pop("device") == "cpu"
    assert set(got) == set(PORT_KEYS)
    assert {k: got[k] for k in PORT_KEYS} == {k: want[k] for k in PORT_KEYS}


@pytest.mark.parametrize("key,value,item", [
    ("interleave_data", False, "Variants of BLIP2_MR"),
    ("frame_token_aggregation", "mean", "Variants of BLIP2_MR"),
    ("freeze_vit", False, "The unfrozen-ViT train path"),
    ("fast_gelu", True, "Variants of BLIP2_MR"),
    ("sequence_parallel", True, "Parallelism"),
    ("int8_base", True, None),  # ported ("The rest of int8"): builds its layout
])
def test_from_config_unsupported_settings_raise(key, value, item):
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml")
    cfg[key] = value
    if item is None:
        model = BLIP2_MR.from_config(cfg, device="cpu")
        sd = model.state_dict()
        assert model.t5_config.int8_base and key in BLIP2_MR.SUPPORTED_CONFIG
        for dense in ("encoder.block.0.self_attention.q", "decoder.block.1.ff.wo",
                      "lm_head"):
            assert sd[f"t5.{dense}.kernel_q"].dtype == torch.int8
            assert f"t5.{dense}.weight" not in sd and f"t5.{dense}.lora_a" in sd
    else:
        with pytest.raises(NotImplementedError, match=f'ROADMAP Queue 1, "{item}"'):
            BLIP2_MR.from_config(cfg, device="cpu")
    assert set(BLIP2_MR.UNSUPPORTED_CONFIG) == {
        "interleave_data", "frame_token_aggregation", "freeze_vit", "fast_gelu",
        "sequence_parallel"}


@pytest.mark.parametrize("path", ["configs/projects/eval/nextGQA.yaml",
                                  "configs/projects/eval/nextQA.yaml"])
def test_from_config_builds_the_published_qa_configs(path):
    """``resample_frames: True`` (both published grounded-QA eval configs)
    reaches the constructor as the JAX one's does, and the model builds: at
    the published widths up to the constructor, at the tiny widths for real."""
    cfg, jcfg = _model_cfg(path)
    got = _constructor_kwargs(BLIP2_MR, cfg, device="cpu")
    want = _constructor_kwargs(JaxBLIP2_MR, jcfg)
    assert got["resample_frames"] is want["resample_frames"] is True
    assert got["task"] == want["task"] == "qformer_freeze_lora_QA_with_localizer"
    assert got["num_frames_for_answer"] == want["num_frames_for_answer"] == 60
    assert "resample_frames" in BLIP2_MR.SUPPORTED_CONFIG
    cfg, _ = _model_cfg(path, ("model.vit_model=tiny", "model.t5_model=tiny",
                               "model.image_size=28", "model.compute_dtype=float32",
                               "model.load_finetuned=False"))
    model = BLIP2_MR.from_config(cfg, device="cpu")
    assert model.resample_frames and model.use_localizer and model.is_qa
    assert model.num_frames_for_answer == 60


@pytest.mark.parametrize("path", ["configs/projects/train/qvh.yaml",
                                  "configs/projects/train/tiny_synthetic.yaml"])
def test_from_config_grad_checkpoint_equals_jax(path, monkeypatch):
    """``use_grad_checkpoint`` reaches the constructor as the JAX one's does
    (qvh.yaml sets it; the JAX default is False) and checkpoints every T5
    block of a train step (``T5Config.use_remat``)."""
    for value in (True, False, None):
        options = () if value is None else (f"model.use_grad_checkpoint={value}",)
        cfg, jcfg = _model_cfg(path, options)
        got = _constructor_kwargs(BLIP2_MR, cfg, device="cpu")["use_grad_checkpoint"]
        want = _constructor_kwargs(JaxBLIP2_MR, jcfg)["use_grad_checkpoint"]
        assert got == want == (value if value is not None else "qvh" in path)
    assert "use_grad_checkpoint" in BLIP2_MR.SUPPORTED_CONFIG
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml",
                        ("model.use_grad_checkpoint=True",))
    model = BLIP2_MR.from_config(cfg, device="cpu")
    assert model.t5_config.use_remat and model.module.t5.encoder.use_remat
    calls = []
    real = tt5.remat
    monkeypatch.setattr(tt5, "remat", lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    model.set_trainable()
    rng = np.random.default_rng(0)
    samples = {
        "video": rng.integers(0, 256, (1, 4, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.linspace(0, 20.0, 4, endpoint=False)[None],
        "duration": np.array([20.0]), "query_id": ["a"],
        "video_prompt_end": ["<extra_id_0>"], "query_prompt": ["Query: a cat\n"],
        "task_prompt": ["Relevant windows: "], "relevant_windows": ["[[0, 10]]"]}
    model(samples)["loss"].backward()
    t5 = model.module.t5
    assert calls == [*t5.encoder.block, *t5.decoder.block]


def test_from_config_reads_every_key_the_jax_one_reads(caplog):
    """Every key of the JAX ``from_config`` is supported, raises, or is
    declared without effect; an unknown key is logged, not dropped."""
    jax_keys = {"image_size", "vit_model", "t5_model", "tokenizer_path", "num_query_token",
                "num_beams", "min_len", "min_new_tokens", "max_len", "max_new_tokens",
                "input_time_format", "interleave_data", "frame_token_aggregation", "task",
                "num_frames_for_answer", "resample_frames", "freeze_vit", "drop_path_rate",
                "fast_gelu", "relpos_in_kernel", "use_grad_checkpoint", "remat_policy",
                "compute_dtype", "sequence_parallel", "vocab_size", "scan_layers",
                "params_dtype", "seed", "finetuned", "pretrained", "load_finetuned",
                "int8_inference", "int8_decode", "int8_vit", "int8_qformer", "int8_encoder",
                "int8_base"}
    port_keys = (set(BLIP2_MR.UNSUPPORTED_CONFIG) | set(BLIP2_MR.IGNORED_CONFIG)
                 | set(BLIP2_MR.SUPPORTED_CONFIG))
    assert jax_keys <= port_keys
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml",
                        ("model.no_such_key=1",))
    with caplog.at_level(logging.WARNING):
        _constructor_kwargs(BLIP2_MR, cfg, device="cpu")
    assert "model.no_such_key" in caplog.text


def _tiny_checkpoint(tmp_path):
    """A state dict of the tiny LoRA model with every tensor drawn from a
    numpy seed (the LoRA deltas nonzero), saved with torch.save."""
    model = BLIP2_MR(img_size=28, vit_model="tiny", t5_model="tiny", task="lora",
                     compute_dtype="float32", num_beams=2, max_new_tokens=12,
                     init_params=False, device="cpu")
    rng = np.random.default_rng(4)
    sd = {k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * 0.3).astype(np.float32))
          for k, v in model.state_dict().items()}
    path = tmp_path / "tiny.pt"
    torch.save(sd, path)
    return sd, path


@pytest.mark.parametrize("flags,methods", [
    (("model.int8_inference=True",), ("quantize_for_inference",)),
    (("model.int8_vit=True", "model.int8_decode=True"), ("quantize_for_decode", "quantize_vit")),
    (("model.int8_encoder=True", "model.int8_qformer=True"),
     ("quantize_qformer", "quantize_encoder")),
])
def test_from_config_quantizes_after_the_checkpoint_load(tmp_path, flags, methods):
    sd, path = _tiny_checkpoint(tmp_path)
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml",
                        (f"model.finetuned={path}", "model.load_finetuned=True") + flags)
    got = BLIP2_MR.from_config(cfg, device="cpu").state_dict()
    want = BLIP2_MR(img_size=28, vit_model="tiny", t5_model="tiny", task="lora",
                    compute_dtype="float32", num_beams=2, max_new_tokens=12,
                    init_params=False, device="cpu")
    want.load_state_dict(sd)
    for method in methods:  # the JAX package's order
        getattr(want, method)()
    want = want.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_from_config_checkpoints(tmp_path, caplog):
    sd, path = _tiny_checkpoint(tmp_path)
    base = ("model.params_dtype=float32",)
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml",
                        base + (f"model.pretrained={path}",))
    got = BLIP2_MR.from_config(cfg, device="cpu").state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    # params_dtype without a checkpoint: zeros, ones for 1-D tensors
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml", base)
    zero = BLIP2_MR.from_config(cfg, device="cpu").state_dict()
    assert all(bool((v == (1.0 if v.ndim == 1 else 0.0)).all()) for v in zero.values())
    # a missing file warns; load_finetuned=False skips the finetuned path
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml",
                        (f"model.finetuned={tmp_path / 'missing.pt'}",
                         "model.load_finetuned=True"))
    with caplog.at_level(logging.WARNING):
        BLIP2_MR.from_config(cfg, device="cpu")
    assert "not found" in caplog.text
    # a Flax msgpack file says how to convert it
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml",
                        ("model.finetuned=/ckpt/checkpoint_best.msgpack",
                         "model.load_finetuned=True"))
    with pytest.raises(ValueError, match="state_dict_from_jax"):
        BLIP2_MR.from_config(cfg, device="cpu")
    # a partial checkpoint loads non-strict: the rest keeps its values
    partial = {k: v for k, v in sd.items() if k.startswith("t5.")}
    partial["not_a_tensor_of_the_model"] = torch.zeros(3)
    torch.save(partial, tmp_path / "partial.pt")
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml",
                        base + (f"model.pretrained={tmp_path / 'partial.pt'}",))
    got = BLIP2_MR.from_config(cfg, device="cpu").state_dict()
    assert all(torch.equal(got[k], partial[k]) for k in partial if k in got)
    assert all(torch.equal(got[k], zero[k]) for k in got if not k.startswith("t5."))


def test_from_config_defaults_to_the_card():
    cfg, _ = _model_cfg("configs/projects/train/tiny_synthetic.yaml")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BLIP2_MR.from_config(cfg)


def test_flan_t5_xxl_config_equals_jax():
    got, want = tt5.t5_flan_xxl_config(), jt5.t5_flan_xxl_config()
    fields = set(tt5.T5Config.__dataclass_fields__)
    assert fields <= set(jt5.T5Config.__dataclass_fields__)
    for f in sorted(fields):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.d_model, got.d_ff, got.num_heads) == (4096, 10240, 64)
    assert BLIP2_MR.T5_CONFIGS["flan-t5-xxl"] is tt5.t5_flan_xxl_config
    cfg, _ = _model_cfg("configs/projects/eval/qvh.yaml", ("model.model_type=pretrain_flant5xxl",))
    assert cfg.t5_model == "flan-t5-xxl"
    assert BLIP2_MR.default_config_path("pretrain_flant5xxl").endswith(
        "configs/models/blip2/blip2_pretrain_flant5xxl.yaml")


# ----------------------------------------------------------- end to end
def _split_options(synth, out_dir):
    return [f"datasets.qvh.build_info.annotations.{s}.storage={synth}/{s}.json"
            for s in ("train", "val", "test")] + [
        f"run.output_dir={out_dir}", "run.evaluate=True", "run.num_workers=1",
        "run.batch_size_eval=2"]


def _rows(out_dir):
    (job,) = list(Path(out_dir).iterdir())
    return json.loads((job / "result" / "test_epochbest.json").read_text())


@pytest.fixture(scope="module")
def jax_evaluation(tmp_path_factory):
    """The JAX package's evaluation of the tiny synthetic config in this
    process (``evaluate.py``'s steps, its runner on one device as
    ``evaluate.py`` runs there), every weight redrawn from a numpy seed so
    the LoRA deltas count; returns its test logs, rows and the converted
    checkpoint."""
    root = tmp_path_factory.mktemp("e2e")
    make_mr_annotations(str(root / "synth"), n_train=2, n_val=2, n_test=6,
                        n_video_frames=40, fps=5.0, height=48, width=64)
    cfg = JaxConfig(cfg_path=TINY, options=_split_options(root / "synth", root / "jax"))
    task = jax_tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    rng = np.random.default_rng(21)
    flat = traverse_util.flatten_dict(
        jax.tree.map(np.asarray, unstack_blip2_mr_params(model.params)))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.3 * noise
    params = traverse_util.unflatten_dict(flat)
    model.params = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    ckpt = root / "converted.pt"
    torch.save(state_dict_from_jax(params), ckpt)

    class OneDevice(JaxRunnerBase):
        mesh = None  # evaluate.py's single-device run (no dp mesh)

    runner = OneDevice(cfg=cfg, job_id="job", task=task, model=model, datasets=datasets)
    logs = runner.evaluate(skip_reload=True)
    return {"root": root, "logs": logs, "rows": _rows(root / "jax"), "ckpt": ckpt}


def _port_argv(e2e, out_dir):
    return ["--cfg-path", TINY, "--options",
            *_split_options(e2e["root"] / "synth", out_dir), "run.device=cpu",
            f"model.finetuned={e2e['ckpt']}", "model.load_finetuned=True"]


def test_evaluate_identical_to_jax(jax_evaluation, tmp_path):
    e2e = jax_evaluation
    logs = evaluate.main(_port_argv(e2e, tmp_path / "port"))
    rows = _rows(tmp_path / "port")
    assert len(rows) == 6
    assert rows == e2e["rows"]
    assert {r["raw_prediction"] for r in rows} != {""}
    got = json.loads(json.dumps(logs, default=float))
    want = json.loads(json.dumps(e2e["logs"], default=float))
    assert got == want
    assert set(got["test"]) == {"agg_metrics", "r1", "mAP", "mIoU", "invalid_predictions",
                                "total"}
    assert got["test"]["total"] == 6


def test_evaluate_cli_writes_the_same_rows(jax_evaluation, tmp_path):
    """``python -m mr_blip_tpu_torch.evaluate`` as a user runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", "mr_blip_tpu_torch.evaluate",
         *_port_argv(jax_evaluation, tmp_path / "cli")],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _rows(tmp_path / "cli") == jax_evaluation["rows"]
    assert "agg_metrics" in proc.stderr


def test_evaluate_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    make_mr_annotations(str(tmp_path / "synth"), n_train=1, n_val=1, n_test=1,
                        n_video_frames=10, fps=5.0, height=32, width=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--cfg-path", TINY, "--options",
                       *_split_options(tmp_path / "synth", tmp_path / "out")])


def test_runner_reload_of_best_checkpoint_raises(tmp_path, caplog):
    """Once raising (the runner's checkpoints were not ported), the reload of
    the best checkpoint now restores its trainable tensors; without a best
    checkpoint it warns and keeps the weights."""
    sd, _ = _tiny_checkpoint(tmp_path)
    cfg = Config(cfg_path=TINY, options=[f"run.output_dir={tmp_path}", "run.device=cpu"])
    model = BLIP2_MR.from_config(cfg.model_cfg, device="cpu")
    runner_cls = registry.get_runner_class("runner_base")
    runner = runner_cls(cfg=cfg, job_id="j", task=None, model=model,
                        datasets={"qvh": {"test": []}})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        runner._reload_best_model()
    assert "no best checkpoint" in caplog.text
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    lora = {k: v for k, v in sd.items() if "lora_" in k}
    torch.save({"model": lora, "config": cfg.to_dict(), "epoch": 0},
               runner.output_dir / "checkpoint_best.pth")
    runner._reload_best_model()
    got = model.state_dict()
    assert all(torch.equal(got[k], lora[k]) for k in lora)
    assert all(torch.equal(got[k], before[k]) for k in got if k not in lora)
    runner.log_stats({"agg_metrics": 1.5}, "test")
    assert json.loads((tmp_path / "j" / "log.txt").read_text()) == {"test_agg_metrics": 1.5}
    assert isinstance(cfg.run_cfg, ConfigDict)


def test_generate_takes_frames_already_on_the_device(tmp_path):
    """Frames a PrefetchLoader put on the device are used as they are (no
    second copy) and give the spans numpy frames give."""
    sd, _ = _tiny_checkpoint(tmp_path)
    model = BLIP2_MR(img_size=28, vit_model="tiny", t5_model="tiny", task="lora",
                     compute_dtype="float32", num_beams=2, max_new_tokens=12,
                     init_params=False, device="cpu")
    model.load_state_dict(sd)
    rng = np.random.default_rng(0)
    samples = {
        "video": rng.integers(0, 256, (2, 4, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.stack([np.linspace(0, 20.0, 4, endpoint=False)] * 2),
        "duration": np.array([20.0, 20.0]), "query_id": ["a", "b"],
        "video_prompt_end": ["<extra_id_0>"] * 2,
        "query_prompt": ["Query: a cat jumps\n", "Query: a dog runs\n"],
        "task_prompt": ["Given the video and the query, find the relevant windows.\n"
                        "Relevant windows: "] * 2,
        "relevant_windows": ["[[0, 10]]", "[[5, 15]]"]}
    on_device = dict(samples, video=torch.from_numpy(samples["video"]))
    batch = model.prepare_mr_batch(on_device)
    assert batch["frames"] is on_device["video"]
    assert model._to_device(batch)["frames"] is on_device["video"]
    assert model.generate(on_device) == model.generate(samples)
