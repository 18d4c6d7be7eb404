"""The port's grounded-QA evaluation entry point against the JAX package's, on
the CPU.

A tiny grounded config (task ``videogqa``, ``lora_QA_with_localizer``,
``resample_frames=True``, batch 2: the shape of
``configs/projects/eval/nextGQA.yaml`` at the tiny widths) is evaluated by
the JAX package (its runner, in this process, on one device as
``evaluate.py`` runs it) on weights redrawn from a numpy seed, and by
``mr_blip_tpu_torch.evaluate`` on the same weights, converted: the result
rows and the metrics must be identical, over ``synthetic://`` videos and over
encoded clips (``make_benchmark_clips``; skipped only where FFmpeg is absent).
So must the ``videoqa`` and ``frameqa`` rows, the pipelined task against a
serial ``valid_step``, and ``submit_window_redecodes``' moments and frames
against the JAX package's, for the localizer's strings and for the oracle's
windows.
"""

import json
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
from mr_blip_tpu.common.registry import registry as jax_registry
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
from mr_blip_tpu_torch import evaluate
from mr_blip_tpu_torch.common.config import Config
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets import synthetic
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax

# configs/projects/eval/nextGQA.yaml at the tiny widths, over the splits the
# fixture writes.
TINY_GQA = """\
model:
  arch: blip2_mr
  model_type: tiny
  vit_model: tiny
  image_size: 28
  t5_model: tiny
  task: lora_QA_with_localizer
  compute_dtype: float32
  num_beams: 2
  max_new_tokens: 8
  num_frames_for_answer: 2
  resample_frames: True
  scan_layers: False
  load_finetuned: False
datasets:
  nextgqa:
    vis_processor:
      train:
        name: blip2_video_train
        image_size: 28
        n_frms: 4
      eval:
        name: blip_video_eval
        image_size: 28
        n_frms: 4
    text_processor:
      train:
        name: blip_question
      eval:
        name: blip_question
    build_info:
      annotations:
        train:
          storage: {ann}
        val:
          storage: {ann}
        test:
          storage: {ann}
      videos:
        storage: {videos}
run:
  runner: runner_base
  task: videogqa
  batch_size_train: 2
  batch_size_eval: 2
  num_workers: 1
  seed: 42
  evaluate: True
  test_splits: ["test"]
  distributed: False
"""
N_QUESTIONS = 5  # two full batches and a ragged one


def _redraw(params, seed, std=0.3):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else std * noise
    return traverse_util.unflatten_dict(flat)


def _rows(out_dir):
    (job,) = list(Path(out_dir).iterdir())
    return json.loads((job / "result" / "test_epochbest.json").read_text())


def _write_config(root, ann, videos):
    path = root / "tiny_gqa.yaml"
    path.write_text(TINY_GQA.format(ann=ann, videos=videos))
    return str(path)


def _videos(kind, root):
    """(annotation file, videos storage) of N_QUESTIONS five-option grounded
    questions over ``synthetic://`` videos or over encoded clips."""
    if kind == "synthetic":
        paths = synthetic.make_qa_annotations(
            str(root / "synth"), n_train=0, n_val=0, n_test=N_QUESTIONS,
            n_video_frames=40, fps=5.0, height=48, width=64)
        return paths["test"], "synthetic"
    from tests.test_torch_video_reader import encoder_or_skip, native_readers

    native_readers()
    with encoder_or_skip("mpeg4"):
        clips = synthetic.make_benchmark_clips(
            str(root / "clips"), n_clips=2, seconds=6, fps=10.0, width=64, height=48,
            gop=8, codec="mpeg4")
    ann = synthetic.make_benchmark_qa_annotations(
        clips, str(root / "clips" / "qa.json"), n_queries=N_QUESTIONS)
    return ann, str(root / "clips")


@pytest.fixture(scope="module", params=["synthetic", "clips"])
def jax_evaluation(request, tmp_path_factory):
    """The JAX package's evaluation of the tiny grounded config, every weight
    of both parameter trees redrawn from a numpy seed; its test logs, rows,
    model and loader, and the converted checkpoint."""
    root = tmp_path_factory.mktemp(f"gqa_{request.param}")
    ann, videos = _videos(request.param, root)
    cfg_path = _write_config(root, ann, videos)
    cfg = JaxConfig(cfg_path=cfg_path, options=[f"run.output_dir={root / 'jax'}"])
    task = jax_tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    assert model.resample_frames and model.use_localizer
    params = _redraw(model.params, 21)
    answerer = _redraw(model.answerer_params, 22)
    model.params = jax.tree.map(jnp.asarray, params)
    model.answerer_params = jax.tree.map(jnp.asarray, answerer)
    ckpt = root / "converted.pt"
    torch.save(state_dict_from_jax(params, answerer), ckpt)

    class OneDevice(JaxRunnerBase):
        mesh = None  # evaluate.py's single-device run (no dp mesh)

    runner = OneDevice(cfg=cfg, job_id="job", task=task, model=model, datasets=datasets)
    logs = runner.evaluate(skip_reload=True)
    return {"root": root, "cfg": cfg_path, "logs": logs, "rows": _rows(root / "jax"),
            "ckpt": ckpt, "model": model, "runner": runner, "kind": request.param}


def _port_argv(e2e, out_dir, *options):
    return ["--cfg-path", e2e["cfg"], "--options", f"run.output_dir={out_dir}",
            "run.device=cpu", f"model.finetuned={e2e['ckpt']}", "model.load_finetuned=True",
            *options]


def _plain(obj):
    return json.loads(json.dumps(obj, default=float))


def _f32(rows):
    """The rows with each GT window and duration rounded to float32: the JAX
    package's evaluation loader puts every numeric array on the device
    (``jax.device_put``, 32-bit), so its rows hold the float32 values of the
    annotations; the port, like the reference's torch collate, keeps them as
    read."""
    def r32(x):
        return float(np.float32(x))

    return [dict(r, relevant_moments_gt=[[r32(x) for x in w]
                                         for w in r["relevant_moments_gt"]],
                 duration=r32(r["duration"])) if "duration" in r else r for r in rows]


def test_grounded_qa_evaluation_identical_to_jax(jax_evaluation, tmp_path):
    """Rows identical but for the GT windows' float32 rounding in the JAX
    loader (``_f32``); the metrics identical on those rows, and within 1e-6
    relative (the rounding) on the port's own."""
    e2e = jax_evaluation
    logs = evaluate.main(_port_argv(e2e, tmp_path / "port"))
    rows = _rows(tmp_path / "port")
    assert len(rows) == N_QUESTIONS
    assert _f32(rows) == e2e["rows"]
    metrics, want = _plain(logs)["test"], _plain(e2e["logs"])["test"]
    for key in ("Acc@GQA", "mIoP", "TIoP@0.3", "TIoP@0.5", "mIoU", "TIoU@0.3",
                "TIoU@0.5", "agg_metrics", "total"):
        assert key in metrics, key
    assert list(metrics) == list(want)
    assert metrics == pytest.approx(want, rel=1e-6, abs=0)
    assert metrics["total"] == N_QUESTIONS
    for r in rows:
        assert set(r) == {"qid", "prediction", "target", "frame_idx", "relevant_moments",
                          "relevant_moments_gt", "duration"}
        (start, end), = r["relevant_moments"]
        assert 0 <= start <= end <= round(r["duration"])
    # evaluate.txt holds the metrics line, as the JAX task writes it
    (job,) = list((tmp_path / "port").iterdir())
    line = json.loads((job / "evaluate.txt").read_text().splitlines()[-1])
    assert line == {"test": metrics}
    # The port's metrics of the JAX package's float32 rows are the JAX ones.
    rows32 = tmp_path / "rows32.json"
    rows32.write_text(json.dumps(_f32(rows)))
    task = registry.get_task_class("videogqa")()
    assert _plain(task._report_metrics(str(rows32), "test")) == want


def test_saved_rows_hold_plain_numbers(jax_evaluation):
    """The task's rows serialize without a ``default``, as the JAX task's
    do: every moment, GT window and duration is a Python number."""
    e2e = jax_evaluation
    cfg, model = _port_model(e2e)
    rows = registry.get_task_class("videogqa")().evaluation(model, _port_loader(e2e, cfg))
    assert _f32(json.loads(json.dumps(rows))) == e2e["rows"]
    for r in rows:
        assert all(type(x) in (int, float) for x in r["relevant_moments"][0])
        assert all(type(x) in (int, float) for w in r["relevant_moments_gt"] for x in w)
        assert type(r["duration"]) is float


@pytest.mark.parametrize("task_name", ["videoqa", "frameqa"])
def test_videoqa_and_frameqa_rows_identical_to_jax(jax_evaluation, tmp_path, task_name):
    e2e = jax_evaluation
    jtask = jax_registry.get_task_class(task_name)()
    want = _plain(jtask.evaluation(e2e["model"], e2e["runner"].dataloaders["test"]))
    logs = evaluate.main(_port_argv(e2e, tmp_path / task_name, f"run.task={task_name}"))
    assert _rows(tmp_path / task_name) == want
    assert set(want[0]) == {"qid", "prediction", "target", "frame_idx"}
    assert logs["test"]["total"] == N_QUESTIONS
    assert "mIoU" not in logs["test"]


def _port_model(e2e):
    cfg = Config(cfg_path=e2e["cfg"], options=["run.device=cpu",
                                              f"model.finetuned={e2e['ckpt']}",
                                              "model.load_finetuned=True"])
    model = BLIP2_MR.from_config(cfg.model_cfg, device="cpu")
    assert model.resample_frames
    return cfg, model


def _port_loader(e2e, cfg):
    from mr_blip_tpu_torch import tasks

    task = tasks.setup_task(cfg)
    runner = registry.get_runner_class("runner_base")(
        cfg=cfg, job_id="j", task=task, model=None, datasets=task.build_datasets(cfg))
    return runner.dataloaders["test"]


def test_pipelined_task_equals_serial_valid_step(jax_evaluation):
    """The one-deep pipeline (batch i's re-decode and answerer after batch
    i+1's localizer is dispatched) gives a serial ``valid_step``'s rows."""
    e2e = jax_evaluation
    cfg, model = _port_model(e2e)
    loader = _port_loader(e2e, cfg)
    task = registry.get_task_class("videogqa")()
    piped = task.evaluation(model, loader)
    serial = []
    for i, samples in enumerate(loader):
        serial.extend(task.valid_step(model, dict(samples, iters=i)))
    assert len(piped) == len(serial) == N_QUESTIONS
    assert piped == serial
    assert _f32(_plain(piped)) == e2e["rows"]


def _batch(e2e, cfg):
    return dict(next(iter(_port_loader(e2e, cfg))))


@pytest.mark.parametrize("moments", [
    ["[[-1, -1]]", "[[-1, -1]]"],            # no valid span: the whole video
    ["[[1, 3]]", "[[2, 500]]"],              # an end past the duration
    ["[[4, 2]]", "[[0.5, 1.5], [3, 4]]"],    # start >= end; the first window
])
def test_window_redecodes_equal_jax_for_localizer_strings(jax_evaluation, moments):
    e2e = jax_evaluation
    cfg, model = _port_model(e2e)
    samples = _batch(e2e, cfg)
    jm = e2e["model"]
    want_m, want_f = jm.get_relevant_frames_resampled(samples, moments, 3)
    got_m, pending = model.submit_window_redecodes(samples, moments, 3)
    got_f = model.collect_window_redecodes(pending)
    assert got_m == want_m
    assert got_f.dtype == np.uint8 and want_f.dtype == np.uint8
    assert got_f.shape == (2, 3, 28, 28, 3)
    np.testing.assert_array_equal(got_f, want_f)
    assert model.get_relevant_frames_resampled(samples, moments, 3)[0] == want_m


def test_window_redecodes_equal_jax_for_oracle_windows(jax_evaluation):
    """The oracle localizer's path: the GT's first windows, re-decoded, and
    the whole videoQA_generate under ``lora_QA_oracle_localizer``."""
    e2e = jax_evaluation
    cfg, model = _port_model(e2e)
    samples = _batch(e2e, cfg)
    windows = [list(m[0]) for m in np.asarray(samples["relevant_windows"])]
    jm = e2e["model"]
    want_m, want_f = jm.get_relevant_frames_resampled(samples, windows, 2)
    got_m, got_f = model.get_relevant_frames_resampled(samples, windows, 2)
    assert got_m == want_m
    np.testing.assert_array_equal(got_f, want_f)
    # The oracle task end to end, both packages on the same weights.
    kw = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=2,
              max_new_tokens=8, compute_dtype="float32", num_frames_for_answer=2,
              resample_frames=True, task="lora_QA_oracle_localizer")
    joracle = JaxBLIP2_MR(**kw, scan_layers=False, init_params=False)
    joracle.params, joracle.answerer_params = jm.params, jm.answerer_params
    oracle = BLIP2_MR(**kw, init_params=False, device="cpu")
    oracle.load_state_dict(model.state_dict())
    want = joracle.videoQA_generate(samples)
    got = oracle.videoQA_generate(samples)
    assert got["output_text"] == want["output_text"]
    assert _plain(got["relevant_moments"]) == _plain(want["relevant_moments"])


def test_answerer_gets_the_redecoded_frames(jax_evaluation):
    """Under ``resample_frames`` the answerer's frames are the reader's
    re-decode of the localizer's windows, not a crop of the batch's frames."""
    e2e = jax_evaluation
    cfg, model = _port_model(e2e)
    samples = _batch(e2e, cfg)
    handle = model.videoQA_redecode(model.videoQA_dispatch(samples))
    assert "pending" in handle and "frames" not in handle
    out = model.videoQA_collect(handle)
    _, want = model.get_relevant_frames_resampled(samples, handle["moments"], 2)
    np.testing.assert_array_equal(handle["frames"], want)
    assert out["relevant_moments"] == [handle["moments"]]
