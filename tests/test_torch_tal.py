"""The port's temporal action localization against the JAX package's, on the
CPU: the detection metrics on random detections (identical), the task's
metric dict on the cases of ``tests/test_aux_components.py::TestTALMetrics``
(identical), the ``anet_TAL`` builder's items, a TAL train batch's loss
(1e-4), and ``python -m mr_blip_tpu_torch.evaluate`` on
``configs/projects/train/tiny_synthetic_tal.yaml`` against the JAX
package's evaluation on the same weights, converted: rows and the
``evaluate.txt`` metric dict identical.
"""

import json
import logging
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
from mr_blip_tpu.datasets import mr_datasets as jax_mr_datasets
from mr_blip_tpu.datasets.synthetic import make_tal_annotations as jax_make_tal
from mr_blip_tpu.metrics import span_ops as jax_span_ops
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.models.scan_utils import stack_blip2_mr_params, unstack_blip2_mr_params
from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
from mr_blip_tpu.tasks import temporal_action_localization as jax_tal
from mr_blip_tpu_torch import evaluate, tasks
from mr_blip_tpu_torch.common.config import Config
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets import mr_datasets
from mr_blip_tpu_torch.datasets.synthetic import make_tal_annotations
from mr_blip_tpu_torch.metrics import span_ops
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.tasks import temporal_action_localization as tal

REPO = Path(__file__).resolve().parent.parent
TINY_TAL = str(REPO / "configs/projects/train/tiny_synthetic_tal.yaml")
THRESHOLDS = np.linspace(0.5, 0.95, 10)


def _detections(seed, n_videos=6, labels=("run", "jump", "swim")):
    """Random ground truth and scored predictions over a few videos."""
    rng = np.random.default_rng(seed)
    targets, preds = [], []
    for v in range(n_videos):
        for _ in range(rng.integers(1, 4)):
            s = float(rng.uniform(0, 80))
            targets.append({"video-id": f"v{v}", "t-start": s,
                            "t-end": s + float(rng.uniform(1, 20)),
                            "label": str(rng.choice(labels))})
        for _ in range(rng.integers(0, 6)):
            s = float(rng.uniform(0, 80))
            preds.append({"video-id": f"v{v}", "t-start": s,
                          "t-end": s + float(rng.uniform(1, 20)),
                          "label": str(rng.choice(labels)),
                          "score": float(rng.uniform())})
    return targets, preds


@pytest.mark.parametrize("seed", range(6))
def test_topkx_recall_equals_jax(seed):
    targets, preds = _detections(seed)
    for top_k in ((1, 5), (1, 2, 3)):
        got = span_ops.compute_topkx_recall_detection(
            targets, preds, tiou_thresholds=THRESHOLDS, top_k=top_k)
        want = jax_span_ops.compute_topkx_recall_detection(
            targets, preds, tiou_thresholds=THRESHOLDS, top_k=top_k)
        np.testing.assert_array_equal(got, want)
    assert span_ops.compute_topkx_recall_detection(targets, []).shape == (10, 2)


@pytest.mark.parametrize("seed", range(6))
def test_anet_detection_eval_equals_jax(seed):
    targets, preds = _detections(seed)
    got = tal.anet_detection_eval(targets, preds, tiou_thresholds=THRESHOLDS)
    want = jax_tal.anet_detection_eval(targets, preds, tiou_thresholds=THRESHOLDS)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    empty = tal.anet_detection_eval([], preds)
    assert empty[1] == 0.0 and empty[2].shape == (10, 2)


# The cases of tests/test_aux_components.py::TestTALMetrics, and a classes
# file that does not exist.
REPORT_CASES = {
    "perfect": ([{"qid": "v1", "prediction": '[[0, 10, "run"]]', "target": '[[0, 10, "run"]]'},
                 {"qid": "v2", "prediction": '[[5, 9, "jump"]]', "target": '[[5, 9, "jump"]]'}],
                None),
    "wrong_class": ([{"qid": "v1", "prediction": '[[0, 10, "walk"]]',
                      "target": '[[0, 10, "run"]]'}], None),
    "mismatch": ([{"qid": "v1", "prediction": '[[0, 10, "moonwalk"]]',
                   "target": '[[0, 10, "run"]]'},
                  {"qid": "v2", "prediction": '[[5, 9, "run"]]', "target": '[[5, 9, "run"]]'}],
                 ["run", "jump"]),
    "invalid": ([{"qid": "v1", "prediction": "garbage", "target": '[[0, 10, "run"]]'},
                 {"qid": "v2", "prediction": '[[5, 9, "run"]]', "target": '[[5, 9, "run"]]'}],
                None),
    "recall_partial": ([{"qid": "v1", "prediction": '[[0, 10, "run"], [50, 60, "run"]]',
                         "target": '[[0, 10, "run"], [90, 99, "run"]]'}], None),
    "missing_classes_file": ([{"qid": "v1", "prediction": '[[0, 10, "moonwalk"]]',
                               "target": '[[0, 10, "run"]]'}], "missing"),
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_report_metrics_equals_jax(case, tmp_path, caplog):
    results, classes = REPORT_CASES[case]
    classes_path = None
    if classes == "missing":
        classes_path = str(tmp_path / "no_such_classes.txt")
    elif classes is not None:
        classes_path = str(tmp_path / "classes.txt")
        Path(classes_path).write_text("\n".join(classes))
    res = tmp_path / "res.json"
    res.write_text(json.dumps(results))
    metrics, lines = [], []
    for name, reg, task_cls in (("jax", jax_registry, jax_tal.TALTask),
                                ("port", registry, tal.TALTask)):
        out = tmp_path / name
        out.mkdir()
        reg.register_path("output_dir", str(out))
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            task = task_cls(classes_path=classes_path)
        if classes == "missing":
            assert "not found" in caplog.text and task.classes is None
        metrics.append(task._report_metrics(str(res), "val"))
        lines.append((out / "evaluate.txt").read_text())
    assert metrics[1] == metrics[0]
    assert lines[1] == lines[0]
    assert tal.MISMATCH_LABEL == jax_tal.MISMATCH_LABEL
    if case == "mismatch":
        assert metrics[1]["class_label_mismatch"] == 1
    if case == "perfect":
        assert metrics[1]["agg_metrics"] == pytest.approx(1.0)


def test_setup_task_reads_the_classes_path(tmp_path):
    (tmp_path / "classes.txt").write_text("run\njump")
    synth = make_tal_annotations(str(tmp_path / "s"), n_train=1, n_val=1, n_test=1)
    cfg = Config(cfg_path=TINY_TAL, options=[
        f"run.tal_classes_path={tmp_path / 'classes.txt'}",
        f"datasets.anet_TAL.build_info.annotations.train.storage={synth['train']}"])
    task = tasks.setup_task(cfg)
    assert isinstance(task, tal.TALTask) and task.classes == ["run", "jump"]
    assert registry.get_task_class("temporal_action_localization") is tal.TALTask


def test_builder_datasets_equal_jax(tmp_path):
    """The synthetic annotations are the JAX generator's, and the
    ``anet_TAL`` builder's datasets give the JAX builder's items."""
    paths = make_tal_annotations(str(tmp_path / "port"), n_train=3, n_val=2, n_test=2,
                                 n_video_frames=12, fps=4.0, height=32, width=48)
    jax_paths = jax_make_tal(str(tmp_path / "jax"), n_train=3, n_val=2, n_test=2,
                             n_video_frames=12, fps=4.0, height=32, width=48)
    for split in ("train", "val", "test"):
        assert Path(paths[split]).read_text() == Path(jax_paths[split]).read_text()
    assert mr_datasets.TAL_TASK_PROMPT == jax_mr_datasets.TAL_TASK_PROMPT
    options = [f"datasets.anet_TAL.build_info.annotations.{s}.storage={paths[s]}"
               for s in ("train", "val", "test")]
    built = []
    for config_cls, task_mod in ((JaxConfig, jax_tasks), (Config, tasks)):
        cfg = config_cls(cfg_path=TINY_TAL, options=options)
        built.append(task_mod.setup_task(cfg).build_datasets(cfg)["anet_TAL"])
    jax_sets, port_sets = built
    assert set(port_sets) == set(jax_sets) == {"train", "val", "test"}
    assert isinstance(port_sets["val"], mr_datasets.TemporalActionLocalizationDataset)
    for split in ("val", "test"):  # the eval processor draws nothing at random
        for i in range(len(jax_sets[split])):
            want, got = jax_sets[split][i], port_sets[split][i]
            assert got.keys() == want.keys()
            for key in want:
                if isinstance(want[key], np.ndarray):
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
                else:
                    assert got[key] == want[key], key
            assert got["task_prompt"] == mr_datasets.TAL_TASK_PROMPT
    queries = [port_sets["val"][i]["query_prompt"] for i in range(2)]
    assert "" in queries and any(q.startswith("Query: ") for q in queries)


def test_from_config_builds_blip2_mr_under_tal():
    """``eval/anet_TAL.yaml``'s model section reaches the constructor as the
    JAX one's does (published widths, not built), and builds at the tiny
    widths."""
    seen = []

    class Stop(Exception):
        pass

    def probe_init(self, **kwargs):
        seen.append(kwargs)
        raise Stop

    path = str(REPO / "configs/projects/eval/anet_TAL.yaml")
    for cls, config_cls in ((JaxBLIP2_MR, JaxConfig), (BLIP2_MR, Config)):
        probe = type("Probe", (cls,), {"__init__": probe_init})
        kw = {} if cls is JaxBLIP2_MR else {"device": "cpu"}
        with pytest.raises(Stop):
            probe.from_config(config_cls(cfg_path=path).model_cfg, **kw)
    want, got = seen
    assert got.pop("device") == "cpu"
    assert {k: got[k] for k in got} == {k: want[k] for k in got}
    assert got["task"] == "qformer_freeze_lora" and got["t5_model"] == "flan-t5-xl"
    cfg = Config(cfg_path=path, options=[
        "model.vit_model=tiny", "model.t5_model=tiny", "model.image_size=28",
        "model.compute_dtype=float32", "model.load_finetuned=False"]).model_cfg
    assert BLIP2_MR.from_config(cfg, device="cpu").task == "qformer_freeze_lora"


# ----------------------------------------------------------- end to end
def _split_options(synth, out_dir):
    return [f"datasets.anet_TAL.build_info.annotations.{s}.storage={synth}/{s}.json"
            for s in ("train", "val", "test")] + [
        f"run.output_dir={out_dir}", "run.evaluate=True", "run.num_workers=1",
        "run.batch_size_eval=2"]


def _job(out_dir):
    (job,) = list(Path(out_dir).iterdir())
    return job


@pytest.fixture(scope="module")
def jax_evaluation(tmp_path_factory):
    """The JAX package's evaluation of the tiny TAL config in this process
    (its runner on one device, as ``evaluate.py`` runs it), every weight
    redrawn from a numpy seed; returns its job directory, logs and the
    converted checkpoint."""
    root = tmp_path_factory.mktemp("tal_e2e")
    make_tal_annotations(str(root / "synth"), n_train=2, n_val=2, n_test=6,
                         n_video_frames=20, fps=5.0, height=48, width=64)
    cfg = JaxConfig(cfg_path=TINY_TAL, options=_split_options(root / "synth", root / "jax"))
    task = jax_tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    rng = np.random.default_rng(23)
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
    return {"root": root, "logs": logs, "job": _job(root / "jax"), "ckpt": ckpt,
            "model": model}


def test_evaluate_identical_to_jax(jax_evaluation, tmp_path):
    e2e = jax_evaluation
    logs = evaluate.main(["--cfg-path", TINY_TAL, "--options",
                          *_split_options(e2e["root"] / "synth", tmp_path / "port"),
                          "run.device=cpu", f"model.finetuned={e2e['ckpt']}",
                          "model.load_finetuned=True"])
    job, jax_job = _job(tmp_path / "port"), e2e["job"]
    rows = json.loads((job / "result/test_epochbest.json").read_text())
    assert len(rows) == 6
    assert rows == json.loads((jax_job / "result/test_epochbest.json").read_text())
    assert {r["raw_prediction"] for r in rows} != {""}
    assert (job / "evaluate.txt").read_text() == (jax_job / "evaluate.txt").read_text()
    got = json.loads(json.dumps(logs, default=float))
    assert got == json.loads(json.dumps(e2e["logs"], default=float))
    assert set(got["test"]) == {"agg_metrics", "r1", "mAP", "mIoU", "invalid_predictions",
                                "class_label_mismatch", "total"}


def test_tal_batch_loss_equals_jax(jax_evaluation):
    """A TAL train batch goes through the moment-retrieval span step: the
    same target ids and the same loss (1e-4) as the JAX model's."""
    e2e = jax_evaluation
    cfg = Config(cfg_path=TINY_TAL, options=_split_options(e2e["root"] / "synth", "/unused"))
    dataset = tasks.setup_task(cfg).build_datasets(cfg)["anet_TAL"]["val"]
    items = [dataset[i] for i in range(2)]
    samples = {k: [it[k] for it in items] for k in items[0]}
    samples["video"] = np.stack(samples["video"])
    samples["timestamps"] = np.stack(samples["timestamps"])
    samples["duration"] = np.asarray(samples["duration"])
    jm = e2e["model"]
    model = BLIP2_MR(img_size=28, vit_model="tiny", t5_model="tiny", task="lora",
                     compute_dtype="float32", init_params=False, device="cpu")
    model.load_state_dict(torch.load(e2e["ckpt"]))
    batch, jbatch = model.prepare_mr_batch(samples), jm.prepare_mr_batch(samples)
    np.testing.assert_array_equal(batch["target_ids"], jbatch["target_ids"])
    want = float(jm.forward(samples)["loss"])
    assert float(model.loss(batch)) == pytest.approx(want, abs=1e-4)
