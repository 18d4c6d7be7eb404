"""The port's train entry point against the JAX package's, on the CPU.

The preemption guard, the tracker's JSONL, the runner's checkpoints and
resume (``tests/test_preemption.py``, ``test_checkpointing.py`` and
``test_runner_iter.py`` on the port), gradient checkpointing with dropout
on, and a whole run of ``configs/projects/train/tiny_synthetic.yaml``: the
JAX package's runner in this process (one device, as ``train.py`` runs
there; dropout off) against ``mr_blip_tpu_torch.train.main`` on the JAX
model's weights, converted (dropout rates 0): per-iteration losses within
1e-4, the validation rows and metrics identical, the final trainable tensors
within 1e-3 (after 6 AdamW updates: a near-zero gradient's update is
lr·g/(|g| + eps), so float noise moves it by up to ~lr), the checkpoint
files by the same names.
"""

import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

import mr_blip_tpu  # noqa: F401
import mr_blip_tpu_torch  # noqa: F401
from mr_blip_tpu import tasks as jax_tasks
from mr_blip_tpu.common import tracking as jtracking
from mr_blip_tpu.common.config import Config as JaxConfig
from mr_blip_tpu.models.scan_utils import stack_blip2_mr_params, unstack_blip2_mr_params
from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
from mr_blip_tpu.runners.train_state import make_train_step
from mr_blip_tpu_torch import tasks, train
from mr_blip_tpu_torch.common import preempt, tracking
from mr_blip_tpu_torch.common.config import Config
from mr_blip_tpu_torch.common.optims import LinearWarmupCosineLRScheduler
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
from mr_blip_tpu_torch.models import t5 as tt5
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.models.layers import Dropout
from mr_blip_tpu_torch.runners.runner_base import RunnerBase
from mr_blip_tpu_torch.runners.train_state import TrainCtx
from mr_blip_tpu_torch.tasks.moment_retrieval import MomentRetrievalTask

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs/projects/train/tiny_synthetic.yaml")
TINY_MODEL = dict(img_size=28, vit_model="tiny", t5_model="tiny", task="lora",
                  num_beams=1, max_new_tokens=4, compute_dtype="float32")


def _samples(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "video": rng.integers(0, 256, (b, 3, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.tile(np.array([0.0, 10.0, 20.0]), (b, 1)),
        "duration": np.full((b,), 30.0),
        "query_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": ["Query: something happens\n"] * b,
        "task_prompt": ["Relevant windows: "] * b,
        "relevant_windows": ["[[0, 10]]", "[[5, 25]]", "[[1, 2]]", "[[0, 30]]"][:b],
    }


def _with_dropout(model, rate):
    for m in model.module.modules():
        if isinstance(m, Dropout):
            m.rate = rate
    return model


def _split_options(synth):
    return [f"datasets.qvh.build_info.annotations.{s}.storage={synth}/{s}.json"
            for s in ("train", "val", "test")]


# ------------------------------------------------------------------ guard
class TestPreemptionGuard:
    def test_sigterm_sets_flag_and_chains(self):
        seen = []
        prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
        try:
            g = preempt.PreemptionGuard().install()
            assert not g.requested_locally()
            os.kill(os.getpid(), signal.SIGTERM)
            assert g.requested_locally()
            # single-process should_stop ignores sync cadence
            assert g.should_stop(step=0) and g.should_stop(step=3)
            # previous Python-level handler still ran (chained)
            assert seen == [signal.SIGTERM]
            g.uninstall()
            # uninstall restored our lambda
            os.kill(os.getpid(), signal.SIGTERM)
            assert seen == [signal.SIGTERM, signal.SIGTERM]
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_request_programmatic(self):
        g = preempt.PreemptionGuard()  # not installed: no signal handler needed
        assert not g.should_stop(step=0)
        g.request()
        assert g.should_stop(step=0)

    def test_install_and_uninstall_guard(self):
        prev = signal.getsignal(signal.SIGTERM)
        g = preempt.install_guard(sync_every=3)
        try:
            assert preempt.get_guard() is g and g.sync_every == 3
            assert preempt.install_guard() is g  # idempotent
            assert signal.getsignal(signal.SIGTERM) is not prev
        finally:
            preempt.uninstall_guard()
        assert preempt.get_guard() is None
        assert signal.getsignal(signal.SIGTERM) is prev

    def test_inner_loop_raises_at_step_boundary(self):
        """A requested guard stops the real train loop mid-epoch, after the
        step: the micro-batch's gradient is accumulated, no update taken."""
        preempt._guard = preempt.PreemptionGuard()  # no handler install
        try:
            model = BLIP2_MR(**TINY_MODEL, device="cpu")
            ctx = TrainCtx(model, accum_grad_iters=2)
            sched = LinearWarmupCosineLRScheduler(
                max_epoch=1, min_lr=1e-5, init_lr=1e-4, warmup_steps=2)

            def batches():
                seed = 0
                while True:
                    yield _samples(b=1, seed=seed)
                    seed += 1

            preempt._guard.request()  # stop after step 0
            with pytest.raises(preempt.TrainingPreempted) as ei:
                MomentRetrievalTask()._train_inner_loop(
                    epoch=0, iters_per_epoch=100, model=model,
                    data_loader=batches(), train_ctx=ctx, lr_scheduler=sched,
                    log_freq=1000)
            assert ei.value.inner_iter == 0  # first step boundary
            assert (ctx.calls, ctx.updates) == (1, 0)
            assert all(p.grad is not None for p in ctx.params)
        finally:
            preempt._guard = None


# ---------------------------------------------------------------- tracker
def test_tracker_jsonl_matches_jax(tmp_path, monkeypatch):
    """The same calls write the JAX tracker's events, timestamps aside; a
    disabled tracker leaves none behind."""
    monkeypatch.delenv("WANDB_MODE", raising=False)
    events = []
    for mod, out in ((jtracking, tmp_path / "jax"), (tracking, tmp_path / "port")):
        tracker = mod.init(project="p", name="n", config={"run": {"seed": 1}},
                           out_dir=str(out))
        assert mod.get() is tracker
        tracker.log({"train/loss": 1.5, "train/lr": 1e-4})
        tracker.log({"eval/agg_metrics": 0.25}, step=7)
        tracker.log({"train/loss": 1.25})
        tracker.log_table("samples", ["qid", "pred"], [["q0", "[[0, 1]]"]])
        tracker.finish()
        lines = [json.loads(line) for line in (out / "events.jsonl").read_text().splitlines()]
        assert all(isinstance(e.pop("ts"), float) for e in lines)
        events.append(lines)
    assert events[0] == events[1]
    assert [e["type"] for e in events[1]] == ["config", "metrics", "metrics", "metrics",
                                            "table", "finish"]
    assert [e.get("step") for e in events[1][1:4]] == [1, 7, 8]
    assert tracking.init(project="p", name="n", out_dir=str(tmp_path / "off"),
                         enabled=False) is None
    assert tracking.get() is None


def test_train_step_logs_the_sample_table(tmp_path):
    """Every ``log_samples_every_n``-th step (never step 0) the MR task logs a
    ``Samples_during_training`` table of the model's generate on the batch,
    as the JAX task does."""
    model = BLIP2_MR(**TINY_MODEL, device="cpu")
    ctx = TrainCtx(model)
    ctx.set_lr(1e-4)
    task = MomentRetrievalTask(log_samples_every_n=2)
    tracking.init(project="p", name="n", out_dir=str(tmp_path))
    try:
        for i in range(3):
            loss = task.train_step(ctx, dict(_samples(seed=i), iters=i))
            assert np.isfinite(loss)
    finally:
        tracking.init(project="p", name="n", enabled=False)
    tables = [e for e in map(json.loads, (tmp_path / "events.jsonl").read_text().splitlines())
              if e["type"] == "table"]
    assert len(tables) == 1 and tables[0]["key"] == "Samples_during_training"
    assert tables[0]["columns"] == ["qid", "pred", "processed_pred", "answer", "duration"]
    assert [row[0] for row in tables[0]["rows"]] == ["q0", "q1"]
    assert ctx.calls == 3


# ---------------------------------------------------------- checkpointing
def _runner(tmp_path, job_id="ckpt_test", options=()):
    data = tmp_path / "data"
    if not data.exists():
        make_mr_annotations(str(data), n_train=4, n_val=2, n_test=2,
                            n_video_frames=10, fps=5.0, height=48, width=64)
    cfg = Config(cfg_path=TINY, options=[
        *_split_options(data), f"run.output_dir={tmp_path}/out", "run.num_workers=1",
        "run.batch_size_train=2", "run.batch_size_eval=2", "run.device=cpu", *options])
    task = tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    runner_cls = registry.get_runner_class(cfg.run_cfg.get("runner", "runner_base"))
    return runner_cls(cfg=cfg, job_id=job_id, task=task, model=model, datasets=datasets)


@pytest.fixture()
def runner(tmp_path):
    return _runner(tmp_path)


def _train_steps(runner, n, lr=1e-3, seed=0):
    ctx = runner.train_ctx
    ctx.set_lr(lr)
    for i in range(n):
        runner.task.train_step(ctx, _samples(b=2, seed=seed + i))


class TestCheckpointing:
    def test_save_and_reload_best_roundtrip(self, runner):
        _train_steps(runner, 1)
        runner._save_checkpoint(cur_epoch=0, is_best=True)
        assert (runner.output_dir / "checkpoint_best.pth").exists()
        params = dict(runner.model.module.named_parameters())
        lora = {n: p.detach().clone() for n, p in params.items() if "lora_a" in n}
        with torch.no_grad():
            for n in lora:
                params[n].add_(1.0)
        runner._reload_best_model()
        for n, want in lora.items():
            assert torch.equal(params[n], want), n
        # evaluate(cur_epoch="best") reloads it and evaluates
        logs = runner.evaluate(cur_epoch="best")
        assert logs["test"]["total"] == 2

    def test_trainable_only_checkpoint_holds_the_trainable_names(self, runner):
        _ = runner.train_ctx
        runner._save_checkpoint(cur_epoch=0, is_best=False)
        ckpt = torch.load(runner.output_dir / "checkpoint_0.pth", weights_only=True)
        mask = runner.model.trainable_mask()
        assert set(ckpt["model"]) == {n for n, m in mask.items() if m}
        assert ckpt["epoch"] == 0 and ckpt["config"] == runner.config.to_dict()
        params = dict(runner.model.module.named_parameters())
        assert all(torch.equal(v, params[n].detach()) for n, v in ckpt["model"].items())
        resume = runner.output_dir / "resume_state.pth"
        # trainable-only ckpt strips the frozen ViT / T5 base: much smaller
        assert (runner.output_dir / "checkpoint_0.pth").stat().st_size < resume.stat().st_size / 2
        assert not list(runner.output_dir.glob("*.tmp"))

    @pytest.mark.parametrize("complete,start", [(True, 4), (False, 3)])
    def test_resume_sets_start_epoch(self, runner, complete, start):
        _ = runner.train_ctx
        runner._write_resume_state(3, epoch_complete=complete)
        runner.load_checkpoint(str(runner.output_dir / "resume_state.pth"))
        assert runner.start_epoch == start

    def test_resume_restores_the_train_state(self, runner, tmp_path):
        """Two updates and one micro-batch of a third window, saved; a fresh
        runner over other weights loads it: every weight, the AdamW moments
        and step, the counters and the partial gradients come back bit for
        bit."""
        runner.run_cfg["accum_grad_iters"] = 2
        _train_steps(runner, 5)
        ctx = runner.train_ctx
        assert (ctx.calls, ctx.updates) == (5, 2)
        path = runner._write_resume_state(0, epoch_complete=False)
        saved = {k: v.clone() for k, v in runner.model.state_dict().items()}

        fresh = _runner(tmp_path, job_id="fresh", options=["run.accum_grad_iters=2"])
        fresh.model.init_params(seed=7)
        fresh.load_checkpoint(path)
        assert fresh.start_epoch == 0
        got = fresh.model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in saved.items())
        fctx = fresh.train_ctx
        assert (fctx.calls, fctx.updates) == (5, 2)
        for n, p in ctx.named_params.items():
            assert torch.equal(fctx.named_params[n].grad, p.grad), n
        want, have = ctx.optimizer.state_dict(), fctx.optimizer.state_dict()
        assert want["param_groups"] == have["param_groups"]
        nonzero = 0
        for i, st in want["state"].items():
            for key, v in st.items():
                assert torch.equal(have["state"][i][key], v), (i, key)
                nonzero += bool((v != 0).any())
        assert nonzero > 0  # the moments carried data

    def test_resume_mid_window_takes_the_uninterrupted_step(self, tmp_path):
        """Dropout on, accum_grad_iters 4: three micro-batches, the resume
        state, a fresh runner loading it, the fourth micro-batch (the update)
        give bit-equal weights to four uninterrupted micro-batches. The fresh
        run draws the masks the uninterrupted one draws only if ``calls``
        came back (the dropout stream is seeded by the call index)."""
        def prepared(job_id):
            r = _runner(tmp_path, job_id=job_id, options=["run.accum_grad_iters=4"])
            _with_dropout(r.model, 0.3)
            return r

        whole = prepared("whole")
        _train_steps(whole, 4)
        assert whole.train_ctx.updates == 1

        cut = prepared("cut")
        _train_steps(cut, 3)
        path = cut._write_resume_state(0, epoch_complete=False)
        resumed = prepared("resumed")
        resumed.model.init_params(seed=11)
        resumed.load_checkpoint(path)
        _train_steps(resumed, 1, seed=3)
        assert (resumed.train_ctx.calls, resumed.train_ctx.updates) == (4, 1)
        want, got = whole.model.state_dict(), resumed.model.state_dict()
        moved = 0
        for k, v in want.items():
            assert torch.equal(got[k], v), k
            moved += "lora_" in k and not torch.equal(v, cut.model.state_dict()[k])
        assert moved  # the update happened in both

    def test_use_orbax_raises(self, tmp_path):
        with pytest.raises(ValueError, match="torch.save"):
            _runner(tmp_path, options=["run.use_orbax=True"])


# ------------------------------------------------------------ runner_iter
class TestRunnerIter:
    OPTIONS = ("run.runner=runner_iter", "run.wandb=False")

    def test_non_divisible_max_iters_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="not a multiple"):
            _runner(tmp_path, options=[*self.OPTIONS, "run.max_iters=5",
                                       "run.iters_per_inner_epoch=2"])

    def test_iteration_keyed_checkpoints(self, tmp_path):
        runner = _runner(tmp_path, options=[*self.OPTIONS, "run.max_iters=4",
                                            "run.iters_per_inner_epoch=2"])
        assert runner.max_epoch == 2
        runner.train()
        out = runner.output_dir
        log_lines = []
        for line in (out / "log.txt").read_text().splitlines():
            try:
                log_lines.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # log_config writes the config as indented JSON
        val_logs = [line for line in log_lines
                    if isinstance(line, dict) and any(k.startswith("val_") for k in line)]
        assert val_logs and "val_best_iters" in val_logs[-1]
        # val result files carry the iteration-keyed progress string
        results = list((out / "result").glob("val_*iters=*.json"))
        assert results, list((out / "result").iterdir())
        assert runner.train_ctx.updates == 4

    def test_checkpoints_keyed_by_iters_without_val(self, tmp_path):
        """No valid split -> checkpoint per inner epoch named by the global
        iteration count (reference runner_iter.py:121-124)."""
        runner = _runner(tmp_path, options=[*self.OPTIONS, "run.max_iters=4",
                                            "run.iters_per_inner_epoch=2"])
        runner.run_cfg["valid_splits"] = []
        runner.run_cfg["test_splits"] = []
        runner.train()
        out = runner.output_dir
        assert (out / "checkpoint_2.pth").exists()
        assert (out / "checkpoint_4.pth").exists()


# --------------------------------------------------- gradient checkpointing
def _remat_step(remat, accum=2):
    model = _with_dropout(BLIP2_MR(**TINY_MODEL, device="cpu", seed=3,
                                   use_grad_checkpoint=remat), 0.3)
    ctx = TrainCtx(model, accum_grad_iters=accum, seed=0)
    ctx.set_lr(1e-3)
    loss = ctx.step(model.prepare_mr_batch(_samples(seed=4)))
    return loss, {n: p.grad.clone() for n, p in ctx.named_params.items()}, model


def test_grad_checkpoint_step_equals_the_plain_step():
    """With every dropout at 0.3 (LoRA, FFN, residual branches), the step
    with every T5 block checkpointed gives the loss and the gradients of the
    step without, within 1e-6; a recompute that let the dropout generator
    run on (``checkpoint`` alone) does not."""
    loss, grads, _ = _remat_step(False)
    loss_r, grads_r, model = _remat_step(True)
    t5 = model.module.t5
    assert t5.encoder.use_remat and t5.decoder.use_remat
    assert abs(loss_r - loss) <= 1e-6 * abs(loss)
    for n, g in grads.items():
        np.testing.assert_allclose(grads_r[n].numpy(), g.numpy(), atol=1e-6, err_msg=n)


def test_grad_checkpoint_without_the_generator_replay_differs(monkeypatch):
    from torch.utils.checkpoint import checkpoint

    calls = []

    def no_replay(module, *args, **kwargs):
        calls.append(module)
        return checkpoint(module, *args, use_reentrant=False, **kwargs)

    _, grads, _ = _remat_step(False)
    monkeypatch.setattr(tt5, "remat", no_replay)
    _, grads_r, model = _remat_step(True)
    cfg = model.t5_config
    assert len(calls) == cfg.num_layers + cfg.num_decoder_layers
    assert max(float((grads_r[n] - g).abs().max()) for n, g in grads.items()) > 1e-4


def test_grad_checkpoint_only_under_grad():
    """Generate (inference mode) and a no-grad forward never checkpoint."""
    model = BLIP2_MR(**TINY_MODEL, device="cpu", use_grad_checkpoint=True)
    calls = []
    real = tt5.remat
    try:
        tt5.remat = lambda *a, **k: calls.append(1) or real(*a, **k)
        model.generate(_samples())
        # the bias generate cached is no inference tensor: a step saves it
        assert not any(b.is_inference() for b in model._enc_bias_cache.values())
        with torch.no_grad():
            model.loss(model.prepare_mr_batch(_samples()))
        assert not calls
        model.loss(model.prepare_mr_batch(_samples()))
        assert len(calls) == 4  # 2 encoder + 2 decoder blocks
    finally:
        tt5.remat = real


# ------------------------------------------------------- whole-run parity
def _run_options(synth, out_dir):
    return [*_split_options(synth), f"run.output_dir={out_dir}", "run.num_workers=1",
            "run.batch_size_train=8", "run.batch_size_eval=2", "run.max_epoch=2"]


class _OneDevice(JaxRunnerBase):
    mesh = None  # train.py's run on one device (no dp mesh, no padded rows)


def _events(out_dir):
    (job,) = [p for p in Path(out_dir).iterdir() if p.is_dir()]
    lines = [json.loads(line) for line in (job / "events.jsonl").read_text().splitlines()]
    return job, lines


def _val_logs(job):
    logs = []
    for line in (job / "log.txt").read_text().splitlines():
        try:
            entry = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(entry, dict) and "val_agg_metrics" in entry:
            logs.append(entry)
    return logs


@pytest.fixture(scope="module")
def jax_training(tmp_path_factory):
    """The JAX package's training of the tiny synthetic config in this
    process (``train.py``'s steps on one device, its runner's ``train()``:
    2 epochs of 3 updates on batches of 8, validation each epoch, the test
    split at the end), every weight redrawn from a numpy seed so the LoRA
    deltas count, dropout off; returns its output directory, its runner and
    the converted checkpoint. The weights are drawn at N(0, 0.1), the scale
    of ``test_torch_train.py``: at N(0, 0.3) (the evaluation test's) the tiny
    model is chaotic, the first step's ~1e-6 of float noise flips AdamW's
    sign on near-zero gradients (2·lr each) and the losses part by 0.05
    within 6 updates on either side of any port."""
    root = tmp_path_factory.mktemp("train_e2e")
    make_mr_annotations(str(root / "synth"), n_train=24, n_val=2, n_test=2,
                        n_video_frames=20, fps=5.0, height=48, width=64)
    cfg = JaxConfig(cfg_path=TINY, options=_run_options(root / "synth", root / "jax"))
    random.seed(42)  # train.py's setup_seeds, in train.py's order
    np.random.seed(42)
    task = jax_tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    rng = np.random.default_rng(31)
    flat = traverse_util.flatten_dict(
        jax.tree.map(np.asarray, unstack_blip2_mr_params(model.params)))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.1 * noise
    params = traverse_util.unflatten_dict(flat)
    model.params = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    ckpt = root / "converted.pt"
    torch.save(state_dict_from_jax(params), ckpt)

    runner = _OneDevice(cfg=cfg, job_id="job", task=task, model=model, datasets=datasets)
    ctx = runner.train_ctx
    # dropout off: the deterministic loss (no dropout key)
    ctx._step_fn = make_train_step(lambda p, b, r: model._loss_fn(p, b, None),
                                   donate=True, trainable_mask=model.trainable_mask())
    runner.train()
    runner._save_checkpoint(1, is_best=False)
    return {"root": root, "runner": runner, "ckpt": ckpt}


def _port_argv(e2e, out_dir):
    return ["--cfg-path", TINY, "--options", *_run_options(e2e["root"] / "synth", out_dir),
            "run.device=cpu", f"model.finetuned={e2e['ckpt']}", "model.load_finetuned=True"]


def test_train_entry_point_matches_jax(jax_training, tmp_path, monkeypatch):
    e2e = jax_training
    runners = []
    from_config, train_fn = BLIP2_MR.from_config.__func__, RunnerBase.train

    def no_dropout(cls, cfg, device="cuda"):
        return _with_dropout(from_config(cls, cfg, device=device), 0.0)

    def captured(self):
        runners.append(self)
        return train_fn(self)

    monkeypatch.setattr(BLIP2_MR, "from_config", classmethod(no_dropout))
    monkeypatch.setattr(RunnerBase, "train", captured)
    logs = train.main(_port_argv(e2e, tmp_path / "port"))
    (runner,) = runners
    runner._save_checkpoint(1, is_best=False)

    jax_job, jax_events = _events(e2e["root"] / "jax")
    job, events = _events(tmp_path / "port")
    losses = [[e["train/loss"] for e in ev if "train/loss" in e] for ev in (jax_events, events)]
    assert len(losses[1]) == 6 and runner.train_ctx.updates == 6
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-4)
    lrs = [[e["train/lr"] for e in ev if "train/lr" in e] for ev in (jax_events, events)]
    assert lrs[0] == lrs[1]
    # validation: the same rows each epoch, the same metrics
    for epoch in (0, 1):
        name = f"result/val_epoch{epoch}.json"
        assert json.loads((job / name).read_text()) == json.loads((jax_job / name).read_text())
    assert _val_logs(job) == _val_logs(jax_job) and len(_val_logs(job)) == 2
    want_test = json.loads((jax_job / "result/test_epochbest.json").read_text())
    assert json.loads((job / "result/test_epochbest.json").read_text()) == want_test
    assert logs["test"]["total"] == 2
    # the checkpoint files, by name
    names = [sorted(p.stem for p in d.iterdir() if p.is_file()
                    and p.suffix in (".msgpack", ".pth")) for d in (jax_job, job)]
    assert names[0] == names[1] == ["checkpoint_1", "resume_state"]
    # the final weights: trainable within 1e-3, frozen as loaded
    jparams = unstack_blip2_mr_params(e2e["runner"].train_ctx.state.params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    got = runner.model.state_dict()
    mask = runner.model.trainable_mask()
    for name, w in want.items():
        tol = 1e-3 if mask.get(name) else 1e-6
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=tol, err_msg=name)
    saved = torch.load(job / "checkpoint_1.pth", weights_only=True)["model"]
    jsaved = serialization.msgpack_restore((jax_job / "checkpoint_1.msgpack").read_bytes())
    assert set(saved) == {n for n, m in mask.items() if m}
    # the JAX file keeps the scanned layout (layers stacked): count elements
    assert (sum(v.size for v in jsaved["model"].values())
            == sum(v.numel() for v in saved.values()))


def test_train_loaders_yield_the_jax_samples(tmp_path):
    """The same train batches on both sides, random crops and frame picks
    included, from the same seed (num_workers 1 keeps the draws in order)."""
    make_mr_annotations(str(tmp_path / "synth"), n_train=6, n_val=1, n_test=1,
                        n_video_frames=20, fps=5.0, height=48, width=64)
    options = [*_run_options(tmp_path / "synth", tmp_path / "out"), "run.batch_size_train=2"]
    batches = []
    for config_cls, task_mod in ((JaxConfig, jax_tasks), (Config, tasks)):
        cfg = config_cls(cfg_path=TINY, options=options)
        datasets = task_mod.setup_task(cfg).build_datasets(cfg)
        runner_cls = _OneDevice if config_cls is JaxConfig else RunnerBase
        runner = runner_cls(cfg=cfg, job_id="j", task=None, model=None, datasets=datasets)
        random.seed(42)
        loader = runner.train_loader
        batches.append([next(loader) for _ in range(4)])  # past the epoch's end
        loader.iter_loader.close()  # joins the worker still decoding ahead
    for jb, pb in zip(*batches):
        assert jb.keys() == pb.keys()
        for key in jb:
            if isinstance(jb[key], np.ndarray):
                np.testing.assert_array_equal(pb[key], jb[key], err_msg=key)
            else:
                assert list(pb[key]) == list(jb[key]), key


# --------------------------------------------------------------------- CLI
def test_cli_sigterm_exits_143_and_resumes(tmp_path):
    """``python -m mr_blip_tpu_torch.train`` SIGTERMed in epoch 2 exits 143
    with a resume state of the interrupted epoch; a resume run re-runs that
    epoch and completes."""
    synth = tmp_path / "synth"
    make_mr_annotations(str(synth), n_train=8, n_val=2, n_test=2,
                        n_video_frames=20, fps=5.0, height=48, width=64)
    out_dir = tmp_path / "out"
    base = [sys.executable, "-m", "mr_blip_tpu_torch.train", "--cfg-path", TINY,
            "--options", *_split_options(synth), f"run.output_dir={out_dir}",
            "run.device=cpu", "run.batch_size_train=2", "run.batch_size_eval=2",
            "run.num_workers=1", "run.max_epoch=200", "run.valid_splits=[]",
            "run.test_splits=[]"]
    log = tmp_path / "child.log"
    with open(log, "w") as lf:
        proc = subprocess.Popen(base, stdout=lf, stderr=lf, cwd=REPO)
        try:
            deadline = time.time() + 120
            while time.time() < deadline:
                if proc.poll() is not None:
                    pytest.fail("train exited before the signal: " + log.read_text()[-3000:])
                if "Start training epoch 2" in log.read_text():
                    break
                time.sleep(0.05)
            else:
                pytest.fail("never reached epoch 2: " + log.read_text()[-3000:])
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    assert rc == 143, log.read_text()[-3000:]

    (job,) = list(out_dir.iterdir())
    resume = job / "resume_state.pth"
    obj = torch.load(resume, weights_only=True, mmap=True)
    assert obj["epoch_complete"] is False
    preempt_epoch = int(obj["epoch"])
    assert preempt_epoch >= 2
    assert (job / f"checkpoint_{preempt_epoch - 1}.pth").exists()
    assert obj["train_ctx"]["updates"] > 0

    proc2 = subprocess.run(
        base[:-3] + [f"run.resume_ckpt_path={resume}", f"run.max_epoch={preempt_epoch + 1}",
                     *base[-2:]],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc2.returncode == 0, proc2.stderr[-3000:]
    assert "Resume checkpoint loaded" in proc2.stderr
    assert f"(epoch {preempt_epoch})" in proc2.stderr  # re-runs, not skips
    assert f"Start training epoch {preempt_epoch}" in proc2.stderr


def test_train_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    make_mr_annotations(str(tmp_path / "synth"), n_train=2, n_val=1, n_test=1,
                        n_video_frames=10, fps=5.0, height=32, width=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--cfg-path", TINY, "--options", *_split_options(tmp_path / "synth"),
                    f"run.output_dir={tmp_path / 'out'}"])
    assert preempt.get_guard() is None


def test_profile_steps_write_a_trace(tmp_path, monkeypatch):
    """``MRBLIP_PROFILE_STEPS=2`` records steps 1-2 of epoch 0 with
    ``torch.profiler`` under ``<output_dir>/profile``."""
    monkeypatch.setenv("MRBLIP_PROFILE_STEPS", "2")
    runner = _runner(tmp_path, options=["run.valid_splits=[]", "run.test_splits=[]",
                                        "run.batch_size_train=1", "run.wandb=False"])
    runner.train()
    traces = list((runner.output_dir / "profile").glob("*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
