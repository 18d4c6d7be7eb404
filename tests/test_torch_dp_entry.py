"""The train and evaluation entry points over two ranks, on the CPU.

``mr_blip_tpu_torch.train`` and ``mr_blip_tpu_torch.evaluate`` under
``torch.distributed.run --standalone --nproc_per_node=2`` (``gloo``,
``run.device=cpu``) on ``configs/projects/train/tiny_synthetic.yaml`` with
odd query counts, so that the evaluation shards are uneven, against the
same entry points in one process:

5. training with one row per rank equals one process with batches of 2
   (dropout 0 on both, the train split read through the evaluation
   processor so that no random crop depends on the rank): the trained
   tensors, the merged validation and test rows (each query once) and the
   metrics; so does training with ``model.sequence_parallel`` (both ranks
   on the same batches of 2, the frames shared out, rank 0's rows kept);
   evaluation over two ranks gives the one-process rows.
6. SIGTERM to one rank of a two-process training: both ranks exit 143 at the
   same step, the resume state holds each rank's partial gradients, and a
   two-rank resume run completes. At the runner, a two-rank run cut in the
   middle of an accumulation window (dropout on) and resumed from its
   resume state takes the uninterrupted step, bit-equal on both ranks; a
   one-process resume state's partial gradients go to rank 0 alone.
7. ``WORLD_SIZE=2`` with ``run.device=cuda`` on a host without a card
   raises, as do ``run.distributed=False`` under a launcher and ``run.tp=2``
   in one process.
8. ``run.tp=2`` over two ranks (tensor parallelism, dp=1), the T5 model and
   the OPT variant: training with batches of 2 equals one process, the
   merged rows once each, the resume state's tensors whole (it loads into a
   one-process model); evaluation gives the one-process rows.

The workers (this file run as a script) import no JAX. Every launch has a
timeout of 120 s.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
TINY = str(REPO / "configs/projects/train/tiny_synthetic.yaml")
TINY_OPT = str(REPO / "configs/projects/train/tiny_synthetic_opt.yaml")
LAUNCH_TIMEOUT_S = 120
N_TRAIN, N_VAL, N_TEST = 9, 3, 3


def _split_options(synth):
    return [f"datasets.qvh.build_info.annotations.{s}.storage={synth}/{s}.json"
            for s in ("train", "val", "test")]


def _options(synth, out_dir, *extra, cfg=TINY):
    return ["--cfg-path", cfg, "--options", *_split_options(synth),
            f"run.output_dir={out_dir}", "run.device=cpu", "run.num_workers=1",
            "run.batch_size_eval=1", "run.distributed=True",
            "datasets.qvh.vis_processor.train.name=blip_video_eval", *extra]


def _zero_dropout(model):
    from mr_blip_tpu_torch.models.layers import Dropout

    for m in model.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def _train_capturing(argv, out: Path, dropout: bool = False, resume_state: bool = False):
    """``train.main(argv)`` with the model's dropout rates 0 (unless
    ``dropout``); the runner's trained tensors, test logs and job directory
    to ``<out>.rank<r>``; with ``resume_state`` the runner also writes its
    resume state after training."""
    from mr_blip_tpu_torch import train
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.runners.runner_base import RunnerBase

    runners = []
    from_config, train_fn = BLIP2_MR.from_config.__func__, RunnerBase.train

    def built(cls, cfg, device="cuda"):
        model = from_config(cls, cfg, device=device)
        return model if dropout else _zero_dropout(model)

    def captured(self):
        runners.append(self)
        logs = train_fn(self)
        if resume_state:
            self._write_resume_state(0)
        return logs

    BLIP2_MR.from_config = classmethod(built)
    RunnerBase.train = captured
    rank = int(os.environ.get("RANK", 0))
    try:
        logs = train.main(argv)
    finally:
        BLIP2_MR.from_config = classmethod(from_config)
        RunnerBase.train = train_fn
    (runner,) = runners
    trained = {n: p.detach().clone() for n, p in runner.train_ctx.named_params.items()}
    torch.save({"trained": trained, "logs": json.loads(json.dumps(logs, default=float)),
                "job": str(runner.output_dir), "updates": runner.train_ctx.updates},
               f"{out}.rank{rank}")
    assert not dist_utils.is_dist_avail_and_initialized()
    return logs


# ------------------------------------------------------------------ workers
def _resume_worker(workdir: Path):
    """Case 6 at the runner: accum_grad_iters 4, dropout 0.3; 4 micro-batches
    uninterrupted against 3, the resume state, a fresh runner loading it and
    the 4th. Each rank trains on its own rows."""
    from mr_blip_tpu_torch import tasks
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.common.config import Config
    from mr_blip_tpu_torch.models.layers import Dropout
    from mr_blip_tpu_torch.parallel.mesh import assert_replicated
    from mr_blip_tpu_torch.runners.runner_base import RunnerBase

    options = [f"run.output_dir={workdir / 'runs'}", "run.device=cpu",
               "run.accum_grad_iters=4", "run.distributed=True", "run.dist_timeout_s=60"]
    cfg = Config(cfg_path=TINY, options=options)
    dist_utils.init_distributed_mode(cfg.run_cfg)
    rank = dist_utils.get_rank()
    task = tasks.setup_task(cfg)

    def runner(job_id):
        model = task.build_model(cfg)
        for m in model.module.modules():
            if isinstance(m, Dropout):
                m.rate = 0.3
        return RunnerBase(cfg=cfg, job_id=job_id, task=task, model=model, datasets={})

    def steps(r, n, seed=0):
        ctx = r.train_ctx
        ctx.set_lr(1e-3)
        for i in range(n):
            r.task.train_step(ctx, _samples(seed + i + 10 * rank))

    whole = runner("whole")
    steps(whole, 4)
    cut = runner("cut")
    steps(cut, 3)
    path = cut._write_resume_state(0, epoch_complete=False)
    resumed = runner("resumed")
    resumed.model.init_params(seed=11)
    resumed.load_checkpoint(path)
    steps(resumed, 1, seed=3)
    want, got = whole.model.state_dict(), resumed.model.state_dict()
    assert whole.train_ctx.updates == resumed.train_ctx.updates == 1
    result = {
        "equal": [k for k, v in want.items() if not torch.equal(got[k], v)] == [],
        "moved": sum("lora_" in k and not torch.equal(v, cut.model.state_dict()[k])
                     for k, v in want.items()),
        "fingerprint": assert_replicated(resumed.train_ctx.named_params, "resumed"),
    }
    # a one-process state's partial window goes to rank 0 alone
    one = cut.train_ctx.state_dict()
    resumed.train_ctx.load_state_dict(one)
    grads = [(p.grad, one["grads"][n]) for n, p in resumed.train_ctx.named_params.items()]
    result["one_process_state"] = (
        all(w is not None and torch.equal(g, w) for g, w in grads) if rank == 0
        else all(g is None for g, _ in grads))
    if rank == 0:
        saved = torch.load(path, weights_only=True, mmap=True)["train_ctx"]
        result["rank_grads"] = len(saved["rank_grads"])
        a, b = saved["rank_grads"]
        result["grads_differ"] = any(not torch.equal(a[n], b[n]) for n in a
                                     if a[n] is not None)
    torch.save(result, workdir / f"resume_rank{rank}.pt")
    dist_utils.destroy()


def _samples(seed):
    rng = np.random.default_rng(seed)
    return {
        "video": rng.integers(0, 256, (1, 4, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.array([[0.0, 5.0, 10.0, 15.0]]),
        "duration": np.array([20.0]),
        "query_id": [f"q{seed}"],
        "video_prompt_end": ["<extra_id_0>"],
        "query_prompt": [f"Query: event {seed}\n"],
        "task_prompt": ["Relevant windows: "],
        "relevant_windows": ["[[0, 10]]" if seed % 2 else "[[5, 15], [16, 19]]"],
    }


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    workdir, mode, argv = Path(sys.argv[1]), sys.argv[2], sys.argv[3:]
    if mode == "resume":
        _resume_worker(workdir)
    else:  # a training, its results under <workdir>/<mode>.rank<r>
        _train_capturing(argv, workdir / mode, resume_state=mode == "tp")
    sys.exit(0)


# -------------------------------------------------------------------- tests
import pytest  # noqa: E402

from mr_blip_tpu_torch import evaluate, train  # noqa: E402
from mr_blip_tpu_torch.common.config import Config  # noqa: E402
from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations  # noqa: E402


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _torchrun(*args, module=None):
    target = ["-m", module] if module else [str(Path(__file__))]
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", *target, *args],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc, timeout=LAUNCH_TIMEOUT_S):
    try:
        log, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    return log


def _rows(job, name):
    rows = json.loads((Path(job) / "result" / f"{name}.json").read_text())
    return sorted(rows, key=lambda r: r["qid"])


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_entry")
    make_mr_annotations(str(root / "synth"), n_train=N_TRAIN, n_val=N_VAL, n_test=N_TEST,
                        n_video_frames=20, fps=5.0, height=48, width=64)
    return root


def test_two_rank_train_and_evaluate_equal_one_process(synth, tmp_path):
    """Case 5: 9 train queries give 4 global batches of 2 (the 9th row is
    dropped on both sides); 3 validation and 3 test queries split 2 + 1."""
    two_train = _torchrun(str(tmp_path), "two",
                          *_options(synth / "synth", tmp_path / "two",
                                    "run.batch_size_train=1"))
    sp_train = _torchrun(str(tmp_path), "sp",
                         *_options(synth / "synth", tmp_path / "sp", "run.batch_size_train=2",
                                   "model.sequence_parallel=True"))
    two_eval = _torchrun("--cfg-path", TINY, "--options",
                         *_options(synth / "synth", tmp_path / "two_eval",
                                   "run.evaluate=True")[3:],
                         module="mr_blip_tpu_torch.evaluate")
    try:
        one_logs = _train_capturing(
            _options(synth / "synth", tmp_path / "one", "run.batch_size_train=2"),
            tmp_path / "one")
        one_eval = evaluate.main(_options(synth / "synth", tmp_path / "one_eval",
                                          "run.evaluate=True"))
    finally:
        train_log = _finish(two_train)
        sp_log = _finish(sp_train)
        eval_log = _finish(two_eval)
    one = torch.load(f"{tmp_path / 'one'}.rank0", weights_only=False)
    two = [torch.load(f"{tmp_path / 'two'}.rank{r}", weights_only=False) for r in (0, 1)]
    assert one["updates"] == two[0]["updates"] == two[1]["updates"] == N_TRAIN // 2
    assert two[0]["job"] == two[1]["job"]
    for name, want in one["trained"].items():
        assert torch.equal(two[0]["trained"][name], two[1]["trained"][name]), name
        np.testing.assert_allclose(two[0]["trained"][name].numpy(), want.numpy(),
                                   atol=1e-5, err_msg=name)
    for split in ("val_epoch0", "test_epochbest"):
        got, want = _rows(two[0]["job"], split), _rows(one["job"], split)
        assert got == want, split
        assert len({r["qid"] for r in got}) == len(got) == N_VAL
    # each rank wrote its share: uneven
    shares = [len(json.loads((Path(two[0]["job"]) / "result" / f"test_epochbest_rank{r}.json")
                             .read_text())) for r in (0, 1)]
    assert shares == [2, 1]
    assert two[0]["logs"] == one["logs"] == json.loads(json.dumps(one_logs, default=float))
    assert two[1]["logs"] is not None and two[1]["logs"]["test"] is None  # rank 1 scores nothing
    # evaluation entry point
    (job,) = [p for p in (tmp_path / "two_eval").iterdir() if p.is_dir()]
    (one_job,) = [p for p in (tmp_path / "one_eval").iterdir() if p.is_dir()]
    assert _rows(job, "test_epochbest") == _rows(one_job, "test_epochbest")
    assert len(_rows(job, "test_epochbest")) == N_TEST
    assert "'total': 3" in eval_log and one_eval["test"]["total"] == N_TEST
    assert "Traceback" not in train_log + sp_log
    # sequence parallelism: the one-process run's batches, frames shared out
    sp = [torch.load(f"{tmp_path / 'sp'}.rank{r}", weights_only=False) for r in (0, 1)]
    assert sp[0]["updates"] == sp[1]["updates"] == one["updates"]
    for name, want in one["trained"].items():
        assert torch.equal(sp[0]["trained"][name], sp[1]["trained"][name]), name
        np.testing.assert_allclose(sp[0]["trained"][name].numpy(), want.numpy(),
                                   atol=1e-5, err_msg=name)
    for split in ("val_epoch0", "test_epochbest"):
        assert _rows(sp[0]["job"], split) == _rows(one["job"], split), split
    assert sp[0]["logs"] == one["logs"]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pair(argv, logs, sigterm_after=None):
    """``argv`` as ranks 0 and 1, each a process of its own with the
    environment torchrun sets (so that each rank's exit code is its own),
    their output to ``logs``; with ``sigterm_after``, SIGTERM to rank 1 alone
    once rank 0's log shows that text. Returns the exit codes and the logs."""
    port = _free_port()
    files = [open(p, "w") for p in logs]
    procs = [subprocess.Popen(
        argv, cwd=REPO, stdout=f, stderr=f,
        env=dict(_env(), RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port)))
        for rank, f in enumerate(files)]
    try:
        if sigterm_after:
            deadline = time.time() + LAUNCH_TIMEOUT_S
            while sigterm_after not in logs[0].read_text():
                assert time.time() < deadline, logs[0].read_text()[-3000:]
                assert all(p.poll() is None for p in procs), logs[0].read_text()[-3000:]
                time.sleep(0.05)
            procs[1].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=LAUNCH_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        for f in files:
            f.close()
    return rcs, [p.read_text() for p in logs]


def test_sigterm_to_one_rank_stops_both_and_resumes(synth, tmp_path):
    """Case 6: SIGTERM to rank 1 only, in epoch 2; both ranks stop at the
    same step (sync every 2 steps and at an epoch's end) and exit 143; the
    resume state holds two ranks' partial gradients; two ranks resume it and
    finish. Meanwhile the runner-level bit-equal resume over two ranks."""
    runner_level = _torchrun(str(tmp_path), "resume")
    out_dir = tmp_path / "out"
    base = [sys.executable, "-m", "mr_blip_tpu_torch.train",
            *_options(synth / "synth", out_dir, "run.batch_size_train=1",
                      "run.accum_grad_iters=3", "run.preempt_sync_every=2",
                      "run.max_epoch=200", "run.valid_splits=[]", "run.test_splits=[]",
                      "run.dist_timeout_s=60")]
    logs = [tmp_path / f"rank{r}.log" for r in (0, 1)]
    try:
        rcs, texts = _pair(base, logs, sigterm_after="Start training epoch 2")
        assert rcs == [143, 143], texts[0][-2000:] + texts[1][-2000:]
        stops = [[line.split("preempted at ")[1].split(" (")[0] for line in t.splitlines()
                  if "preempted at " in line] for t in texts]
        assert stops[0] == stops[1] and len(stops[0]) == 1, stops
        (job,) = [p for p in out_dir.iterdir() if p.is_dir()]
        state = torch.load(job / "resume_state.pth", weights_only=True, mmap=True)
        assert state["epoch_complete"] is False and len(state["train_ctx"]["rank_grads"]) == 2
        epoch = int(state["epoch"])
        assert f"epoch {epoch}," in stops[0][0]

        resume = [a for a in base if not a.startswith("run.max_epoch=")] + [
            f"run.resume_ckpt_path={job / 'resume_state.pth'}", f"run.max_epoch={epoch + 1}"]
        rcs, texts = _pair(resume, logs)
        assert rcs == [0, 0], texts[0][-2000:] + texts[1][-2000:]
        assert f"Start training epoch {epoch}" in texts[0]
    except BaseException:
        runner_level.kill()
        runner_level.communicate()
        raise
    _finish(runner_level)
    results = [torch.load(tmp_path / f"resume_rank{r}.pt", weights_only=False) for r in (0, 1)]
    assert all(r["equal"] and r["moved"] and r["one_process_state"] for r in results)
    assert results[0]["fingerprint"] == results[1]["fingerprint"]
    assert results[0]["rank_grads"] == 2 and results[0]["grads_differ"]


def test_world_of_two_without_a_card_raises(synth, tmp_path, monkeypatch):
    """Case 7, and the settings that refuse a launch: run.device=cuda on a
    host without a card, run.distributed=False under a launcher, run.tp=2."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    argv = ["--cfg-path", TINY, "--options", *_split_options(synth / "synth"),
            f"run.output_dir={tmp_path}", "run.distributed=True"]
    for var, value in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                       ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(var, value)
    for entry in (train, evaluate):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.main(argv)
    with pytest.raises(ValueError, match="run.distributed=False"):
        train.main(argv[:-1] + ["run.distributed=False", "run.device=cpu"])
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var)
    with pytest.raises(ValueError, match="run.tp=2 in one process.*torch.distributed.run"):
        train.main(argv + ["run.device=cpu", "run.tp=2"])


@pytest.mark.parametrize("variant", ["t5", "opt"])
def test_tp2_train_and_evaluate_equal_one_process(synth, tmp_path, variant):
    """Case 8: ``run.tp=2`` on two ranks (one tensor-parallel group, both
    ranks on the same batches of 2) trains what one process trains, both
    ranks bit-equal; the merged validation and test rows are one process's,
    each query once (only tp rank 0 writes its rows); the resume state
    holds whole tensors that load into a one-process model; the evaluation
    entry point under ``run.tp=2`` gives the one-process rows. The T5 model
    and the OPT variant (``tiny_synthetic_opt.yaml``; its LoRA dropout on,
    the same masks at tp=2)."""
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT

    cfg, cls, sharded = {
        "t5": (TINY, BLIP2_MR, "37 tensors sharded, 76 used in slices"),
        "opt": (TINY_OPT, BLIP2_MR_OPT, "12 tensors sharded, 32 used in slices")}[variant]
    tp_train = _torchrun(str(tmp_path), "tp",
                         *_options(synth / "synth", tmp_path / "tp", "run.batch_size_train=2",
                                   "run.tp=2", cfg=cfg))
    tp_eval = _torchrun("--cfg-path", cfg, "--options",
                        *_options(synth / "synth", tmp_path / "tp_eval", "run.evaluate=True",
                                  "run.tp=2", cfg=cfg)[3:],
                        module="mr_blip_tpu_torch.evaluate")
    try:
        _train_capturing(_options(synth / "synth", tmp_path / "one", "run.batch_size_train=2",
                                  cfg=cfg), tmp_path / "one")
        evaluate.main(_options(synth / "synth", tmp_path / "one_eval", "run.evaluate=True",
                               cfg=cfg))
    finally:
        train_log = _finish(tp_train)
        eval_log = _finish(tp_eval)
    one = torch.load(f"{tmp_path / 'one'}.rank0", weights_only=False)
    tp = [torch.load(f"{tmp_path / 'tp'}.rank{r}", weights_only=False) for r in (0, 1)]
    assert one["updates"] == tp[0]["updates"] == tp[1]["updates"] == N_TRAIN // 2
    for name, want in one["trained"].items():
        assert torch.equal(tp[0]["trained"][name], tp[1]["trained"][name]), name
        np.testing.assert_allclose(tp[0]["trained"][name].numpy(), want.numpy(),
                                   atol=1e-5, err_msg=name)
    result = Path(tp[0]["job"]) / "result"
    for split in ("val_epoch0", "test_epochbest"):
        got, want = _rows(tp[0]["job"], split), _rows(one["job"], split)
        assert got == want, split
        assert len({r["qid"] for r in got}) == len(got) == N_VAL
        assert not (result / f"{split}_rank1.json").exists()
    assert tp[0]["logs"] == one["logs"]
    state = torch.load(Path(tp[0]["job"]) / "resume_state.pth", weights_only=True)
    model = cls.from_config(Config(cfg_path=cfg, options=[]).model_cfg, device="cpu")
    model.load_state_dict(state["params"])  # strict: every tensor whole
    for name, p in model.module.named_parameters():
        if name in tp[0]["trained"]:
            assert torch.equal(p.detach(), tp[0]["trained"][name]), name
    (job,) = [p for p in (tmp_path / "tp_eval").iterdir() if p.is_dir()]
    (one_job,) = [p for p in (tmp_path / "one_eval").iterdir() if p.is_dir()]
    assert _rows(job, "test_epochbest") == _rows(one_job, "test_epochbest")
    for log in (train_log, eval_log):  # rank 0 logs its sharding
        assert f"tensor parallelism: {sharded}" in log
    assert "Traceback" not in train_log + eval_log
