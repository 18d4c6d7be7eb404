"""The port's OPT variant (``blip2_opt_mr``) against the JAX package's, on
the CPU, at the tiny widths in fp32, the weights drawn from a numpy seed
and carried over by ``state_dict_from_jax``.

Tolerances: modules 1e-4 (logits, losses); sequences, spans, moments and
trainable names identical. A train run of
``configs/projects/train/tiny_synthetic_opt.yaml`` (the JAX runner in this
process, dropout off, against ``mr_blip_tpu_torch.train.main``): per-step
losses within 1e-4, validation rows identical, trained tensors within 1e-3
(after AdamW updates a near-zero gradient's step is lr·g/(|g| + eps), so
float noise moves it by up to ~lr, as in ``tests/test_torch_train_entry.py``).

The JAX ``prepare_opt_batch`` casts frames to float32, so uint8 frames reach
its ViT unnormalized; the port normalizes them on the device, as the T5
variant does (ROADMAP Queue 3, known differences). Every comparison here
hands the JAX model the uint8 frames (``_jax_keeps_uint8``), where its
module's own uint8 branch normalizes them.
"""

import json
import random
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
from mr_blip_tpu.metrics.simple import compute_IoU as jax_compute_iou
from mr_blip_tpu.models import opt as jopt
from mr_blip_tpu.models.blip2_mr_opt import BLIP2_MR_OPT as JaxOPT
from mr_blip_tpu.models.scan_utils import stack_blip2_mr_params, unstack_blip2_mr_params
from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
from mr_blip_tpu.runners.train_state import make_train_step
from mr_blip_tpu_torch import train
from mr_blip_tpu_torch.common.config import Config
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
from mr_blip_tpu_torch.models import opt as topt
from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.models.generation import beam_search
from mr_blip_tpu_torch.models.layers import Dropout
from mr_blip_tpu_torch.runners.runner_base import RunnerBase
from mr_blip_tpu_torch.runners.train_state import TrainCtx

REPO = Path(__file__).resolve().parent.parent
TINY_OPT = str(REPO / "configs/projects/train/tiny_synthetic_opt.yaml")
TINY = dict(opt_model="tiny", img_size=28, vit_model="tiny", task="lora",
            num_beams=2, max_new_tokens=6, compute_dtype="float32")


def _samples(b=2, t=2, seed=0):
    rng = np.random.default_rng(seed)
    durations = [20.0, 30.0, 12.0][:b]
    return {
        "video": rng.integers(0, 256, (b, t, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.stack([np.linspace(0, d, t, endpoint=False) for d in durations]),
        "duration": np.array(durations),
        "query_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": ["Query: a cat jumps\n", "Query: something else entirely\n",
                         "Query: x\n"][:b],
        "task_prompt": ["Relevant windows: "] * b,
        "relevant_windows": ["[[0, 10]]", "[[5, 25]]", "[[1, 2]]"][:b],
    }


def _redraw(params, seed, std=0.3):
    """Every leaf from a numpy seed (LayerNorm scales near one)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else std * noise
    return traverse_util.unflatten_dict(flat)


@pytest.fixture
def _jax_keeps_uint8(monkeypatch):
    real = JaxOPT.prepare_opt_batch

    def keep(self, samples, need_targets=True):
        batch = real(self, samples, need_targets)
        video = np.asarray(samples["video"])
        if video.dtype == np.uint8:
            batch["frames"] = video
        return batch

    monkeypatch.setattr(JaxOPT, "prepare_opt_batch", keep)


def _pair(seed=1, **kw):
    """(JAX model, port model) on the same weights."""
    cfg = {**TINY, **kw}
    jm = JaxOPT(**cfg, scan_layers=False)
    params = _redraw(jm.params, seed)
    jm.params = jax.tree.map(jnp.asarray, params)
    pm = BLIP2_MR_OPT(**cfg, init_params=False, device="cpu")
    pm.load_state_dict(state_dict_from_jax(params))
    return jm, pm


# ---------------------------------------------------------------- the LM
@pytest.mark.parametrize("name", ["opt_2_7b_config", "opt_6_7b_config", "opt_tiny_config"])
def test_opt_configs_equal_jax(name):
    got, want = getattr(topt, name)(), getattr(jopt, name)()
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
        f: getattr(want, f) for f in want.__dataclass_fields__}


def _lm_pair(seed=0, lora_rank=0):
    cfg = jopt.opt_tiny_config(lora_rank=lora_rank)
    jlm = jopt.OPTForCausalLM(cfg, compute_dtype=jnp.float32)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((2, 1, cfg.hidden_size)))["params"]
    params = _redraw(params, seed)
    lm = topt.OPTForCausalLM(topt.opt_tiny_config(lora_rank=lora_rank),
                             dtype=torch.float32)
    sd = state_dict_from_jax({"opt": params})
    lm.load_state_dict({k[len("opt."):]: v for k, v in sd.items()})
    return jlm, params, lm.eval()


@pytest.mark.parametrize("lora_rank", [0, 8])
def test_causal_lm_logits_equal_jax(lora_rank):
    jlm, params, lm = _lm_pair(lora_rank=lora_rank)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 2:4] = 0  # padding inside the prompt, as the vid block has
    want = jlm.apply({"params": params}, jnp.asarray(x), attention_mask=jnp.asarray(mask))
    got = lm(torch.from_numpy(x), attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_prefill_then_step_equals_full_forward():
    """The port's own version of ``tests/test_opt_variant.py::TestOPTCore``:
    the first n tokens written in one block-causal pass, then one step a
    token, give the full forward's logits."""
    _, _, lm = _lm_pair(seed=2)
    n, extra = 6, 3
    ids = torch.from_numpy(np.random.default_rng(0).integers(3, 200, (2, n + extra)))
    with torch.no_grad():
        full = lm(lm.embed_tokens(ids))
        cache = lm.init_cache(2, n + extra, "cpu")
        mask = torch.ones(2, n + extra, dtype=torch.long)
        prefill = lm(lm.embed_tokens(ids[:, :n]), attention_mask=mask, cache=cache)
        steps = [lm(lm.embed_tokens(ids[:, t:t + 1]), attention_mask=mask, cache=cache,
                    position=t)[:, 0] for t in range(n, n + extra)]
    np.testing.assert_allclose(prefill.numpy(), full[:, :n].numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full[:, n:].numpy(),
                               atol=1e-4, rtol=1e-4)


def test_position_bound_raises_where_jax_gives_nan():
    """Past max_position_embeddings (128 in the tiny config) the JAX table
    lookup gives NaN, and the causal product spreads it to every logit row;
    the port raises, in the LM, in the loss and in generate."""
    jlm, params, lm = _lm_pair()
    x = np.random.default_rng(1).standard_normal((1, 129, 32)).astype(np.float32)
    want = np.asarray(jlm.apply({"params": params}, jnp.asarray(x)))
    assert np.isnan(want).all(axis=-1).all()
    with pytest.raises(ValueError, match="128 of max_position_embeddings "
                                         r"\(129 positions needed\)"):
        lm(torch.from_numpy(x))
    np.testing.assert_allclose(lm(torch.from_numpy(x[:, :128])).detach().numpy(),
                               np.asarray(jlm.apply({"params": params},
                                                    jnp.asarray(x[:, :128]))),
                               atol=1e-4, rtol=1e-4)
    # 40 frames of 4 query tokens: a 160-token prompt
    pm = BLIP2_MR_OPT(**TINY, device="cpu")
    long = _samples(t=40)
    for call in (pm.forward, pm.generate):
        with pytest.raises(ValueError, match="128 of max_position_embeddings"):
            call(long)
    # a prompt that fits, with decode steps that pass the table
    pm = BLIP2_MR_OPT(**{**TINY, "max_new_tokens": 100, "num_beams": 1}, device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        pm.generate(_samples(t=4))


# ---------------------------------------------------------- the variant
@pytest.fixture(scope="module")
def opt_pair():
    """One pair for the loss, float-frame, train-step and 2-beam tests: the
    JAX model compiles its loss and generate once."""
    return _pair(seed=3, max_new_tokens=8)


def test_module_loss_equals_jax(_jax_keeps_uint8, opt_pair):
    jm, pm = opt_pair
    samples = _samples()
    want = float(jm.forward(samples)["loss"])
    got = pm.forward(samples)["loss"]
    assert float(got) == pytest.approx(want, abs=1e-4)
    assert np.isfinite(want)


@pytest.mark.parametrize("num_beams", [1, 2])
def test_generate_equals_jax(_jax_keeps_uint8, opt_pair, num_beams):
    jm, pm = opt_pair if num_beams == 2 else _pair(seed=3, num_beams=1, max_new_tokens=8)
    samples = _samples(b=3)
    want, got = jm.generate(samples), pm.generate(samples)
    assert got["raw_prediction"] == want["raw_prediction"]
    assert got["prediction"] == want["prediction"]
    assert got["qid"] == want["qid"] and got["duration"] == want["duration"]
    handle = pm.generate_dispatch(samples)
    assert handle["seqs"].shape == (3, 8)


def test_float_frames_are_taken_as_they_are(opt_pair):
    """Frames the processor normalized (float) go in unchanged, as in JAX."""
    jm, pm = opt_pair
    samples = _samples()
    samples["video"] = np.random.default_rng(2).standard_normal(
        samples["video"].shape).astype(np.float32)
    assert float(pm.forward(samples)["loss"]) == pytest.approx(
        float(jm.forward(samples)["loss"]), abs=1e-4)


@pytest.mark.parametrize("task", ["lora", "qformer_freeze_lora", "qformer_freeze"])
def test_trainable_tensors_equal_jax(task):
    jm = JaxOPT(**{**TINY, "task": task}, scan_layers=False)
    pm = BLIP2_MR_OPT(**{**TINY, "task": task}, device="cpu")
    # Each leaf filled with its mask value, then converted: the name of every
    # trainable leaf in the port's layout.
    marked = jax.tree.map(lambda p, m: np.full(p.shape, float(m), np.float32),
                          jm.params, jm.trainable_mask())
    converted = state_dict_from_jax(marked)
    assert set(converted) == set(pm.state_dict())
    want = {n for n, t in converted.items() if bool(t.flatten()[0])}
    got = {n for n, m in pm.trainable_mask().items() if m}
    assert got == want
    count = sum(int(np.asarray(p).size) for p, m in zip(
        jax.tree.leaves(jm.params), jax.tree.leaves(jm.trainable_mask())) if m)
    assert pm.trainable_param_count()[0] == count
    assert any("lora_" in n for n in got) == ("lora" in task)
    assert any(n.startswith("qformer.") for n in got) == ("qformer_freeze" not in task)


def test_beam_search_takes_a_start_token_per_row():
    """Each row's search starts from its own token; a scalar start is the
    same as a row of equal ones (the T5 path)."""
    vocab = 7
    table = torch.from_numpy(np.random.default_rng(0).standard_normal((vocab, vocab)))

    def step(cache, tokens, position):
        return table[tokens[:, 0]].float(), cache

    start = torch.tensor([3, 5])
    seqs, _ = beam_search(step, [], batch_size=2, num_beams=2, max_length=4,
                          decoder_start_token_id=start)
    for row in range(2):
        one, _ = beam_search(step, [], batch_size=1, num_beams=2, max_length=4,
                             decoder_start_token_id=int(start[row]))
        assert torch.equal(seqs[row], one[0])
    a, _ = beam_search(step, [], batch_size=2, num_beams=2, max_length=4,
                       decoder_start_token_id=3)
    b, _ = beam_search(step, [], batch_size=2, num_beams=2, max_length=4,
                       decoder_start_token_id=torch.tensor([3, 3]))
    assert torch.equal(a, b)


# -------------------------------------------------------------- readouts
def _logits_for(tokenizer, texts):
    enc = tokenizer(texts, padding="longest")
    ids = np.asarray(enc["input_ids"])
    rng = np.random.default_rng(3)
    logits = rng.uniform(0.0, 1e-3, (ids.shape[0], ids.shape[1], tokenizer.vocab_size))
    b_idx, t_idx = np.meshgrid(np.arange(ids.shape[0]), np.arange(ids.shape[1]),
                               indexing="ij")
    logits[b_idx, t_idx, ids] = 10.0
    return logits.astype(np.float32)


def test_logits_to_moments_equals_jax():
    jm = JaxOPT(**TINY, scan_layers=False, init_params=False)
    pm = BLIP2_MR_OPT(**TINY, init_params=False, device="cpu")
    texts = ["video 0 5 10 query</s>[[10, 25], [40, 51]]</s>", "echo</s>[[3 7]]</s>",
             "echo</s>[[25, 10]]</s>", "echo</s>[[5,, 9]]</s>", "echo</s>[[1, 2, 3]]</s>",
             "echo</s>not a list</s>", "echo</s>[[0, 4] [6, 9]]</s>"]
    logits = _logits_for(pm.tokenizer, texts)
    want = jm.logits_to_moments(jnp.asarray(logits))
    assert pm.logits_to_moments(logits) == want
    assert pm.logits_to_moments(torch.from_numpy(logits)) == want
    assert want[0] == [[10, 25], [40, 51]]
    # no </s> anywhere: [[-1, -1]] (the reference raises IndexError)
    unk = np.full((1, 4), pm.tokenizer.unk_token_id)
    no_eos = np.zeros((1, 4, pm.tokenizer.vocab_size), np.float32)
    no_eos[0, np.arange(4), unk[0]] = 10.0
    assert pm.logits_to_moments(no_eos) == jm.logits_to_moments(no_eos) == [[[-1, -1]]]


def test_compute_iou_equals_jax():
    rng = np.random.default_rng(11)
    cases = [([0.0, 10.0], [0.0, 10.0]), ([0.0, 5.0], [5.0, 10.0]),
             ([0.0, 5.0], [6.0, 10.0]), ([2.0, 8.0], [0.0, 10.0]),
             ([0.0, 10.0], [5.0, 15.0])]
    cases += [(np.sort(rng.uniform(0, 100, 2)).tolist(),
               np.sort(rng.uniform(0, 100, 2)).tolist()) for _ in range(50)]
    for p, t in cases:
        assert BLIP2_MR_OPT.compute_IoU(p, t) == JaxOPT.compute_IoU(p, t) == \
            jax_compute_iou(p, t)


# ---------------------------------------------------------------- config
def _constructor_kwargs(cls, cfg, **kw):
    seen = {}

    class Stop(Exception):
        pass

    def probe_init(self, **kwargs):
        seen.update(kwargs)
        raise Stop

    with pytest.raises(Stop):
        type("Probe", (cls,), {"__init__": probe_init}).from_config(cfg, **kw)
    return seen


def test_from_config_opt_charades_equals_jax(caplog):
    """``eval/opt_charades.yaml``: the JAX ``from_config``'s constructor
    values (published widths, not built here); ``interleave_data``,
    ``load_finetuned`` and ``finetuned`` unread, as in JAX; the registry
    resolves the arch; the tiny widths build."""
    path = str(REPO / "configs/projects/eval/opt_charades.yaml")
    cfg = Config(cfg_path=path).model_cfg
    want = _constructor_kwargs(JaxOPT, JaxConfig(cfg_path=path).model_cfg)
    with caplog.at_level("WARNING"):
        got = _constructor_kwargs(BLIP2_MR_OPT, cfg, device="cpu")
    assert got.pop("device") == "cpu"
    assert got == want
    assert got["opt_model"] == "opt-2.7b" and got["num_beams"] == 1
    assert got["min_new_tokens"] == 5
    for key in ("interleave_data", "load_finetuned", "finetuned"):
        assert f"model.{key}" in caplog.text
    assert registry.get_model_class("blip2_opt_mr") is BLIP2_MR_OPT
    cfg = Config(cfg_path=path, options=[
        "model.opt_model=tiny", "model.vit_model=tiny", "model.image_size=28",
        "model.compute_dtype=float32"]).model_cfg
    model = BLIP2_MR_OPT.from_config(cfg, device="cpu")
    assert model.opt_config.vocab_size == model.tokenizer.vocab_size
    assert model.opt_config.lora_rank == 8 and model.num_beams == 1
    cfg.freeze_vit = False
    model = BLIP2_MR_OPT.from_config(cfg, device="cpu")
    mask = model.trainable_mask()
    assert not model.freeze_vit
    # qformer_freeze_lora: the ViT and the OPT's LoRA tensors train
    assert all(m == (n.startswith("visual_encoder.") or "lora_" in n)
               for n, m in mask.items())
    assert all(blk.drop_path.rate == 0.0 for blk in model.module.visual_encoder.blocks)


def test_train_ctx_steps_the_opt_model(_jax_keeps_uint8, opt_pair):
    """``TrainCtx`` takes the OPT model (no T5 to ask about a cached bias):
    one step's loss is the JAX loss, the LoRA tensors get gradients."""
    jm = opt_pair[0]
    pm = BLIP2_MR_OPT(**{**TINY, "max_new_tokens": 8}, init_params=False, device="cpu")
    pm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jm.params)))
    samples = _samples()
    want = float(jm.forward(samples)["loss"])
    for m in pm.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    ctx = TrainCtx(pm, accum_grad_iters=2)
    assert ctx.step(pm.prepare_mr_batch(samples)) == pytest.approx(want, abs=1e-4)
    lora = [p for n, p in pm.module.named_parameters() if "lora_b" in n]
    assert lora and all(p.grad is not None and p.grad.abs().sum() > 0 for p in lora)
    assert not pm.trains_cached_bias() and not hasattr(pm.module, "t5")


# ---------------------------------------------------------- whole run
def _run_options(synth, out_dir):
    return [f"datasets.qvh.build_info.annotations.{s}.storage={synth}/{s}.json"
            for s in ("train", "val", "test")] + [
        f"run.output_dir={out_dir}", "run.num_workers=1", "run.batch_size_train=4",
        "run.batch_size_eval=2", "run.max_epoch=2"]


class _OneDevice(JaxRunnerBase):
    mesh = None  # train.py's run on one device (no dp mesh, no padded rows)


def _events(out_dir):
    (job,) = [p for p in Path(out_dir).iterdir() if p.is_dir()]
    return job, [json.loads(line)
                 for line in (job / "events.jsonl").read_text().splitlines()]


def test_train_entry_point_equals_jax(_jax_keeps_uint8, tmp_path, monkeypatch):
    """``python -m mr_blip_tpu_torch.train`` on ``tiny_synthetic_opt.yaml``
    against the JAX runner's ``train()`` (2 epochs of 3 updates, validation
    each epoch, the test split), dropout off on both sides."""
    make_mr_annotations(str(tmp_path / "synth"), n_train=12, n_val=2, n_test=2,
                        n_video_frames=20, fps=5.0, height=48, width=64)
    cfg = JaxConfig(cfg_path=TINY_OPT,
                    options=_run_options(tmp_path / "synth", tmp_path / "jax"))
    random.seed(42)  # train.py's setup_seeds, in train.py's order
    np.random.seed(42)
    task = jax_tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    params = _redraw(unstack_blip2_mr_params(model.params), 31, std=0.1)
    model.params = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    runner = _OneDevice(cfg=cfg, job_id="job", task=task, model=model, datasets=datasets)
    runner.train_ctx._step_fn = make_train_step(
        lambda p, b, r: model._loss_fn(p, b, None), donate=True,
        trainable_mask=model.trainable_mask())
    runner.train()

    state = state_dict_from_jax(params)
    runners = []
    from_config, train_fn = BLIP2_MR_OPT.from_config.__func__, RunnerBase.train

    def loaded(cls, cfg, device="cuda"):
        m = from_config(cls, cfg, device=device)
        m.load_state_dict(state)
        for mod in m.module.modules():
            if isinstance(mod, Dropout):
                mod.rate = 0.0
        return m

    def captured(self):
        runners.append(self)
        return train_fn(self)

    monkeypatch.setattr(BLIP2_MR_OPT, "from_config", classmethod(loaded))
    monkeypatch.setattr(RunnerBase, "train", captured)
    logs = train.main(["--cfg-path", TINY_OPT, "--options",
                       *_run_options(tmp_path / "synth", tmp_path / "port"),
                       "run.device=cpu"])
    (port_runner,) = runners
    jax_job, jax_events = _events(tmp_path / "jax")
    job, events = _events(tmp_path / "port")
    losses = [[e["train/loss"] for e in ev if "train/loss" in e]
              for ev in (jax_events, events)]
    assert len(losses[1]) == 6 and port_runner.train_ctx.updates == 6
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-4)
    for name in ("result/val_epoch0.json", "result/val_epoch1.json",
                 "result/test_epochbest.json"):
        assert (json.loads((job / name).read_text())
                == json.loads((jax_job / name).read_text())), name
    assert logs["test"]["total"] == 2
    jparams = unstack_blip2_mr_params(runner.train_ctx.state.params)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    got = port_runner.model.state_dict()
    mask = port_runner.model.trainable_mask()
    assert sum(mask.values()) > 0
    for name, w in want.items():
        tol = 1e-3 if mask[name] else 1e-6
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=tol, err_msg=name)
