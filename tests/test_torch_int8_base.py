"""QLoRA-style int8 training in the port against the JAX package, on the CPU.

``model.int8_base``: the frozen T5 base (every encoder and decoder block
Dense and the LM head) stored weight-only int8 under float LoRA deltas
(``quantize_t5_params``, ``T5Config.int8_base``, ``quantize_base_for_train``),
and the int8 ViT (``model.int8_vit``) under a train step. Tiny configs in
fp32, weights redrawn from numpy seeds and converted with
``state_dict_from_jax``; tolerance 1e-4 (the bar of the repo's torch parity
tests) unless stated. The JAX models are built without their flax init and
given ``init_params_fast``'s tree, redrawn: the full init takes ~30 s.
"""

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
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.models.quantize import quantize_t5_params as jax_quantize_t5_params
from mr_blip_tpu.models.scan_utils import stack_blip2_mr_params, unstack_blip2_mr_params
from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
from mr_blip_tpu.runners.train_state import (
    TrainState,
    make_optimizer,
    make_train_step,
    trainable_param_count,
)
from mr_blip_tpu_torch import train
from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.models.layers import Dropout
from mr_blip_tpu_torch.models.quantize import quantize_t5_params
from mr_blip_tpu_torch.runners.runner_base import RunnerBase
from mr_blip_tpu_torch.runners.train_state import TrainCtx

ATOL = 1e-4
REPO = Path(__file__).resolve().parent.parent
TINY_CFG = str(REPO / "configs/projects/train/tiny_synthetic.yaml")
TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=1,
            max_new_tokens=4, compute_dtype="float32")
QA_TASK = "qformer_freeze_lora_QA_with_localizer"
# The int8 ViT's outputs are bf16 and differ from the JAX ViT's on the CPU
# (its unfused W8A8 chain sums its bf16 products in another order) by a few
# bf16 ulps (``tests/test_torch_int8.py::test_int8_eva_vit_matches_jax``),
# ~1e-5 of the loss: the bar of a loss through it is relative.
INT8_VIT_LOSS_RTOL = 1e-4


def _samples(b=4, t=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "video": rng.integers(0, 256, (b, t, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.tile(np.array([0.0, 10.0, 20.0][:t]), (b, 1)),
        "duration": np.full((b,), 30.0),
        "query_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": ["Query: something happens\n"] * b,
        "task_prompt": ["Relevant windows: "] * b,
        "relevant_windows": ["[[0, 10]]", "[[5, 25]]", "[[1, 2]]", "[[0, 30]]"][:b],
    }


def _redraw(params, seed):
    """Every leaf redrawn: norm scales near 1, everything else N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, params))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.1 * noise
    return traverse_util.unflatten_dict(flat)


def _no_dropout(model):
    for m in model.module.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


@pytest.fixture(scope="module")
def float_trees():
    """Float JAX trees of the tiny model (unscanned), redrawn: the main tree
    and an answerer tree. Shared by every model of this file: the tree's
    layout does not depend on the task."""
    jm = JaxBLIP2_MR(**TINY, scan_layers=False, init_params=False)
    tree = jm.init_params_fast(jax.random.PRNGKey(0), dtype=jnp.float32)
    return _redraw(tree, 0), _redraw(tree, 1)


def _jax_model(trees, task="lora"):
    jm = JaxBLIP2_MR(**TINY, task=task, scan_layers=False, init_params=False)
    jm.params = jax.tree.map(jnp.asarray, trees[0])
    if jm.is_qa:
        jm.answerer_params = jax.tree.map(jnp.asarray, trees[1])
    return jm


def _port_model(trees, task="lora"):
    port = BLIP2_MR(**TINY, device="cpu", task=task, init_params=False)
    port.load_state_dict(state_dict_from_jax(trees[0], trees[1] if "QA" in task else None))
    return _no_dropout(port)


def _int8_base_pair(trees, task="lora"):
    """The JAX and the port model after ``quantize_base_for_train``, the
    port's dropout off (the rebuilt T5 has dropout modules of its own)."""
    jm, port = _jax_model(trees, task), _port_model(trees, task)
    jm.quantize_base_for_train()
    return jm, _no_dropout(port.quantize_base_for_train())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_batch(jm, samples):
    batch = jm.prepare_mr_batch(samples)
    batch.pop("video_prompt")
    return batch


# ------------------------------------------------------------------ layout
def test_quantize_t5_params_bit_equal_jax(float_trees):
    """``kernel_q`` and ``kernel_scale`` of every encoder- and decoder-block
    Dense and of the LM head bit-equal to the JAX conversion of the same
    float weights; the LoRA deltas, the embedding, the norms and the rel-pos
    tables untouched; the converted JAX int8_base tree loads strictly."""
    port = _port_model(float_trees)
    t5_float = {k[len("t5."):]: v for k, v in port.state_dict().items()
                if k.startswith("t5.")}
    got = quantize_t5_params(t5_float)
    want = state_dict_from_jax(
        {"t5": _np(jax_quantize_t5_params(jax.tree.map(jnp.asarray, float_trees[0]["t5"])))})
    want = {k[len("t5."):]: v for k, v in want.items()}
    assert got.keys() == want.keys()
    quantized = [k[:-len("kernel_q")] for k in got if k.endswith("kernel_q")]
    assert "lm_head." in quantized
    assert {p.split(".")[0] for p in quantized} == {"encoder", "decoder", "lm_head"}
    n_dense = 4 + 3  # self-attention q, k, v, o; FFN wi_0, wi_1, wo
    assert len(quantized) == 1 + n_dense * 2 + (n_dense + 4) * 2
    for key, value in got.items():
        assert value.dtype == want[key].dtype and torch.equal(value, want[key]), key
        if key.endswith("kernel_q"):
            assert value.dtype == torch.int8 and value.stride(0) == 1  # input axis contiguous
        elif not key.endswith("kernel_scale"):
            assert torch.equal(value, t5_float[key]), key  # untouched
    for prefix in quantized:
        assert prefix + "weight" not in got
    jm = _jax_model(float_trees)
    jm.quantize_base_for_train()
    port.quantize_base_for_train()
    port.load_state_dict(state_dict_from_jax(_np(jm.params)), strict=True)


@pytest.mark.parametrize("task", ("lora", "qformer_freeze_lora"))
def test_trainable_counts_match_jax(float_trees, task):
    jm, port = _int8_base_pair(float_trees, task)
    assert port.trainable_param_count() == trainable_param_count(jm.params,
                                                                 jm.trainable_mask())
    ctx = TrainCtx(port)
    names = {id(p): n for n, p in port.module.named_parameters()}
    in_optimizer = [p for g in ctx.optimizer.param_groups for p in g["params"]]
    assert in_optimizer and all(p.dtype == torch.float32 for p in in_optimizer)
    assert all("lora_" in names[id(p)] for p in in_optimizer if names[id(p)].startswith("t5."))
    int8 = [b for b in port.module.buffers() if b.dtype == torch.int8]
    assert int8 and not {id(b) for b in int8} & {id(p) for p in in_optimizer}


@pytest.mark.parametrize("task", ("qformer_freeze_lora", QA_TASK))
def test_int8_base_loss_matches_jax(float_trees, task):
    jm, port = _int8_base_pair(float_trees, task)
    samples = _samples(seed=2)
    want, _ = jax.jit(jm._loss_fn)(jm.params, _jax_batch(jm, samples))
    got = float(port.loss(port.prepare_mr_batch(samples)).detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(want), rtol=1e-4)


def test_three_steps_match_jax(float_trees):
    """Three ``TrainCtx`` steps against JAX ``make_train_step`` (AdamW,
    weight decay 0.05, lr 1e-3), a new batch each: losses and LoRA tensors
    within 1e-4, every int8 weight untouched on both sides."""
    jm, port = _int8_base_pair(float_trees)
    mask = jm.trainable_mask()
    state = TrainState.create(jm.params, make_optimizer(weight_decay=0.05,
                                                        trainable_mask=mask))
    step = make_train_step(lambda p, b, r: jm._loss_fn(p, b, None), donate=False,
                           trainable_mask=mask)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    ctx = TrainCtx(port, weight_decay=0.05, seed=0)
    ctx.set_lr(1e-3)
    for i in range(3):
        samples = _samples(seed=10 + i)
        state, loss_want = step(state, _jax_batch(jm, samples), 1e-3, jax.random.PRNGKey(i))
        loss = ctx.step(port.prepare_mr_batch(samples))
        np.testing.assert_allclose(loss, float(loss_want), atol=ATOL)
    assert ctx.updates == 3
    want = state_dict_from_jax(_np(state.params))
    got = port.state_dict()
    trains = port.trainable_mask()
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name.endswith(("kernel_q", "kernel_scale")):
            assert torch.equal(got[name], w) and torch.equal(got[name], before[name]), name
        else:
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=ATOL, err_msg=name)
            assert trains.get(name, False) != torch.equal(got[name], before[name]), name


def _float_copies_saved(fn, int8_shapes):
    """Runs ``fn`` under saved-tensor hooks -> the floating-point tensors it
    saved for the backward whose shape is that of an int8 weight."""
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, [s for s in saved if s[0].is_floating_point and s[1] in int8_shapes]


def test_backward_keeps_no_float_copy_of_an_int8_weight(float_trees):
    """The int8 product saves ``kernel_q`` and its scales, never a float
    tensor of a frozen weight's shape; the plain ``x.float() @
    kernel_q.float()`` would, and the hook sees it there. The gradients reach
    every LoRA tensor."""
    port = _port_model(float_trees, "qformer_freeze_lora")
    port.quantize_base_for_train()
    ctx = TrainCtx(port)
    int8 = {n: b for n, b in port.module.named_buffers() if n.endswith("kernel_q")}
    shapes = {tuple(b.shape) for b in int8.values()} | {tuple(b.t().shape)
                                                         for b in int8.values()}
    batch = port.prepare_mr_batch(_samples(b=2, seed=3))
    port.train()
    loss, copies = _float_copies_saved(lambda: port.loss(batch), shapes)
    assert not copies
    loss.backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0) for p in ctx.params)
    q = int8["t5.encoder.block.0.self_attention.q.kernel_q"]
    x = torch.randn(3, q.shape[0], requires_grad=True)
    _, copies = _float_copies_saved(lambda: x @ q.float(), shapes)
    assert copies == [(torch.float32, tuple(q.shape))]


def test_int8_product_gradient_is_the_dequantized_weight_s(float_trees):
    """The input gradient of a quantized ``Dense`` equals autograd's through
    the dequantized fp32 weight; the forward is the plain product's."""
    port = _port_model(float_trees)
    port.quantize_base_for_train()
    dense = port.module.t5.decoder.block[1].ff.wo
    w = dense.kernel_q.float() * dense.kernel_scale
    x = torch.randn(2, 5, w.shape[0], requires_grad=True)
    x_ref = x.detach().clone().requires_grad_(True)
    y = dense(x)
    y_ref = dense(x_ref.detach())  # no graph: the plain product
    assert torch.equal(y.detach(), y_ref)
    g = torch.randn_like(y)
    y.backward(g)
    (x_ref @ w + (x_ref @ dense.lora_a) @ dense.lora_b * dense.lora_scaling).backward(g)
    np.testing.assert_allclose(x.grad.numpy(), x_ref.grad.numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- from_config
def _cfg(**kw):
    return dict(dict(arch="blip2_mr", model_type="tiny", vit_model="tiny", image_size=28,
                     t5_model="tiny", compute_dtype="float32", num_beams=1,
                     max_new_tokens=4), **kw)


def test_from_config_int8_base_on_a_qa_task_converts_both_stacks():
    port = BLIP2_MR.from_config(_cfg(task=QA_TASK, int8_base=True), device="cpu")
    jm = JaxBLIP2_MR.from_config(_cfg(task=QA_TASK, int8_base=True, scan_layers=False,
                                      params_dtype="float32"))
    assert port.t5_config.int8_base and jm.t5_config.int8_base
    sd = port.state_dict()
    assert sd.keys() == state_dict_from_jax(_np(jm.params), _np(jm.answerer_params)).keys()
    for stack in ("t5", "answerer_t5"):
        for section in ("encoder", "decoder"):
            assert sd[f"{stack}.{section}.block.1.ff.wi_0.kernel_q"].dtype == torch.int8
        assert f"{stack}.lm_head.kernel_q" in sd and f"{stack}.lm_head.weight" not in sd
        assert not any(k.startswith(f"{stack}.") and k.endswith(".weight") and ".block." in k
                       and ("attention." in k or ".ff." in k) for k in sd)


@pytest.mark.parametrize("flags", [
    dict(task="qformer_freeze"),  # no LoRA: nothing would train
    dict(int8_decode=True),
    dict(int8_encoder=True),
    dict(int8_inference=True),
])
def test_from_config_int8_base_raises_where_jax_raises(float_trees, flags):
    """JAX asserts LoRA and finds no float kernel to quantize after an
    earlier int8 conversion of the T5; the port raises on both too. The JAX
    side is ``from_config``'s order of conversions on a model holding the
    float trees."""
    task = flags.get("task", "lora")
    jm = _jax_model(float_trees, task)
    with pytest.raises((AssertionError, KeyError)):
        if flags.get("int8_inference"):
            jm.quantize_for_inference()
        if flags.get("int8_decode"):
            jm.quantize_for_decode()
        if flags.get("int8_encoder"):
            jm.quantize_encoder()
        jm.quantize_base_for_train()
    with pytest.raises((ValueError, RuntimeError)):
        BLIP2_MR.from_config(_cfg(int8_base=True, **dict(dict(task="lora"), **flags)),
                             device="cpu")


def test_int8_base_generates_like_jax(float_trees):
    """The QLoRA model's validation generate: identical predictions."""
    jm, port = _int8_base_pair(float_trees)
    samples = _samples(b=2, seed=5)
    assert port.generate(samples)["raw_prediction"] == jm.generate(samples)["raw_prediction"]


# ------------------------------------------------------------- int8 ViT
def test_train_step_through_the_int8_vit(float_trees):
    """``tests/test_int8_vit.py::test_train_step_through_quantized_vit`` on
    the port: two steps through the W8A8 ViT (run without a graph) leave
    every ViT tensor bit-equal and move the trained ones; the optimizer,
    built before the ViT's ``rebuild_submodule``, still holds the model's
    tensors. The losses against JAX: ``test_train_entry_point_matches_jax``."""
    port = _port_model(float_trees)
    ctx = TrainCtx(port, weight_decay=0.05, seed=0)
    port.quantize_vit()
    params = {id(p) for p in port.module.parameters()}
    assert all(id(p) in params for g in ctx.optimizer.param_groups for p in g["params"])
    assert all(not p.requires_grad for p in port.module.visual_encoder.parameters())
    vit_before = {k: v.clone() for k, v in port.module.visual_encoder.state_dict().items()}
    trained_before = {n: p.detach().clone() for n, p in ctx.named_params.items()}
    ctx.set_lr(1e-2)
    batch = port.prepare_mr_batch(_samples(b=2, seed=7))
    losses = [ctx.step(batch) for _ in range(2)]
    assert all(np.isfinite(losses)) and ctx.updates == 2
    for key, value in port.module.visual_encoder.state_dict().items():
        assert torch.equal(value, vit_before[key]), key
    assert any(k.endswith("kernel_q") for k in vit_before)
    moved = [not torch.equal(p.detach(), trained_before[n]) for n, p in ctx.named_params.items()]
    assert all(moved) and any(n.startswith("qformer.") for n in ctx.named_params)


# ------------------------------------------------------------- entry point
def _options(synth, out_dir):
    return [*(f"datasets.qvh.build_info.annotations.{s}.storage={synth}/{s}.json"
              for s in ("train", "val", "test")),
            f"run.output_dir={out_dir}", "run.num_workers=1", "run.batch_size_train=4",
            "run.max_epoch=1", "run.valid_splits=[]", "run.test_splits=[]"]


class _OneDevice(JaxRunnerBase):
    mesh = None  # train.py's run on one device (no dp mesh, no padded rows)


def _losses(out_dir):
    (job,) = [p for p in Path(out_dir).iterdir() if p.is_dir()]
    import json
    events = [json.loads(line) for line in (job / "events.jsonl").read_text().splitlines()]
    return job, [e["train/loss"] for e in events if "train/loss" in e]


def test_train_entry_point_matches_jax(tmp_path):
    """``configs/projects/train/tiny_synthetic.yaml`` with ``model.int8_base=True``
    and ``model.int8_vit=True`` (one run: each JAX run compiles its train
    step for ~9 s): the JAX runner (the float model redrawn, then converted
    as its ``from_config`` converts, the ViT first) against
    ``mr_blip_tpu_torch.train.main`` on the converted float weights, dropout
    off: per-step losses within the int8 ViT's bar.
    The resume state the port wrote restores every int8 weight bit-equal
    into a model built from other weights."""
    make_mr_annotations(str(tmp_path / "synth"), n_train=8, n_val=1, n_test=1,
                        n_video_frames=20, fps=5.0, height=48, width=64)
    cfg = JaxConfig(cfg_path=TINY_CFG, options=[
        *_options(tmp_path / "synth", tmp_path / "jax"), "model.params_dtype=float32"])
    random.seed(42)
    np.random.seed(42)
    task = jax_tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    params = _redraw(unstack_blip2_mr_params(model.params), 31)
    model.params = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    ckpt = tmp_path / "converted.pt"
    torch.save(state_dict_from_jax(params), ckpt)
    model.quantize_vit()
    model.quantize_base_for_train()
    runner = _OneDevice(cfg=cfg, job_id="job", task=task, model=model, datasets=datasets)
    runner.train_ctx._step_fn = make_train_step(
        lambda p, b, r: model._loss_fn(p, b, None), donate=True,
        trainable_mask=model.trainable_mask())
    runner.train()

    runners = []
    from_config, train_fn = BLIP2_MR.from_config.__func__, RunnerBase.train

    def no_dropout(cls, cfg, device="cuda"):
        return _no_dropout(from_config(cls, cfg, device=device))

    def captured(self):
        runners.append(self)
        return train_fn(self)

    patches = ((BLIP2_MR, "from_config", classmethod(no_dropout)),
               (RunnerBase, "train", captured))
    originals = [(cls, name, cls.__dict__[name]) for cls, name, _ in patches]
    for cls, name, value in patches:
        setattr(cls, name, value)
    try:
        train.main(["--cfg-path", TINY_CFG, "--options",
                    *_options(tmp_path / "synth", tmp_path / "port"), "run.device=cpu",
                    f"model.finetuned={ckpt}", "model.load_finetuned=True",
                    "model.int8_base=True", "model.int8_vit=True"])
    finally:
        for cls, name, value in originals:
            setattr(cls, name, value)
    (port_runner,) = runners
    jax_losses = _losses(tmp_path / "jax")[1]
    job, losses = _losses(tmp_path / "port")
    assert len(losses) == 2 and port_runner.train_ctx.updates == 2
    np.testing.assert_allclose(losses, jax_losses, rtol=INT8_VIT_LOSS_RTOL)

    trained = port_runner.model.state_dict()
    int8 = {k: v for k, v in trained.items() if v.dtype == torch.int8}
    assert {k.split(".")[0] for k in int8} == {"visual_encoder", "t5"}
    fresh = BLIP2_MR.from_config(_cfg(task="lora", max_new_tokens=12, num_beams=2,
                                      int8_base=True, int8_vit=True), device="cpu")
    assert not all(torch.equal(fresh.state_dict()[k], v) for k, v in int8.items())
    resumed = RunnerBase(cfg=port_runner.config, job_id="resume", task=port_runner.task,
                         model=fresh, datasets={})
    resumed.load_checkpoint(job / "resume_state.pth")
    restored = fresh.state_dict()
    for name, value in int8.items():
        assert torch.equal(restored[name], value), name
