"""The port's train path against the JAX package's, tiny configs, fp32, CPU.

Weights are redrawn from numpy seeds and converted with
``state_dict_from_jax``; every dropout rate is 0 on the port's side and the
JAX side runs its deterministic loss, so the two compute the same function.
Tolerance 1e-4 (the bar of the repo's torch parity tests) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mr_blip_tpu.common import optims as joptims
from mr_blip_tpu.models import t5 as jt5
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.runners.train_state import (
    TrainState,
    make_optimizer,
    make_train_step,
    trainable_param_count,
)
from mr_blip_tpu_torch.common import optims as toptims
from mr_blip_tpu_torch.models import t5
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.models.layers import (
    Dense,
    DropPath,
    Dropout,
    set_dropout_generator,
)
from mr_blip_tpu_torch.runners.train_state import TrainCtx

ATOL = 1e-4
TASKS = ("lora", "qformer_freeze", "qformer_freeze_lora")
# QA tasks: the span loss still trains the main T5's LoRA tensors (and the
# Q-Former unless frozen); the answerer's tree is in no JAX train state.
QA_TASKS = ("lora_QA_with_localizer", "qformer_freeze_lora_QA_with_localizer")
TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=1,
            max_new_tokens=4, compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


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
        "relevant_windows": ["[[0, 10]]"] * b,
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


def _pair(task="lora", seed=0):
    """JAX and port BLIP2_MR (tiny, fp32, unscanned JAX layout) on the same
    redrawn weights; under a QA task the answerer's tree too."""
    jm = JaxBLIP2_MR(**TINY, task=task, scan_layers=False)
    jm.params = jax.tree.map(jnp.asarray, _redraw(jm.params, seed))
    answerer = None
    if jm.is_qa:
        answerer = _redraw(jm.answerer_params, seed + 1)
        jm.answerer_params = jax.tree.map(jnp.asarray, answerer)
    port = BLIP2_MR(**TINY, device="cpu", task=task, init_params=False)
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jm.params),
                                             answerer))
    return jm, _no_dropout(port)


@pytest.fixture(scope="module")
def lora_pair():
    return _pair("lora", seed=1)


def _jax_batch(jm, samples):
    batch = jm.prepare_mr_batch(samples)
    batch.pop("video_prompt")
    return batch


def test_prepare_mr_batch_targets_match_jax(lora_pair):
    jm, port = lora_pair
    samples = _samples()
    samples["relevant_windows"] = ["[[0, 10]]", "[[5, 25], [26, 29]]", "[[1, 2]]",
                                   "[[0, 30]]"]
    want = _jax_batch(jm, samples)
    got = port.prepare_mr_batch(samples)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert got["target_ids"].shape[1] % 8 == 0
    assert "target_ids" not in port.prepare_mr_batch(samples, need_targets=False)


def test_shift_right_and_lm_loss_match_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(2, 50, (3, 8)).astype(np.int32)
    labels[0, 5:] = -100
    labels[2, 1:] = -100
    mask = (labels != -100).astype(np.int32)
    logits = rng.standard_normal((3, 8, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        t5.shift_right(_t(labels), 0, 0).numpy(),
        np.asarray(jt5.shift_right(jnp.asarray(labels), 0, 0)))
    np.testing.assert_allclose(
        float(t5.cross_entropy_lm_loss(_t(logits), _t(labels), _t(mask))),
        float(jt5.cross_entropy_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                        jnp.asarray(mask))), atol=1e-6)


def test_t5_loss_and_gradients_match_jax(lora_pair):
    """``loss_from_encoder_input`` (encoder, teacher-forced decoder with a
    target mask, LM loss) and the gradient of every T5 tensor, LoRA ones
    included, against JAX; JAX gradients mapped by ``state_dict_from_jax``."""
    jm, port = lora_pair
    rng = np.random.default_rng(3)
    d = jm.t5_config.d_model
    embeds = rng.standard_normal((2, 11, d)).astype(np.float32)
    attn = np.ones((2, 11), np.int32)
    attn[1, 7:] = 0
    target = rng.integers(2, 60, (2, 8)).astype(np.int32)
    target[0, 6:] = 0
    tmask = (target != 0).astype(np.int32)

    def loss_j(params):
        loss, _ = jm.module.apply({"params": params}, jnp.asarray(embeds),
                                  jnp.asarray(attn), jnp.asarray(target),
                                  jnp.asarray(tmask),
                                  method="loss_from_encoder_input")
        return loss

    loss_want, grads = jax.jit(jax.value_and_grad(loss_j))(jm.params)
    want = state_dict_from_jax({"t5": jax.tree.map(np.asarray, grads["t5"])})
    t5_params = dict(port.module.named_parameters())
    for name, p in t5_params.items():
        p.requires_grad_(name.startswith("t5."))
    loss, _ = port.module.loss_from_encoder_input(_t(embeds), _t(attn), _t(target),
                                                  _t(tmask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), atol=ATOL)
    assert any("lora_" in name for name in want)
    for name, g in want.items():
        p = t5_params[name]
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), atol=ATOL, err_msg=name)
        p.grad = None
    port.module.requires_grad_(False)


def test_forward_loss_matches_jax(lora_pair):
    jm, port = lora_pair
    samples = _samples(b=2, seed=4)
    want = float(jm.forward(samples)["loss"])
    got = port(samples)["loss"]
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, atol=ATOL)


@pytest.mark.parametrize("task", TASKS + QA_TASKS)
def test_trainable_counts_match_jax(task):
    jm, port = _pair(task)
    trainable, total = trainable_param_count(jm.params, jm.trainable_mask())
    if jm.is_qa:  # the port holds the answerer's T5 beside the main tree
        answerer = jm.answerer_params["t5"]
        total += trainable_param_count(answerer, jax.tree.map(lambda _: False, answerer))[1]
    assert port.trainable_param_count() == (trainable, total)
    mask = port.trainable_mask()
    assert not any(m for n, m in mask.items()
                   if n.startswith(("visual_encoder", "answerer_t5")))
    if "lora" in task:
        assert all(("lora_" in n) == m for n, m in mask.items() if n.startswith("t5."))


@pytest.mark.parametrize("task", ("lora",) + QA_TASKS)
def test_train_step_matches_jax(task):
    """One ``TrainCtx.step`` against JAX ``make_train_step`` +
    ``make_optimizer`` (AdamW, weight decay 0.05 on rank >= 2, the trainable
    mask): the same loss, the same post-step weights (to 1e-4 at lr 1e-3:
    Adam's first update is lr·g/(|g| + eps), so a near-zero gradient turns
    float noise into up to ~lr of difference, and a flipped update would
    be 2e-3), frozen ones untouched. Under a QA task the step is the span
    loss through the main T5, as JAX's ``_loss_fn``, and the answerer's T5
    stays as loaded."""
    jm, port = _pair(task, seed=5)
    samples = _samples(seed=6)
    mask = jm.trainable_mask()
    tx = make_optimizer(weight_decay=0.05, trainable_mask=mask)
    state = TrainState.create(jm.params, tx)
    step = make_train_step(lambda p, b, r: jm._loss_fn(p, b, None), donate=False,
                           trainable_mask=mask)
    state, loss_want = step(state, _jax_batch(jm, samples), 1e-3, jax.random.PRNGKey(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params))

    before = {k: v.clone() for k, v in port.state_dict().items()}
    ctx = TrainCtx(port, weight_decay=0.05, seed=0)
    ctx.set_lr(1e-3)
    loss = ctx.step(port.prepare_mr_batch(samples))
    assert ctx.updates == 1
    np.testing.assert_allclose(loss, float(loss_want), atol=ATOL)
    got = port.state_dict()
    trains = port.trainable_mask()
    moved = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=ATOL,
                                   err_msg=name)
        if trains[name]:
            moved += not torch.equal(got[name], before[name])
        else:
            assert torch.equal(got[name], before[name]), name
    assert moved == sum(trains.values())
    for name in got.keys() - want.keys():  # the answerer's tree
        assert name.startswith("answerer_t5.") and torch.equal(got[name], before[name])


def test_grad_accumulation_equals_big_batch():
    """k = 2 micro-batches of 2 with accumulation give the weights of one
    batch of 4 (the loss is a token mean and every sample has as many
    target tokens, so the mean of the halves' gradients is the full one)."""
    samples = _samples(b=4, seed=7)
    halves = [{k: v[i:i + 2] for k, v in samples.items()} for i in (0, 2)]
    results = []
    for accum, batches in ((1, [samples]), (2, halves)):
        port = _no_dropout(BLIP2_MR(**TINY, device="cpu", task="lora", seed=8))
        ctx = TrainCtx(port, accum_grad_iters=accum, max_grad_norm=1.0, seed=0)
        ctx.set_lr(1e-3)
        for batch in batches:
            ctx.step(port.prepare_mr_batch(batch))
        assert ctx.updates == 1
        results.append(port.state_dict())
    for name, full in results[0].items():
        np.testing.assert_allclose(results[1][name].numpy(), full.numpy(),
                                   atol=1e-6, err_msg=name)


def test_nan_loss_raises_before_the_update():
    port = BLIP2_MR(**TINY, device="cpu", task="qformer_freeze_lora", seed=9)
    ctx = TrainCtx(port, seed=0)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.loss = lambda batch: torch.tensor(float("nan"), requires_grad=True)
    with pytest.raises(FloatingPointError, match="NaN loss"):
        ctx.step({})
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())


def _with_dropout(model, rate):
    for m in model.module.modules():
        if isinstance(m, Dropout):
            m.rate = rate
    return model


def test_generate_after_a_train_step_runs_in_eval_mode():
    """A train step leaves the model in train mode; generate still runs with
    every dropout off (the JAX generate is deterministic) and gives the
    beams and scores of a fresh model with the same weights, then restores
    train mode."""
    samples = _samples(b=2, seed=11)
    trained = _with_dropout(BLIP2_MR(**TINY, device="cpu", task="lora", seed=3), 0.3)
    ctx = TrainCtx(trained, seed=0)
    ctx.set_lr(1e-3)
    ctx.step(trained.prepare_mr_batch(samples))
    assert trained.module.training
    got = trained.generate_dispatch(samples)
    assert trained.module.training
    fresh = _with_dropout(BLIP2_MR(**TINY, device="cpu", task="lora", init_params=False), 0.3)
    fresh.load_state_dict(trained.state_dict())
    want = fresh.generate_dispatch(samples)
    assert torch.equal(got["seqs"], want["seqs"])
    assert torch.equal(got["scores"], want["scores"])


def test_mixed_dtype_state_dict_loads_strictly():
    """bf16 weights with fp32 trainable masters: the state_dict of a model
    set up for training loads with strict=True into a fresh bf16 model and
    back, and the fp32 masters stay fp32."""
    kw = dict(img_size=28, vit_model="tiny", t5_model="tiny", num_beams=1,
              max_new_tokens=4, task="qformer_freeze_lora", compute_dtype="bfloat16")
    trained = BLIP2_MR(**kw, device="cpu", seed=1)
    trained.set_trainable()
    sd = trained.state_dict()
    dtypes = {sd[n].dtype for n, m in trained.trainable_mask().items() if m}
    assert dtypes == {torch.float32}
    assert sd["t5.shared.weight"].dtype == torch.bfloat16
    fresh = BLIP2_MR(**kw, device="cpu", init_params=False)
    fresh.load_state_dict(sd, strict=True)
    trained.load_state_dict(fresh.state_dict(), strict=True)
    assert trained.state_dict()["t5.lm_head.lora_a"].dtype == torch.float32


# ------------------------------------------------------------ schedulers
@pytest.mark.parametrize("name,kw", [
    ("linear_warmup_cosine_lr", dict(max_epoch=5, min_lr=1e-6, init_lr=3e-4,
                                     warmup_steps=7, warmup_start_lr=1e-8)),
    ("linear_warmup_step_lr", dict(max_epoch=5, min_lr=1e-6, init_lr=3e-4,
                                   decay_rate=0.9, warmup_steps=4,
                                   warmup_start_lr=1e-8)),
    ("constant_lr", dict(init_lr=3e-4)),
])
def test_schedulers_identical_to_jax_package(name, kw):
    from mr_blip_tpu.common.registry import registry

    want = registry.get_lr_scheduler_class(name)(**kw)
    got = toptims.LR_SCHEDULERS[name](**kw)
    assert joptims.cosine_lr(2, 5, 1.0, 0.0) == toptims.cosine_lr(2, 5, 1.0, 0.0)
    for epoch in range(5):
        for step in range(6):
            assert got.step(cur_epoch=epoch, cur_step=step) == want.step(
                cur_epoch=epoch, cur_step=step)


# ---------------------------------------------------------------- dropout
@pytest.mark.parametrize("cls", [Dropout, DropPath])
def test_dropout_train_eval_and_generator(cls):
    x = torch.ones(64, 5, 8)
    layer = cls(0.25)
    assert torch.equal(layer.eval()(x), x)
    layer.train()
    layer.generator = torch.Generator().manual_seed(0)
    a = layer(x)
    kept = a != 0
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert 0.6 < float(kept.float().mean()) < 0.9
    if cls is DropPath:  # whole samples at once
        assert bool((kept.all(dim=(1, 2)) | ~kept.any(dim=(1, 2))).all())
    layer.generator.manual_seed(0)
    assert torch.equal(layer(x), a)
    assert torch.equal(cls(0.0).train()(x), x)


def test_lora_dropout_acts_in_train_mode_only():
    torch.manual_seed(0)
    dense = Dense(8, 6, bias=False, lora_rank=2, lora_dropout=0.5)
    with torch.no_grad():
        dense.lora_a.normal_()
        dense.lora_b.normal_()
    x = torch.randn(3, 8)
    base = x @ dense.weight.T
    full = base + x @ dense.lora_a @ dense.lora_b * dense.lora_scaling
    assert torch.allclose(dense.eval()(x), full, atol=1e-6)
    dense.train()
    set_dropout_generator(dense, torch.Generator().manual_seed(1))
    y = dense(x)
    assert not torch.allclose(y, full, atol=1e-3)
    set_dropout_generator(dense, torch.Generator().manual_seed(1))
    assert torch.equal(dense(x), y)


def test_model_dropouts_follow_train_mode_and_generator():
    """In train mode the T5, LoRA and Q-Former dropouts change the loss and
    are reproducible from the generator; eval mode is deterministic."""
    port = BLIP2_MR(**TINY, device="cpu", task="lora", seed=2)
    batch = port.prepare_mr_batch(_samples(b=2, seed=10))
    with torch.no_grad():
        eval_loss = float(port.loss(batch))
        gen = torch.Generator().manual_seed(5)
        set_dropout_generator(port.module, gen)
        port.train()
        a = float(port.loss(batch))
        gen.manual_seed(5)
        b = float(port.loss(batch))
        gen.manual_seed(6)
        c = float(port.loss(batch))
        port.eval()
        assert float(port.loss(batch)) == eval_loss
    assert a == b and a != c and a != eval_loss
