"""The unfrozen-ViT train path (``freeze_vit: False``) of the port against
the JAX package's, on the CPU, at the tiny widths in fp32.

Weights are drawn from a numpy seed and carried over by
``state_dict_from_jax``; dropout and stochastic depth are off on both sides
(the JAX side runs its deterministic loss) wherever the two are compared.
Tolerance 1e-4 (the bar of the repo's torch parity tests) unless stated.

As in the JAX package, stochastic depth and ViT checkpointing reach the EVA
ViT-g only (the tiny ViT takes neither); they are held here on the ViT
module itself, and through a tiny model whose ViT is rebuilt with them.

The two-rank cases run this file as a script under ``torch.distributed.run``
(``gloo``, no JAX in the workers), with the helpers of ``test_torch_dp.py``,
against the JAX package's dp=2 mesh steps on two virtual CPU devices.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dp import (  # noqa: E402
    LR,
    _dp_micro_batches,
    _rows,
    _sp_samples,
    finish,
    launch,
)

TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", task="lora", num_beams=2,
            max_new_tokens=8, compute_dtype="float32")
# (name, sequence_parallel, accum_grad_iters)
DP_CASES = (("dp", False, 2), ("sp", True, 1))


def _worker(workdir: Path):
    """One rank: the dp and sp updates of the unfrozen model, results to
    ``out_rank<r>.pt``."""
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.models.layers import Dropout
    from mr_blip_tpu_torch.parallel.mesh import assert_replicated
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    dist_utils.init_distributed_mode({"device": "cpu", "dist_timeout_s": 60})
    rank = dist_utils.get_rank()
    state_dict = torch.load(workdir / "weights.pt", weights_only=True)
    out = {}
    for name, sp, accum in DP_CASES:
        model = BLIP2_MR(**TINY, device="cpu", init_params=False, sequence_parallel=sp,
                         freeze_vit=False)
        model.load_state_dict(state_dict)
        for m in model.module.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        batches = ([_sp_samples()] if sp else
                   [_rows(s, 2 * rank, 2 * rank + 2) for s in _dp_micro_batches()])
        ctx = TrainCtx(model, accum_grad_iters=accum, seed=0)
        ctx.set_lr(LR)
        losses = [ctx.step(model.prepare_mr_batch(b)) for b in batches]
        out[name] = {"losses": losses, "updates": ctx.updates,
                     "fingerprint": assert_replicated(ctx.named_params, name),
                     "state": {k: v.clone() for k, v in model.state_dict().items()}}
    torch.save(out, workdir / f"out_rank{rank}.pt")
    dist_utils.destroy()


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
    sys.exit(0)


# ------------------------------------------------------------------- tests
import os  # noqa: E402
import signal  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from flax import linen as jnn  # noqa: E402
from flax import traverse_util  # noqa: E402

from mr_blip_tpu.models import eva_vit as jvit  # noqa: E402
from mr_blip_tpu.models.blip2_fmr import Blip2FMR as JaxFMR  # noqa: E402
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR  # noqa: E402
from mr_blip_tpu.models.blip2_mr_opt import BLIP2_MR_OPT as JaxOPT  # noqa: E402
from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase  # noqa: E402
from mr_blip_tpu.runners.train_state import (  # noqa: E402
    TrainState,
    make_optimizer,
    make_train_step,
    trainable_param_count,
)
from mr_blip_tpu_torch import tasks  # noqa: E402
from mr_blip_tpu_torch.common import preempt  # noqa: E402
from mr_blip_tpu_torch.common.config import Config  # noqa: E402
from mr_blip_tpu_torch.common.registry import registry  # noqa: E402
from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations  # noqa: E402
from mr_blip_tpu_torch.models import blip2_mr_module  # noqa: E402
from mr_blip_tpu_torch.models.blip2_fmr import Blip2FMR  # noqa: E402
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR  # noqa: E402
from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT  # noqa: E402
from mr_blip_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from mr_blip_tpu_torch.models.eva_vit import (  # noqa: E402
    EvaViT,
    ViTBlock,
    drop_path_rates,
    vit_tiny_config,
)
from mr_blip_tpu_torch.models.layers import Dropout, set_dropout_generator  # noqa: E402
from mr_blip_tpu_torch.runners.train_state import TrainCtx  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
OPT_TINY = dict(opt_model="tiny", img_size=28, vit_model="tiny", task="lora",
                num_beams=2, max_new_tokens=6, compute_dtype="float32")
KINDS = {  # kind -> (JAX class, port class, constructor settings)
    "blip2_mr": (JaxBLIP2_MR, BLIP2_MR, TINY),
    "qformer_freeze": (JaxBLIP2_MR, BLIP2_MR, dict(TINY, task="qformer_freeze_lora")),
    "opt": (JaxOPT, BLIP2_MR_OPT, OPT_TINY),
    "fmr": (JaxFMR, Blip2FMR, TINY),
}


def _samples(b=2, t=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "video": rng.integers(0, 256, (b, t, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.tile(np.arange(t, dtype=np.float64) * 8.0, (b, 1)),
        "duration": np.full((b,), 30.0),
        "query_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": ["Query: a cat jumps\n", "Query: someone opens a door\n"][:b],
        "task_prompt": ["Relevant windows: "] * b,
        "relevant_windows": ["[[0, 10]]", "[[4, 12], [20, 30]]"][:b],
        "loc_input": ["Question: a cat jumps?", "Question: a door?"][:b],
        "qa_output": ["_".join(["yes", "no", "no"][:t])] * b,
    }


def _redraw(params, seed):
    """Every leaf from a numpy seed (norm scales near one)."""
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


@pytest.fixture
def _jax_keeps_uint8(monkeypatch):
    """The JAX OPT and fmr batches cast uint8 frames to float32, so its ViT
    would see them unnormalized (the port normalizes them, ROADMAP Queue 3):
    hand the JAX model the uint8 frames, which its module normalizes."""
    for cls, name in ((JaxOPT, "prepare_opt_batch"), (JaxFMR, "_prepare")):
        real = getattr(cls, name)

        def keep(self, samples, *args, _real=real, **kwargs):
            batch = _real(self, samples, *args, **kwargs)
            batch["frames"] = np.asarray(samples["video"])
            return batch

        monkeypatch.setattr(cls, name, keep)


@functools.lru_cache(maxsize=None)
def _jax_model(kind):
    """The JAX model of ``kind`` with the ViT unfrozen, weights redrawn."""
    jcls, _, cfg = KINDS[kind]
    jm = jcls(**cfg, freeze_vit=False, scan_layers=False, init_params=False)
    tree = jm.init_params_fast(jax.random.PRNGKey(0), dtype=jnp.float32)
    jm.params = jax.tree.map(jnp.asarray, _redraw(tree, 1))
    return jm


def _pair(kind):
    """(JAX model, port model) with the ViT unfrozen, on the same weights."""
    jm = _jax_model(kind)
    _, pcls, cfg = KINDS[kind]
    pm = pcls(**cfg, freeze_vit=False, init_params=False, device="cpu")
    pm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jm.params)))
    return jm, _no_dropout(pm)


def _jax_batch(jm, samples):
    batch = (jm._prepare(samples, with_targets=True) if isinstance(jm, JaxFMR)
             else jm.prepare_mr_batch(samples))
    batch.pop("video_prompt", None)
    return batch


def _jax_loss(jm):
    if isinstance(jm, JaxFMR):
        return lambda p, batch: jm._jit_fmr_loss(p, batch)
    return lambda p, batch: jm._loss_fn(p, batch, None)[0]


def _port_loss(pm, samples):
    if isinstance(pm, Blip2FMR):
        return pm(samples)["loss"]
    return pm.loss(pm.prepare_mr_batch(samples))


# -------------------------------------------------- loss, gradients, step
@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_and_every_vit_gradient_equal_jax(kind, _jax_keeps_uint8):
    """The loss and the gradient of every trainable tensor, every ViT tensor
    among them (each nonzero), against ``jax.value_and_grad`` of the JAX
    loss on the same weights; ``blip2_fmr`` through what it inherits."""
    jm, pm = _pair(kind)
    samples = _samples()
    loss_want, grads = jax.jit(jax.value_and_grad(_jax_loss(jm)))(
        jm.params, _jax_batch(jm, samples))
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    pm.set_trainable()
    loss = _port_loss(pm, samples)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), atol=ATOL)
    vit = 0
    for name, p in pm.module.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=ATOL,
                                   err_msg=name)
        if name.startswith("visual_encoder."):
            vit += 1
            assert float(p.grad.abs().max()) > 0, name
    assert vit == sum(n.startswith("visual_encoder.") for n, _ in
                      pm.module.named_parameters()) > 0


@pytest.mark.parametrize("kind", ["blip2_mr", "opt"])
def test_train_step_and_trainable_counts_equal_jax(kind, _jax_keeps_uint8):
    """One ``TrainCtx.step`` against JAX ``make_train_step`` +
    ``make_optimizer`` with the JAX mask (the ViT in it): the loss, every
    tensor after the update (to 1e-4 at lr 1e-3, as in
    ``test_torch_train.py``), every trainable one moved, every frozen one as
    loaded; the trainable and total counts equal the JAX mask's."""
    jm, pm = _pair(kind)
    mask = jm.trainable_mask()
    assert pm.trainable_param_count() == trainable_param_count(jm.params, mask)
    samples = _samples(seed=6)
    tx = make_optimizer(weight_decay=0.05, trainable_mask=mask)
    state = TrainState.create(jm.params, tx)
    step = make_train_step(lambda p, b, r: (_jax_loss(jm)(p, b), None), donate=False,
                           trainable_mask=mask)
    state, loss_want = step(state, _jax_batch(jm, samples), 1e-3, jax.random.PRNGKey(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params))

    before = {k: v.clone() for k, v in pm.state_dict().items()}
    ctx = TrainCtx(pm, weight_decay=0.05, seed=0)
    ctx.set_lr(1e-3)
    loss = ctx.step(pm.prepare_mr_batch(samples))
    np.testing.assert_allclose(loss, float(loss_want), atol=ATOL)
    got, trains = pm.state_dict(), pm.trainable_mask()
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=ATOL, err_msg=name)
        assert torch.equal(got[name], before[name]) != trains[name], name
    assert all(trains[n] for n in trains if n.startswith("visual_encoder."))
    vit = [p for n, p in pm.module.named_parameters() if n.startswith("visual_encoder.")]
    assert all(p.dtype == torch.float32 and p.requires_grad for p in vit)
    # AdamW's groups: decay on rank >= 2 (the patch conv, cls_token and
    # pos_embed too, as the JAX ``wd_mask_fn``), none below
    decay, no_decay = ctx.optimizer.param_groups
    assert {id(p) for p in vit if p.ndim >= 2} <= {id(p) for p in decay["params"]}
    assert {id(p) for p in vit if p.ndim < 2} <= {id(p) for p in no_decay["params"]}


def test_frozen_vit_builds_no_graph_and_unfrozen_does(monkeypatch):
    """``encode_flat`` runs a frozen ViT under ``no_grad`` and a trained one
    with a graph; the OPT variant likewise."""
    seen = []
    real = EvaViT.forward
    monkeypatch.setattr(EvaViT, "forward",
                        lambda self, x: seen.append(torch.is_grad_enabled()) or real(self, x))
    for cls, cfg in ((BLIP2_MR, TINY), (BLIP2_MR_OPT, OPT_TINY)):
        for freeze in (True, False):
            model = cls(**cfg, freeze_vit=freeze, device="cpu")
            model.set_trainable()
            assert blip2_mr_module.vit_trains(model.module) is not freeze
            model.loss(model.prepare_mr_batch(_samples())).backward()
            assert seen.pop() is not freeze
    assert not seen


# ----------------------------------------------- stochastic depth, remat
def _vit_pair(rate, depth=5, checkpoint=False, int8=False):
    """The JAX and port EvaViT at the tiny widths with ``depth`` blocks and
    ``rate``, unrolled; the JAX params and the port module on them."""
    cfg = dataclasses.replace(vit_tiny_config(), depth=depth, drop_path_rate=rate,
                              use_checkpoint=checkpoint)
    jcfg = dataclasses.replace(jvit.vit_tiny_config(), depth=depth, drop_path_rate=rate,
                               use_checkpoint=checkpoint, scan_layers=False)
    jmod = jvit.EvaViT(jcfg, compute_dtype=jnp.float32)
    images = jnp.zeros((1, 28, 28, 3), jnp.float32)
    params = _redraw(jmod.init(jax.random.PRNGKey(0), images)["params"], 3)
    port = EvaViT(cfg, dtype=torch.float32)
    port.load_state_dict({k[len("visual_encoder."):]: v for k, v in
                          state_dict_from_jax({"visual_encoder": params}).items()})
    return jmod, params, port


def test_drop_path_ramp_equals_jax_block_by_block():
    """Each block's rate is the JAX ViT's (captured from its DropPath calls
    in train mode): drop_path_rate * i / max(depth - 1, 1)."""
    jmod, params, port = _vit_pair(0.4)
    rates = {}

    def capture(next_fun, args, kwargs, context):
        if isinstance(context.module, jvit.DropPath):
            block = context.module.scope.path[-2]
            rates.setdefault(block, context.module.rate)
        return next_fun(*args, **kwargs)

    images = jnp.asarray(np.random.default_rng(0).standard_normal((2, 28, 28, 3)),
                         jnp.float32)
    with jnn.intercept_methods(capture):
        jmod.apply({"params": params}, images, deterministic=False,
                   rngs={"drop_path": jax.random.PRNGKey(1)})
    want = [rates[f"blocks_{i}"] for i in range(5)]
    got = [blk.drop_path.rate for blk in port.blocks]
    assert got == drop_path_rates(port.cfg) == pytest.approx(want, abs=1e-7)
    assert got[0] == 0.0 and got[-1] == pytest.approx(0.4)
    # eval mode is the identity: both equal the JAX deterministic ViT
    want_eval = np.asarray(jmod.apply({"params": params}, images))
    with torch.no_grad():
        got_eval = port.eval()(torch.from_numpy(np.array(images)))
    np.testing.assert_allclose(got_eval.numpy(), want_eval, atol=ATOL)


class _Const(torch.nn.Module):
    """A residual branch that returns ``value`` everywhere."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    def forward(self, h, **kwargs):
        return torch.full_like(h, self.value)


def test_drop_path_drops_whole_frames_and_scales_survivors():
    """With branches of constant output 1 (attention) and 2 (MLP) and rate
    0.5, each frame's output in train mode is 0, 2, 4 or 6 everywhere (each
    branch kept whole and doubled, or dropped whole), all four occur over 64
    frames, and eval mode is 3 (no stochastic depth)."""
    cfg = vit_tiny_config()
    block = ViTBlock(cfg, drop_path=0.5, dtype=torch.float32)
    block.attn, block.mlp = _Const(1.0), _Const(2.0)
    x = torch.zeros(64, 5, cfg.embed_dim)
    assert torch.equal(block.eval()(x), torch.full_like(x, 3.0))
    block.train()
    block.drop_path.generator = torch.Generator().manual_seed(3)
    y = block(x)
    per_frame = y[:, :1, :1].expand_as(y)
    assert torch.equal(y, per_frame)
    assert set(y[:, 0, 0].tolist()) == {0.0, 2.0, 4.0, 6.0}
    block.drop_path.generator.manual_seed(3)
    assert torch.equal(block(x), y)


def test_vit_checkpointing_gradients_equal_the_plain_ones():
    """With stochastic depth sampling in train mode, the ViT's output and
    every gradient with ``use_checkpoint`` equal those without (the drop
    masks replayed in the recompute)."""
    images = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 28, 28, 3)).astype(np.float32))
    results = []
    for checkpoint in (False, True):
        _, _, vit = _vit_pair(0.5, checkpoint=checkpoint)
        vit.train()
        set_dropout_generator(vit, torch.Generator().manual_seed(7))
        out = vit(images)
        (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
        results.append((out.detach(), {n: p.grad for n, p in vit.named_parameters()}))
    (out0, g0), (out1, g1) = results
    assert torch.equal(out0, out1)
    for name, g in g0.items():
        torch.testing.assert_close(g1[name], g, atol=1e-6, rtol=0, msg=name)
    # the masks dropped some frames' branches: the output differs from eval mode
    _, _, vit = _vit_pair(0.5)
    with torch.no_grad():
        assert not torch.allclose(vit.eval()(images), out0, atol=1e-4)


def _with_vit(model, drop_path_rate, use_checkpoint):
    """``model`` with its ViT rebuilt on the same weights with stochastic
    depth and checkpointing (what the EVA ViT-g gets from the constructor)."""
    module = model.module
    cfg = dataclasses.replace(model.vit_config, drop_path_rate=drop_path_rate,
                              use_checkpoint=use_checkpoint)
    vit = EvaViT(cfg, device="cpu", dtype=model.compute_dtype)
    vit.load_state_dict(module.visual_encoder.state_dict())
    module.visual_encoder = vit.train(module.training)
    model.vit_config = module.vit_config = cfg
    return model


def test_train_step_with_vit_checkpointing_equals_without():
    """Dropout and stochastic depth on, two updates over accum 2: the
    weights with the ViT checkpointed equal those without."""
    states = []
    for checkpoint in (False, True):
        model = _with_vit(BLIP2_MR(**TINY, freeze_vit=False, seed=4, device="cpu"), 0.3,
                          checkpoint)
        ctx = TrainCtx(model, accum_grad_iters=2, seed=0)
        ctx.set_lr(1e-3)
        for i in range(4):
            ctx.step(model.prepare_mr_batch(_samples(seed=20 + i)))
        states.append(model.state_dict())
    for name, want in states[0].items():
        torch.testing.assert_close(states[1][name], want, atol=1e-6, rtol=0, msg=name)


def test_rank_stream_reseeds_the_vit_and_qformer_dropouts():
    """Under sp the ViT's stochastic depth and the Q-Former's dropouts draw
    from a rank's own stream, the shared stream set back after."""
    model = _with_vit(BLIP2_MR(**TINY, freeze_vit=False, device="cpu"), 0.5, False)
    gen = torch.Generator().manual_seed(9)
    set_dropout_generator(model.module, gen)
    model.train()
    module = model.module
    frames = torch.from_numpy(_samples(b=1, t=6)["video"][0])
    draws = {}
    for rank in (0, 1, None):
        state = gen.get_state()
        with torch.no_grad(), blip2_mr_module._rank_stream(
                (module.visual_encoder, module.qformer), rank):
            draws[rank] = module.encode_flat(frames)
        assert torch.equal(gen.get_state(), state) == (rank is not None)
        gen.set_state(state)
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[None])


# ------------------------------------------------------------------ int8
def test_int8_vit_unfrozen_fails_as_the_jax_package():
    """The JAX int8 ViT block asserts in train mode under stochastic depth;
    the port's raises ``ValueError`` there, and a model with the int8 ViT
    and ``freeze_vit=False`` refuses ``TrainCtx`` before its first step
    (its int8 kernels are forward only), while it still generates."""
    cfg = dataclasses.replace(jvit.vit_tiny_config(), depth=3, drop_path_rate=0.4,
                              int8_matmul=True, scan_layers=False)
    jmod = jvit.EvaViT(cfg, compute_dtype=jnp.float32)
    images = jnp.zeros((1, 28, 28, 3), jnp.float32)
    params = jmod.init(jax.random.PRNGKey(0), images)["params"]
    with pytest.raises(AssertionError, match="int8_matmul has no drop_path"):
        jmod.apply({"params": params}, images, deterministic=False,
                   rngs={"drop_path": jax.random.PRNGKey(1)})
    port = EvaViT(dataclasses.replace(vit_tiny_config(), depth=3, drop_path_rate=0.4,
                                      int8_matmul=True))
    with torch.no_grad():
        port.eval()(torch.zeros(1, 28, 28, 3))
        with pytest.raises(ValueError, match="no stochastic depth"):
            port.train()(torch.zeros(1, 28, 28, 3))

    model = BLIP2_MR(**TINY, freeze_vit=False, device="cpu").quantize_vit()
    assert len(model.generate(_samples())["prediction"]) == 2
    with pytest.raises(ValueError, match="int8 ViT"):
        TrainCtx(model)
    frozen = BLIP2_MR(**TINY, device="cpu").quantize_vit()
    TrainCtx(frozen).step(frozen.prepare_mr_batch(_samples()))


# --------------------------------------------------- runner, checkpoints
def _runner(tmp_path, job_id, options=()):
    data = tmp_path / "data"
    if not data.exists():
        make_mr_annotations(str(data), n_train=4, n_val=2, n_test=2,
                            n_video_frames=10, fps=5.0, height=48, width=64)
    cfg = Config(cfg_path=str(REPO / "configs/projects/train/tiny_synthetic.yaml"),
                 options=[*(f"datasets.qvh.build_info.annotations.{s}.storage={data}/{s}.json"
                            for s in ("train", "val", "test")),
                          f"run.output_dir={tmp_path}/out", "run.num_workers=1",
                          "run.batch_size_train=2", "run.batch_size_eval=2",
                          "run.device=cpu", "model.freeze_vit=False", *options])
    task = tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg)
    runner_cls = registry.get_runner_class(cfg.run_cfg.get("runner", "runner_base"))
    return runner_cls(cfg=cfg, job_id=job_id, task=task, model=model, datasets=datasets)


def test_checkpoint_holds_the_jax_runners_trainable_keys(tmp_path):
    """``checkpoint_best.pth`` of ``model.freeze_vit=False`` holds, tensor
    for tensor, the names the JAX runner's ``_trainable_only`` keeps (its
    "/"-joined paths converted), the ViT's among them."""
    runner = _runner(tmp_path, "ckpt")
    assert not runner.model.freeze_vit
    ctx = runner.train_ctx
    ctx.set_lr(1e-3)
    runner.task.train_step(ctx, _samples())
    runner._save_checkpoint(cur_epoch=0, is_best=True)
    saved = torch.load(runner.output_dir / "checkpoint_best.pth", weights_only=True)["model"]
    jm = JaxBLIP2_MR(**dict(TINY, task=runner.model.task), freeze_vit=False,
                     scan_layers=False, init_params=False)
    tree = jm.init_params_fast(jax.random.PRNGKey(0), dtype=jnp.float32)
    kept = JaxRunnerBase._trainable_only(types.SimpleNamespace(model=jm), tree)
    tree = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in kept.items()})
    want = set(state_dict_from_jax(tree))
    assert set(saved) == want
    assert sum(n.startswith("visual_encoder.") for n in want) == sum(
        n.startswith("visual_encoder.") for n, _ in runner.model.module.named_parameters())
    params = dict(runner.model.module.named_parameters())
    assert all(torch.equal(v, params[n].detach()) for n, v in saved.items())


def test_sigterm_resume_mid_window_is_bit_equal(tmp_path):
    """accum_grad_iters 4, dropout and the ViT's stochastic depth on,
    checkpointed: a SIGTERM during the third micro-batch stops the inner
    loop at its step boundary; the preemption state, loaded by a fresh
    runner over other weights, and the fourth micro-batch (the update) give
    the weights of four uninterrupted micro-batches, bit for bit."""
    def prepared(job_id):
        r = _runner(tmp_path, job_id, options=["run.accum_grad_iters=4"])
        for m in r.model.module.modules():
            if isinstance(m, Dropout):
                m.rate = 0.3
        _with_vit(r.model, 0.4, True)
        return r

    def micro_batches(start, signal_at=None):
        for i in range(start, 4):
            if i == signal_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield _samples(seed=30 + i)

    whole = prepared("whole")
    ctx = whole.train_ctx
    ctx.set_lr(1e-3)
    for samples in micro_batches(0):
        whole.task.train_step(ctx, samples)
    assert ctx.updates == 1

    cut = prepared("cut")
    preempt.install_guard()
    try:
        with pytest.raises(preempt.TrainingPreempted) as stopped:
            cut.task._train_inner_loop(
                epoch=0, iters_per_epoch=4, model=cut.model,
                data_loader=micro_batches(0, signal_at=2), train_ctx=cut.train_ctx,
                lr_scheduler=types.SimpleNamespace(step=lambda **kw: 1e-3),
                log_freq=1000)
    finally:
        preempt.uninstall_guard()
    assert stopped.value.inner_iter == 2
    assert (cut.train_ctx.calls, cut.train_ctx.updates) == (3, 0)
    path = cut.save_preemption_checkpoint(0)

    resumed = prepared("resumed")
    resumed.model.init_params(seed=11)
    resumed.load_checkpoint(path)
    rctx = resumed.train_ctx
    rctx.set_lr(1e-3)
    resumed.task.train_step(rctx, next(micro_batches(3)))
    assert (rctx.calls, rctx.updates) == (4, 1)
    want, got = whole.model.state_dict(), resumed.model.state_dict()
    moved = 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        moved += k.startswith("visual_encoder.") and not torch.equal(
            v, cut.model.state_dict()[k])
    assert moved


# -------------------------------------------------------- dp and sp, gloo
@pytest.fixture(scope="module", autouse=True)
def dp_launch(tmp_path_factory):
    """The two-rank launch, started with the module's first test so that
    it runs beside the others: (workdir, weights as a JAX tree, process)."""
    from mr_blip_tpu.models.scan_utils import unstack_blip2_mr_params

    workdir = tmp_path_factory.mktemp("dp_unfrozen")
    jm = JaxBLIP2_MR(**TINY, init_params=False, freeze_vit=False)
    tree = jm.init_params_fast(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = _redraw(unstack_blip2_mr_params(jax.tree.map(np.asarray, tree)), 3)
    torch.save(state_dict_from_jax(params), workdir / "weights.pt")
    proc = launch(workdir, Path(__file__))
    try:
        yield workdir, params, proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def dp_runs(dp_launch):
    """The JAX dp=2 mesh steps, then the launch's results."""
    from mr_blip_tpu.models.scan_utils import stack_blip2_mr_params, unstack_blip2_mr_params
    from mr_blip_tpu.parallel.mesh import make_mesh, replicate
    from mr_blip_tpu.runners.runner_base import TrainCtx as JaxTrainCtx

    workdir, params, proc = dp_launch
    stacked = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    try:
        mesh = make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
        want = {}
        for name, sp, accum in DP_CASES:
            model = JaxBLIP2_MR(**TINY, init_params=False, sequence_parallel=sp,
                                freeze_vit=False)
            model.params = stacked
            mask = model.trainable_mask()
            tx = make_optimizer(weight_decay=0.05, accum_grad_iters=accum,
                                trainable_mask=mask)
            step = make_train_step(lambda p, b, r, m=model: m._loss_fn(p, b, None),
                                   donate=False, trainable_mask=mask)
            ctx = JaxTrainCtx(model, TrainState.create(replicate(stacked, mesh), tx),
                              step, mesh, jax.random.PRNGKey(0))
            ctx.set_lr(LR)
            losses = []
            for samples in ([_sp_samples()] if sp else _dp_micro_batches()):
                batch = model.prepare_mr_batch(samples)
                batch.pop("video_prompt")
                losses.append(ctx.step(batch))
            want[name] = {"losses": losses, "state": state_dict_from_jax(
                jax.tree.map(np.asarray, unstack_blip2_mr_params(ctx.state.params)))}
    finally:
        log = finish(proc)
    got = [torch.load(workdir / f"out_rank{r}.pt", weights_only=True) for r in (0, 1)]
    return {"want": want, "got": got, "log": log,
            "init": torch.load(workdir / "weights.pt", weights_only=True)}


@pytest.mark.parametrize("name", [case[0] for case in DP_CASES])
def test_dp_and_sp_updates_equal_the_jax_mesh(dp_runs, name):
    """dp: two micro-batches of 4 rows (2 a rank), one update; sp: 1 x 5
    frames shared 2 / 3: the losses, every tensor after the update (the
    ViT's moved), the ranks bit-equal."""
    want, got = dp_runs["want"][name], [g[name] for g in dp_runs["got"]]
    init = dp_runs["init"]
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-4)
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["updates"] == got[1]["updates"] == 1
    assert got[0]["fingerprint"] == got[1]["fingerprint"]
    state = got[0]["state"]
    assert state.keys() == want["state"].keys()
    for key, w in want["state"].items():
        if key.endswith("key.bias"):
            # q·b is one constant over a row's logits, which the softmax
            # ignores: the gradient is rounding noise, and AdamW's first
            # step lr·g/(|g| + eps) turns it into a move of up to lr
            assert float((state[key] - init[key]).abs().max()) <= LR, key
            assert float((w - init[key]).abs().max()) <= LR, key
        else:
            np.testing.assert_allclose(state[key].numpy(), w.numpy(), atol=ATOL,
                                       err_msg=key)
        assert torch.equal(state[key], got[1]["state"][key]), key
    moved = [k for k in state if k.startswith("visual_encoder.")
             and not torch.equal(state[k], init[k])]
    assert len(moved) == sum(k.startswith("visual_encoder.") for k in state)
