"""Tensor parallelism of the port (``run.tp``, ``parallel/tensor.py``)
against the JAX package's dp x tp meshes, on the CPU.

Four ranks (``torch.distributed.run --standalone``, ``gloo``) run this file
as a script, as ``tests/test_torch_dp.py`` does (no JAX in the workers):
dp=2 x tp=2, the tensor-parallel groups {0, 1} and {2, 3}. The JAX side runs
in the test process on the virtual CPU devices of ``tests/conftest.py``
while the ranks run. Tiny models, fp32, every weight redrawn from a numpy
seed and carried over by ``state_dict_from_jax``. One launch runs every case:

1. ``step``: two micro-batches of 4 rows (2 per dp rank) with
   ``accum_grad_iters`` 2, one LoRA update, against the JAX ``TrainCtx``
   step on a dp=2 x tp=2 mesh with ``shard_params``
   (``tests/test_training.py::TestTensorParallel``).
2. ``clip``: the same with ``max_grad_norm`` small enough to clip, over two
   updates.
3. ``generate``: the spans of the tp=2 model against the JAX model's on a
   dp=4 x tp=2 mesh (``tests/test_mesh_generate.py::
   test_dp_tp_generate_identical``) and the unsharded port's.
4. ``opt``: one step of the OPT variant at tp=2 against the JAX OPT
   variant's step on a dp=2 x tp=2 mesh.
5. ``dropout``: every dropout at 0.1 (the attention weights' too): the loss
   and the gradients of a micro-batch at tp=2 against the unsharded port on
   the rank's rows and dropout stream.
6. ``checkpoint``: the state gathered after case 1 (to each group's tp
   rank 0: a tp=2 checkpoint) loaded at tp=1 bit-equal; whole tensors
   loaded at tp=2 and gathered back bit-equal.
7. ``sp_tp``: sequence parallelism over the dp ranks beside tp=2 (B=1 x
   T=5 frames, 2 and 3 a dp rank, the Q-Former training) against the JAX
   sp step on the dp=2 x tp=2 mesh.
8. ``shard_trains``: ``TrainCtx`` refuses a sharded weight set to train
   (only replicated tensors train, so the clip's plain norm is whole).

Bars: loss 1e-4 relative, trainable tensors 1e-4 (a Q-Former key bias,
whose gradient is zero in exact math, 2 lr: AdamW's first step of about lr
in the sign float noise gives it), the fp64 sum of |every tensor| 1e-5
relative; spans identical; dropout case 1e-5.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dp import (  # noqa: E402
    CLIP,
    LR,
    _dp_micro_batches,
    _rows,
    _samples,
    _sp_samples,
    finish,
    launch,
)

TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", task="lora", num_beams=2,
            max_new_tokens=8, compute_dtype="float32")
OPT_TINY = dict(opt_model="tiny", img_size=28, vit_model="tiny", task="lora",
                num_beams=2, max_new_tokens=6, compute_dtype="float32")
DP, TP = 2, 2
# (name, max_grad_norm, updates)
STEP_CASES = (("step", None, 1), ("clip", CLIP, 2))
DROPOUT = 0.1


def _float_video(samples, seed):
    """``samples`` with float frames (taken as normalized by both packages:
    the JAX OPT batch casts uint8 frames to float32 unnormalized)."""
    rng = np.random.default_rng(seed)
    return dict(samples, video=rng.standard_normal(samples["video"].shape)
                .astype(np.float32))


def _generate_samples():
    return _float_video(_samples(4, 2, seed=5, windows=["[[1, 2]]"] * 4), 5)


def _opt_samples():
    return _float_video(_samples(4, 2, seed=7, windows=["[[0, 10]]", "[[5, 25]]",
                                                        "[[1, 2]]", "[[3, 9]]"]), 7)


# ------------------------------------------------------------------ worker
def _worker(workdir: Path):
    """One rank: every case, results to ``out_rank<r>.pt``."""
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT
    from mr_blip_tpu_torch.models.layers import Dropout, set_dropout_generator, stream_seed
    from mr_blip_tpu_torch.parallel import tensor as tensor_parallel
    from mr_blip_tpu_torch.parallel.mesh import assert_replicated
    from mr_blip_tpu_torch.runners import train_state
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    norms, clip_fn = [], train_state.clip_by_global_norm

    def recorded(params, max_norm):  # the norm each update clips
        grads = [p.grad for p in params if p.grad is not None]
        norms.append(float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))))
        return clip_fn(params, max_norm)

    def whole(model):  # the gathered state: the tp group's rank 0 alone gets it
        state = model.full_state_dict()
        return None if state is None else {k: v.clone() for k, v in state.items()}

    train_state.clip_by_global_norm = recorded
    dist_utils.init_distributed_mode({"device": "cpu", "dist_timeout_s": 60, "tp": TP})
    rank, dp_rank = dist_utils.get_rank(), dist_utils.dp_rank()
    assert (dist_utils.dp_size(), dist_utils.tp_size()) == (DP, TP)
    group = dist_utils.tp_group()
    weights = torch.load(workdir / "weights.pt", weights_only=True)

    def build(cls=BLIP2_MR, cfg=TINY, sd=weights, tp=True, rate=0.0, **kw):
        model = cls(**cfg, device="cpu", init_params=False, **kw)
        model.load_state_dict(sd)
        for m in model.module.modules():
            if isinstance(m, Dropout):
                m.rate = rate
        if tp:
            model.set_tensor_parallel(group)
        return model

    out = {"rank": rank, "dp_rank": dp_rank}
    for name, clip, updates in STEP_CASES:  # cases 1 and 2
        model = build()
        out.setdefault("described", tensor_parallel.describe_sharding(model.module))
        ctx = TrainCtx(model, accum_grad_iters=2, max_grad_norm=clip, seed=0)
        ctx.set_lr(LR)
        losses = [ctx.step(model.prepare_mr_batch(_rows(s, 2 * dp_rank, 2 * dp_rank + 2)))
                  for s in _dp_micro_batches(updates)]
        out[name] = {"losses": losses, "updates": ctx.updates,
                     "clipped_norms": list(norms),
                     "fingerprint": assert_replicated(ctx.named_params, name),
                     "state": whole(model)}
        norms[:] = []
    # case 7: sp over the dp ranks, tp=2 inside each
    model = build(sequence_parallel=True)
    ctx = TrainCtx(model, seed=0)
    ctx.set_lr(LR)
    out["sp_tp"] = {"losses": [ctx.step(model.prepare_mr_batch(_sp_samples()))],
                    "fingerprint": assert_replicated(ctx.named_params, "sp_tp"),
                    "state": whole(model)}
    # case 6: the gathered state loads whole into a tp=2 model and back
    if rank == 0:
        torch.save(out["step"]["state"], workdir / "step_state.pt")
    dist_utils.barrier()
    state = torch.load(workdir / "step_state.pt", weights_only=True)
    model = build(sd=state)
    back = whole(model)
    out["checkpoint"] = {
        "round_trip": back is None or all(torch.equal(v, state[k]) for k, v in back.items()),
        "gathered": back is not None,
        "shard_shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()
                         if v.shape != state[k].shape}}
    # case 3
    samples = _generate_samples()
    out["generate"] = {"tp": build().generate(samples)["raw_prediction"],
                       "local": build(tp=False).generate(samples)["raw_prediction"]}
    # case 4
    model = build(BLIP2_MR_OPT, OPT_TINY, torch.load(workdir / "opt_weights.pt",
                                                      weights_only=True))
    out["opt_described"] = tensor_parallel.describe_sharding(model.module)
    ctx = TrainCtx(model, seed=0)
    ctx.set_lr(LR)
    loss = ctx.step(model.prepare_mr_batch(_rows(_opt_samples(), 2 * dp_rank,
                                                 2 * dp_rank + 2)))
    out["opt"] = {"losses": [loss], "fingerprint": assert_replicated(ctx.named_params, "opt"),
                  "state": whole(model)}
    # case 5: one micro-batch, the rank's rows and stream, tp=2 against unsharded
    batch = _rows(_dp_micro_batches()[0], 2 * dp_rank, 2 * dp_rank + 2)
    res = {}
    for kind in ("tp", "local"):
        model = build(tp=kind == "tp", rate=DROPOUT)
        model.set_trainable()
        gen = torch.Generator().manual_seed(stream_seed(0, dp_rank, 0))
        set_dropout_generator(model.module, gen)
        model.train()
        total, count = model.loss_terms(model.prepare_mr_batch(batch))
        (total / count).backward()
        params = [p for p in model.module.parameters() if p.requires_grad]
        if kind == "tp":
            tensor_parallel.reduce_partial_grads(params, group)
        res[kind] = {"loss": float(total / count),
                     "grads": {n: p.grad.clone() for n, p in model.module.named_parameters()
                               if p.requires_grad}}
    out["dropout"] = res
    # case 8: a sharded weight set to train
    model = build()
    shard = next(n for n, p in model.module.named_parameters() if hasattr(p, "tp_dim"))
    model.trainable_mask = lambda: {n: n == shard for n, _ in model.module.named_parameters()}
    try:
        TrainCtx(model, seed=0)
        out["shard_trains"] = None
    except ValueError as err:
        out["shard_trains"] = str(err)
    torch.save(out, workdir / f"out_rank{rank}.pt")
    dist_utils.destroy()


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
    sys.exit(0)


# ------------------------------------------------------------------- tests
import re  # noqa: E402

import pytest  # noqa: E402

WORLD = DP * TP


def _checksum(tensors):
    """fp64 sum of |every element| (``dryrun_multichip``'s fingerprint)."""
    return float(sum(np.abs(np.asarray(t, np.float64)).sum() for t in tensors))


def _redraw(tree, seed):
    from flax import traverse_util

    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(tree)
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.1 * noise
    return traverse_util.unflatten_dict(flat)


def _jax_names(described):
    """The JAX ``describe_sharding`` paths as the port's module paths
    (``t5/encoder/block/ff/wi_0/Dense_0/kernel`` -> ``t5.encoder.block.ff.
    wi_0``), the ViT left out (the port keeps it whole)."""
    return {re.sub(r"\.layers?_\d+", ".layers", p.replace("/", ".")[:-len(".Dense_0.kernel")])
            for p in described if not p.startswith("visual_encoder")}


def _port_names(described):
    return {re.sub(r"\.\d+\.", ".", n)[:-len(".weight")]
            for n, mode in described.items() if mode != "partial"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank launch and the JAX references, computed while it runs."""
    import jax
    import jax.numpy as jnp

    from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
    from mr_blip_tpu.models.blip2_mr_opt import BLIP2_MR_OPT as JaxOPT
    from mr_blip_tpu.models.scan_utils import (
        stack_blip2_mr_params,
        unstack_blip2_mr_params,
    )
    from mr_blip_tpu.parallel.mesh import make_mesh, replicate
    from mr_blip_tpu.parallel.sharding_rules import describe_sharding, shard_params
    from mr_blip_tpu.runners.runner_base import TrainCtx as JaxTrainCtx
    from mr_blip_tpu.runners.train_state import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from mr_blip_tpu_torch.models.convert import state_dict_from_jax

    workdir = tmp_path_factory.mktemp("tp")
    jm = JaxBLIP2_MR(**TINY, init_params=False)
    params = _redraw(unstack_blip2_mr_params(jax.tree.map(
        np.asarray, jm.init_params_fast(jax.random.PRNGKey(0), dtype=jnp.float32))), 3)
    stacked = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    torch.save(state_dict_from_jax(params), workdir / "weights.pt")
    jo = JaxOPT(**OPT_TINY, scan_layers=False, init_params=False)
    opt_params = jax.tree.map(jnp.asarray, _redraw(jax.tree.map(
        np.asarray, jo.init_params_fast(jax.random.PRNGKey(0), dtype=jnp.float32)), 4))
    torch.save(state_dict_from_jax(jax.tree.map(np.asarray, opt_params)),
               workdir / "opt_weights.pt")
    proc = launch(workdir, Path(__file__), nproc=WORLD)
    try:
        mesh = make_mesh(dp=DP, tp=TP, devices=jax.devices()[:WORLD])
        want = {"described": _jax_names(describe_sharding(stacked, mesh))}

        def jax_steps(model, tree, micro_batches, accum, clip):
            mask = model.trainable_mask()
            tx = make_optimizer(weight_decay=0.05, accum_grad_iters=accum,
                                trainable_mask=mask, max_grad_norm=clip)
            step = make_train_step(lambda p, b, r, m=model: m._loss_fn(p, b, None),
                                   donate=False, trainable_mask=mask)
            with jax.set_mesh(mesh):
                state = TrainState.create(shard_params(tree, mesh), tx)
            ctx = JaxTrainCtx(model, state, step, mesh, jax.random.PRNGKey(0))
            ctx.set_lr(LR)
            losses = []
            for samples in micro_batches:
                batch = model.prepare_mr_batch(samples)
                batch.pop("video_prompt", None)
                losses.append(ctx.step(batch))
            return {"losses": losses, "state": state_dict_from_jax(jax.tree.map(
                np.asarray, ctx.state.params))}

        for name, clip, updates in STEP_CASES:
            model = JaxBLIP2_MR(**TINY, init_params=False)
            model.params = stacked
            res = jax_steps(model, stacked, _dp_micro_batches(updates), 2, clip)
            res["state"] = state_dict_from_jax(jax.tree.map(
                np.asarray, unstack_blip2_mr_params(model.params)))
            want[name] = res
        model = JaxBLIP2_MR(**TINY, init_params=False, sequence_parallel=True)
        model.params = stacked
        mask = model.trainable_mask()
        tx = make_optimizer(weight_decay=0.05, trainable_mask=mask)
        step = make_train_step(lambda p, b, r, m=model: m._loss_fn(p, b, None),
                               donate=False, trainable_mask=mask)
        batch = model.prepare_mr_batch(_sp_samples())
        batch.pop("video_prompt", None)
        with jax.set_mesh(mesh):
            state = TrainState.create(shard_params(stacked, mesh), tx)
            state, loss = step(state, replicate(batch, mesh), LR, jax.random.PRNGKey(0))
        want["sp_tp"] = {"losses": [float(loss)], "state": state_dict_from_jax(
            jax.tree.map(np.asarray, unstack_blip2_mr_params(state.params)))}
        model = JaxBLIP2_MR(**TINY, init_params=False)
        model.params = stacked
        model.set_mesh(make_mesh(dp=4, tp=2))
        want["generate"] = model.generate(_generate_samples())["raw_prediction"]
        jo.params = opt_params
        want["opt_described"] = _jax_names(describe_sharding(opt_params, mesh))
        want["opt"] = jax_steps(jo, opt_params, [_opt_samples()], 1, None)
    finally:
        log = finish(proc)
    got = [torch.load(workdir / f"out_rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return {"want": want, "got": got, "log": log, "workdir": workdir}


def _same_across_ranks(got, key):
    return all(g[key]["fingerprint"] == got[0][key]["fingerprint"] for g in got)


@pytest.mark.parametrize("name", ["step", "clip", "opt", "sp_tp"])
def test_tp_step_equals_the_jax_mesh_step(runs, name):
    """Cases 1, 2, 4 and 7: every micro-batch's loss (each rank reporting the
    global mean), every tensor after the update (gathered whole), the
    trainable tensors bit-equal over the four ranks and the fp64
    fingerprint, against the JAX step on the dp=2 x tp=2 mesh."""
    want, got = runs["want"][name], [g[name] for g in runs["got"]]
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-4)
    assert all(g["losses"] == got[0]["losses"] for g in got)
    assert _same_across_ranks(runs["got"], name)
    if name == "clip":  # both updates clipped, by different factors
        norms = got[0]["clipped_norms"]
        assert len(norms) == 2 and min(norms) > CLIP and norms[0] != norms[1]
    state = got[0]["state"]
    assert state.keys() == want["state"].keys()
    trained = 0
    for key, w in want["state"].items():
        # A key bias's gradient is zero in exact math (the softmax does not
        # see it), so float noise picks the sign of AdamW's first step of
        # about lr: such an element may land up to 2 lr away (the Q-Former
        # trains in case 7 only).
        bar = 2 * LR if key.endswith("key.bias") else 1e-4
        np.testing.assert_allclose(state[key].numpy(), w.numpy(), atol=bar, err_msg=key)
        trained += "lora_" in key
    assert trained
    for r, g in enumerate(got):  # whole at each group's tp rank 0 alone
        if r % TP:
            assert g["state"] is None
        else:
            assert all(torch.equal(v, g["state"][k]) for k, v in state.items())
    ck, jck = _checksum(state.values()), _checksum(want["state"].values())
    assert abs(ck - jck) <= 1e-5 * abs(jck)


@pytest.mark.parametrize("variant", ["t5", "opt"])
def test_the_sharded_layers_are_the_jax_rules(runs, variant):
    """The port shards what ``sharding_rules.shard_params`` shards in the
    language model (the ViT stays whole), and marks LoRA of the sharded
    layers as used in slices."""
    key = "described" if variant == "t5" else "opt_described"
    got = runs["got"][0][key]
    assert _port_names(got) == runs["want"][key]
    partial = {n for n, mode in got.items() if mode == "partial"}
    assert partial and all("lora_" in n or n.endswith(("rel_embedding", ".bias"))
                           for n in partial)
    assert all(not n.startswith(("visual_encoder", "qformer")) for n in got)


def test_tp_generate_spans_equal_the_jax_dp_tp_mesh(runs):
    """Case 3: the spans of every rank's tp=2 model are the JAX dp=4 x tp=2
    model's and the unsharded port's."""
    want = runs["want"]["generate"]
    for g in runs["got"]:
        assert g["generate"]["tp"] == want == g["generate"]["local"]


def test_dropout_at_tp2_equals_tp1(runs):
    """Case 5: with every dropout on (LoRA inputs, the FFN hidden, the
    attention weights of the rank's heads), the loss and every gradient at
    tp=2 equal the unsharded port's on the same rows and stream; the two
    dp ranks drew different masks."""
    losses = []
    for g in runs["got"]:
        res = g["dropout"]
        assert abs(res["tp"]["loss"] - res["local"]["loss"]) <= 1e-5 * abs(res["local"]["loss"])
        for name, want in res["local"]["grads"].items():
            np.testing.assert_allclose(res["tp"]["grads"][name].numpy(), want.numpy(),
                                       atol=1e-5, err_msg=name)
        losses.append(res["tp"]["loss"])
    assert losses[0] == losses[1] and losses[2] == losses[3] and losses[0] != losses[2]


def test_tp2_checkpoint_loads_at_tp1_bit_equal(runs):
    """Case 6: the whole tensors gathered at tp=2 (to each group's tp rank 0
    alone) load into a one-process model bit-equal, and back into a tp=2
    model (its shards half the sharded dimensions) bit-equal."""
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR

    whole = runs["got"][0]["step"]["state"]
    model = BLIP2_MR(**TINY, device="cpu", init_params=False)
    model.load_state_dict(whole)
    assert all(torch.equal(v, whole[k]) for k, v in model.state_dict().items())
    for r, g in enumerate(runs["got"]):
        ck = g["checkpoint"]
        assert ck["round_trip"] and ck["gathered"] == (r % TP == 0)
        shapes = ck["shard_shapes"]
        assert shapes and all(
            sum(a != b for a, b in zip(shape, whole[k].shape)) == 1
            and np.prod(shape) * TP == whole[k].numel() for k, shape in shapes.items())


def test_a_trainable_shard_raises(runs):
    """Case 8: only replicated tensors train under tp (so after the tp sum
    every gradient is whole and the clip's norm is one process's):
    ``TrainCtx`` refuses a sharded weight."""
    for g in runs["got"]:
        assert g["shard_trains"] and "only replicated tensors train" in g["shard_trains"]
