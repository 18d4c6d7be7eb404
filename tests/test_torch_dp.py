"""Data and sequence parallelism of the port against the JAX package's dp
and sp meshes, on the CPU.

Two ranks (``torch.distributed.run --standalone``, ``gloo``) run this file
as a script: it imports no JAX. The JAX side runs in the test process on two
of the 8 virtual CPU devices of ``tests/conftest.py``, as
``__graft_entry__.py::dryrun_multichip`` does. Tiny models, fp32, dropout
off on both sides (the JAX side's deterministic loss), every weight redrawn
from a numpy seed. One launch runs every case; the JAX references are
computed while it runs.

1. dp: two micro-batches of 4 rows (2 per rank) with ``accum_grad_iters``
   2, one update, against the JAX ``TrainCtx.step`` on a dp=2 mesh over the
   union batch. The rows' targets have different lengths, so a mean of
   per-rank means differs from the JAX loss (checked).
2. The same with ``max_grad_norm`` small enough to clip, over two updates
   (AdamW's first update does not see a gradient's scale; the second sees
   the ratio of the two clipped gradients): the norm is taken after the
   all-reduce.
3. sp: B=1 x T=5 frames (2 and 3 per rank, ``frame_share``) with the
   Q-Former training, against the JAX sp step on a dp=2 mesh with the
   batch replicated; the spans of ``generate`` against the JAX model's.
4. CLIP's ``all_gather_features``: each rank's 3 image and text feature
   rows gathered, a rank's contrastive loss over its rows against the
   gathered ones, and the backward: the gathered tensor and each rank's
   gradients against JAX's ``all_gather_features`` under ``shard_map`` on
   the dp=2 mesh (1e-5).

Bars: loss 1e-4 relative, post-step trainable tensors 1e-4, the fp64 sum of
|every tensor| 1e-5 relative (``dryrun_multichip``'s fingerprint). Also the
loader's equal step counts (N = 9 rows, 2 ranks) against the JAX loader's
global batches.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", task="lora", num_beams=2,
            max_new_tokens=8, compute_dtype="float32")
LR = 1e-3
CLIP = 0.05
LAUNCH_TIMEOUT_S = 120
# Windows of 1, 2 and 3 spans: targets of different token counts.
WINDOWS = ("[[0, 10]]", "[[5, 25], [26, 29]]", "[[1, 2], [3, 4], [5, 6]]", "[[0, 30]]")


def _samples(b, t, seed, windows):
    rng = np.random.default_rng(seed)
    return {
        "video": rng.integers(0, 256, (b, t, 28, 28, 3), dtype=np.uint8),
        "timestamps": np.tile(np.arange(t, dtype=np.float64) * 6.0, (b, 1)),
        "duration": np.full((b,), 30.0),
        "query_id": [f"q{seed}_{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": [f"Query: event {seed} {i}\n" for i in range(b)],
        "task_prompt": ["Relevant windows: "] * b,
        "relevant_windows": list(windows),
    }


def _rows(samples, lo, hi):
    return {k: v[lo:hi] for k, v in samples.items()}


def _dp_micro_batches(updates=1):
    """Two global micro-batches of 4 rows an update, every other one with the
    windows in another order (the same padded shapes, other rows per rank)."""
    return [_samples(4, 3, seed=10 + i, windows=WINDOWS if i % 2 == 0
                     else WINDOWS[2:] + WINDOWS[:2]) for i in range(2 * updates)]


# (name, max_grad_norm, sequence_parallel, updates)
CASES = (("dp", None, False, 1), ("dp_clip", CLIP, False, 2), ("sp", None, True, 1))


def _sp_samples():
    return _samples(1, 5, seed=20, windows=WINDOWS[1:2])


CLIP_ROWS, CLIP_WIDTH, CLIP_SCALE = 3, 8, 10.0


def _clip_features():
    """(image, text) features of both ranks, rank-major rows."""
    rng = np.random.default_rng(24)
    return tuple(rng.standard_normal((2 * CLIP_ROWS, CLIP_WIDTH)).astype(np.float32)
                 for _ in range(2))


def _clip_rank_loss(img, txt, img_all, txt_all, rank, xp):
    """A rank's contrastive loss: its rows against every rank's, in numpy-
    like ``xp`` (torch or jax.numpy) with ``log_softmax`` from ``xp``'s nn."""
    labels = xp.arange(CLIP_ROWS) + rank * CLIP_ROWS
    log_softmax = (torch.log_softmax if xp is torch
                   else __import__("jax").nn.log_softmax)

    def ce(logits):
        ll = log_softmax(CLIP_SCALE * logits, -1)
        return -ll[xp.arange(CLIP_ROWS), labels].mean()

    return (ce(img @ txt_all.T) + ce(txt @ img_all.T)) / 2


def _clip_gather_worker(rank):
    from mr_blip_tpu_torch.models.clip import all_gather_features

    rows = slice(rank * CLIP_ROWS, (rank + 1) * CLIP_ROWS)
    img, txt = (torch.from_numpy(a[rows]).requires_grad_() for a in _clip_features())
    img_all, txt_all = all_gather_features(img), all_gather_features(txt)
    loss = _clip_rank_loss(img, txt, img_all, txt_all, rank, torch)
    loss.backward()
    return {"gathered": (img_all.detach(), txt_all.detach()), "loss": float(loss),
            "grads": (img.grad, txt.grad)}


# ------------------------------------------------------------------ worker
def _worker(workdir: Path):
    """One rank: every case on the port, results to ``out_rank<r>.pt``."""
    sys.path.insert(0, str(REPO))
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
    from mr_blip_tpu_torch.models.layers import Dropout
    from mr_blip_tpu_torch.parallel.mesh import assert_replicated
    from mr_blip_tpu_torch.runners import train_state
    from mr_blip_tpu_torch.runners.train_state import TrainCtx

    norms, clip_fn = [], train_state.clip_by_global_norm

    def recorded(params, max_norm):  # the global norm each update clips
        grads = [p.grad for p in params if p.grad is not None]
        norms.append(float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))))
        return clip_fn(params, max_norm)

    train_state.clip_by_global_norm = recorded
    dist_utils.init_distributed_mode({"device": "cpu", "dist_timeout_s": 60})
    rank, world = dist_utils.get_rank(), dist_utils.get_world_size()
    assert world == 2
    state_dict = torch.load(workdir / "weights.pt", weights_only=True)
    out = {}
    for name, clip, sp, updates in CASES:
        model = BLIP2_MR(**TINY, device="cpu", init_params=False, sequence_parallel=sp)
        model.load_state_dict(state_dict)
        for m in model.module.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        res = {}
        if sp:
            res["generate"] = model.generate(_sp_samples())["raw_prediction"]
            batches = [_sp_samples()]
        else:
            batches = [_rows(s, 2 * rank, 2 * rank + 2) for s in _dp_micro_batches(updates)]
        ctx = TrainCtx(model, accum_grad_iters=1 if sp else 2, max_grad_norm=clip, seed=0)
        ctx.set_lr(LR)
        res["losses"] = [ctx.step(model.prepare_mr_batch(b)) for b in batches]
        res["updates"] = ctx.updates
        res["clipped_norms"], norms[:] = list(norms), []
        res["fingerprint"] = assert_replicated(ctx.named_params, name)
        res["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        out[name] = res
    out["clip_gather"] = _clip_gather_worker(rank)
    torch.save(out, workdir / f"out_rank{rank}.pt")
    dist_utils.destroy()


def launch(workdir: Path, script: Path, *args, nproc: int = 2):
    """``torch.distributed.run --standalone`` of ``script`` (a worker)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={nproc}", str(script), str(workdir), *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc):
    try:
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    return log


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
    sys.exit(0)


# ------------------------------------------------------------------- tests
import pytest  # noqa: E402


def _checksum(tensors):
    """fp64 sum of |every element| (``dryrun_multichip``'s fingerprint)."""
    return float(sum(np.abs(np.asarray(t, np.float64)).sum() for t in tensors))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank launch and the JAX references, computed while it runs."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
    from mr_blip_tpu.models.scan_utils import (
        stack_blip2_mr_params,
        unstack_blip2_mr_params,
    )
    from mr_blip_tpu.parallel.mesh import make_mesh, replicate
    from mr_blip_tpu.runners.runner_base import TrainCtx as JaxTrainCtx
    from mr_blip_tpu.runners.train_state import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from mr_blip_tpu_torch.models.convert import state_dict_from_jax

    workdir = tmp_path_factory.mktemp("dp")
    jm = JaxBLIP2_MR(**TINY, init_params=False)
    tree = jax.tree.map(np.asarray, jm.init_params_fast(jax.random.PRNGKey(0),
                                                        dtype=jnp.float32))
    rng = np.random.default_rng(3)
    flat = traverse_util.flatten_dict(unstack_blip2_mr_params(tree))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.1 * noise
    params = traverse_util.unflatten_dict(flat)
    stacked = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    torch.save(state_dict_from_jax(params), workdir / "weights.pt")
    proc = launch(workdir, Path(__file__))
    try:
        mesh = make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
        want = {}
        for name, clip, sp, updates in CASES:
            model = JaxBLIP2_MR(**TINY, init_params=False, sequence_parallel=sp)
            model.params = stacked
            mask = model.trainable_mask()
            tx = make_optimizer(weight_decay=0.05, accum_grad_iters=1 if sp else 2,
                                trainable_mask=mask, max_grad_norm=clip)
            step = make_train_step(lambda p, b, r, m=model: m._loss_fn(p, b, None),
                                   donate=False, trainable_mask=mask)
            res = {}
            if sp:
                res["generate"] = model.generate(_sp_samples())["raw_prediction"]
                batch = model.prepare_mr_batch(_sp_samples())
                batch.pop("video_prompt")
                with jax.set_mesh(mesh):
                    state = TrainState.create(replicate(stacked, mesh), tx)
                    state, loss = step(state, replicate(batch, mesh), LR,
                                       jax.random.PRNGKey(0))
                res["losses"] = [float(loss)]
            else:
                ctx = JaxTrainCtx(model, TrainState.create(replicate(stacked, mesh), tx),
                                  step, mesh, jax.random.PRNGKey(0))
                ctx.set_lr(LR)
                res["losses"] = []
                for samples in _dp_micro_batches(updates):
                    batch = model.prepare_mr_batch(samples)
                    batch.pop("video_prompt")
                    res["losses"].append(ctx.step(batch))
                state = ctx.state
            res["state"] = state_dict_from_jax(
                jax.tree.map(np.asarray, unstack_blip2_mr_params(state.params)))
            want[name] = res
        want["clip_gather"] = _jax_clip_gather(mesh)
    finally:
        log = finish(proc)
    got = [torch.load(workdir / f"out_rank{r}.pt", weights_only=False) for r in (0, 1)]
    return {"want": want, "got": got, "log": log}


def _jax_clip_gather(mesh):
    """Case 4 in JAX: ``all_gather_features`` under ``shard_map``, every
    rank's loss, and the gradient of their sum (the transpose of the gather
    sums the ranks' cotangents)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from mr_blip_tpu.models.clip import all_gather_features

    def per_rank(img, txt):
        img_all, txt_all = all_gather_features(img, "dp"), all_gather_features(txt, "dp")
        loss = _clip_rank_loss(img, txt, img_all, txt_all, jax.lax.axis_index("dp"), jnp)
        return loss[None], img_all, txt_all

    sharded = jax.shard_map(per_rank, mesh=mesh, in_specs=(P("dp"), P("dp")),
                            out_specs=(P("dp"), P(), P()), check_vma=False)
    img, txt = _clip_features()
    losses, img_all, txt_all = sharded(img, txt)
    grads = jax.grad(lambda i, t: sharded(i, t)[0].sum(), argnums=(0, 1))(img, txt)
    return {"losses": np.asarray(losses), "gathered": (np.asarray(img_all),
                                                        np.asarray(txt_all)),
            "grads": tuple(np.asarray(g) for g in grads)}


def test_clip_all_gather_features_forward_and_gradient(runs):
    """Case 4: the gathered features are both ranks' rows in rank order, and
    each rank's gradient is JAX's (every rank's loss reaching its rows)."""
    want = runs["want"]["clip_gather"]
    for rank, got in enumerate(g["clip_gather"] for g in runs["got"]):
        for g, w in zip(got["gathered"], want["gathered"]):
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_allclose(got["loss"], want["losses"][rank], rtol=1e-5)
        rows = slice(rank * CLIP_ROWS, (rank + 1) * CLIP_ROWS)
        for g, w in zip(got["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w[rows], rtol=1e-5, atol=1e-6)
    assert np.abs(want["grads"][0]).max() > 1e-3


@pytest.mark.parametrize("name", ["dp", "dp_clip", "sp"])
def test_step_equals_the_jax_mesh_step(runs, name):
    """Cases 1-3: the loss (every micro-batch's, each rank reporting the
    global mean), the post-step trainable tensors, every frozen tensor as
    loaded, the ranks bit-equal and the fp64 fingerprint."""
    want, got = runs["want"][name], [g[name] for g in runs["got"]]
    updates = {case[0]: case[3] for case in CASES}[name]
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-4)
    assert len(want["losses"]) == (1 if name == "sp" else 2 * updates)
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["updates"] == got[1]["updates"] == updates
    if name == "dp_clip":  # both updates clipped, by different factors
        norms = got[0]["clipped_norms"]
        assert len(norms) == 2 and min(norms) > CLIP and norms[0] != norms[1]
    assert got[0]["fingerprint"] == got[1]["fingerprint"]
    state = got[0]["state"]
    assert state.keys() == want["state"].keys()
    trained = 0
    for key, w in want["state"].items():
        np.testing.assert_allclose(state[key].numpy(), w.numpy(), atol=1e-4, err_msg=key)
        trained += "lora_" in key or key.startswith("qformer.")
    assert trained
    assert all(torch.equal(v, got[1]["state"][k]) for k, v in state.items())
    ck, jck = _checksum(state.values()), _checksum(want["state"].values())
    assert abs(ck - jck) <= 1e-5 * abs(jck)


def test_dp_rows_have_unequal_target_lengths(runs):
    """Case 1's premise: the ranks' target-token counts differ, so the mean
    of the two ranks' own means misses the loss by more than twice case 1's
    bar."""
    from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR

    model = BLIP2_MR(**TINY, device="cpu", init_params=False)
    model.load_state_dict(runs["got"][0]["dp"]["state"])  # any weights
    for samples in _dp_micro_batches():
        counts, means = [], []
        for rank in (0, 1):
            total, count = model.loss_terms(model.prepare_mr_batch(_rows(samples, 2 * rank,
                                                                         2 * rank + 2)))
            counts.append(float(count))
            means.append(float(total / count))
        assert counts[0] != counts[1]
        model_mean = float(model.loss(model.prepare_mr_batch(samples)))
        assert abs((means[0] + means[1]) / 2 - model_mean) > 2e-4 * model_mean


def test_sp_shares_frames_and_generates_the_jax_spans(runs):
    """Case 3: T = 5 frames over two ranks (2 and 3); both ranks' spans are
    the JAX model's."""
    from mr_blip_tpu_torch.parallel.mesh import frame_share

    assert [frame_share(5, r, 2) for r in (0, 1)] == [(0, 2), (2, 5)]
    want = runs["want"]["sp"]["generate"]
    assert runs["got"][0]["sp"]["generate"] == runs["got"][1]["sp"]["generate"] == want


def test_train_loader_steps_equal_across_ranks():
    """Case 4: N = 9 rows, 2 ranks, batch 2 per rank: every rank takes
    9 // 4 = 2 micro-batches, and the union of the ranks' i-th batches is
    the JAX loader's i-th global batch of 4 rows (one process, as the JAX
    package's one-process mesh reads them); evaluation shards stay uneven
    (5 and 4 rows) and cover the split once."""
    from mr_blip_tpu.datasets import loader as jloader
    from mr_blip_tpu_torch.datasets import loader as tloader

    class Ints:
        def __len__(self):
            return 9

        def __getitem__(self, i):
            return {"i": i}

    def rows(loader, epoch):
        loader.set_epoch(epoch)
        return [sorted(int(i) for i in b["i"]) for b in loader]

    kw = dict(shuffle=True, drop_last=True, num_workers=1, seed=7)
    for epoch in (0, 1):
        ranks = [rows(tloader.DataLoader(Ints(), batch_size=2, rank=r, world_size=2, **kw),
                      epoch) for r in (0, 1)]
        want = rows(jloader.DataLoader(Ints(), batch_size=4, **kw), epoch)
        assert [len(r) for r in ranks] == [2, 2] == [len(want)] * 2
        assert [sorted(a + b) for a, b in zip(*ranks)] == want
    evals = [rows(tloader.DataLoader(Ints(), batch_size=2, rank=r, world_size=2,
                                     num_workers=1), 0) for r in (0, 1)]
    assert [sum(map(len, e)) for e in evals] == [5, 4]
    assert sorted(i for e in evals for b in e for i in b) == list(range(9))
