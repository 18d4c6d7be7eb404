"""Pipeline parallelism of the port (``parallel/pipeline.py``,
``models/t5_pipeline.py``, ``dryrun_multichip.py``) against the JAX
package's GPipe schedule, on the CPU.

Four ranks (``torch.distributed.run --standalone``, ``gloo``) run this file
as a script, as ``tests/test_torch_tp.py`` does (no JAX in the workers): the
two-stage cases on the groups {0, 1} and {2, 3}, the four-stage ones on the
world. The JAX side runs in the test process on the virtual CPU devices of
``tests/conftest.py`` while the ranks run. One launch runs every case:

1. ``pipeline_apply`` on the MLP stages of ``tests/test_pipeline.py`` at
   (pp, M) = (2, 2), (2, 4) and (4, 4) against JAX ``pipeline_apply``
   (2e-5), and the gradients of every stage's tensors at (4, 4) against
   ``jax.grad`` through the JAX schedule (1e-4); in bf16, with a bool leaf
   and a bf16 extra that trains (gloo carries neither type: bytes on the
   wire), against the stages back to back in one process (1e-2 of the
   largest).
2. ``t5_pipeline_forward`` at (pp, layers, LoRA rank) = (2, 2, 0),
   (2, 4, 2) and (4, 4, 0) with padded encoder and decoder masks against
   JAX ``t5_pipeline_forward`` and the unpipelined port (2e-4).
3. The gradients of every tensor of the whole stack (the blocks gathered
   from their stages, the rel-pos tables trained) at pp 2 against
   ``jax.grad`` of the JAX pipeline (1e-4).
4. ``dryrun_multichip`` at S = 4 with its bars (run last in the launch: it
   leaves the process group).

Every parameter is drawn from a numpy seed into the shapes of
``jax.eval_shape`` of the flax init (no flax init is run) and carried over
by ``state_dict_from_jax``.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dp import finish, launch  # noqa: E402

NPROC = 4
MLP_CASES = ((2, 2), (2, 4), (4, 4))
MLP_GRAD_CASE = (4, 4)
T5_CASES = ((2, 2, 0), (2, 4, 2), (4, 4, 0))
T5_GRAD_CASE = (2, 2, 0)
D, HIDDEN = 16, 32


def _mlp_stage_arrays(s, seed=0):
    """``tests/test_pipeline.py::_stage_params`` as numpy."""
    rng = np.random.default_rng(seed + s)
    return {"w1": (rng.standard_normal((D, HIDDEN)) * 0.3).astype(np.float32),
            "b1": np.zeros((HIDDEN,), np.float32),
            "w2": (rng.standard_normal((HIDDEN, D)) * 0.3).astype(np.float32),
            "b2": np.zeros((D,), np.float32)}


def _mlp_x(m):
    return np.random.default_rng(9).standard_normal((m * 2, D)).astype(np.float32)


def _mlp_grad_x(m):
    return np.random.default_rng(4).standard_normal((m, D)).astype(np.float32)


def _t5_inputs(d_model, vocab):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 12, d_model)).astype(np.float32)
    ids = rng.integers(0, vocab, (4, 6)).astype(np.int32)
    enc_mask = np.asarray([[1] * 12, [1] * 9 + [0] * 3] * 2, np.int32)
    dec_mask = np.asarray([[1] * 6, [1] * 4 + [0] * 2] * 2, np.int32)
    return x, ids, enc_mask, dec_mask


# ------------------------------------------------------------------ worker
def _worker(workdir: Path):
    """One rank: every case, results to ``out_rank<r>.pt``."""
    import torch.distributed as tdist
    from torch import nn

    from mr_blip_tpu_torch import dryrun_multichip
    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.models.t5 import T5ForConditionalGeneration, t5_tiny_config
    from mr_blip_tpu_torch.models.t5_pipeline import (
        build_stage_model,
        global_name,
        stage_state_dict,
        t5_pipeline_forward,
    )
    from mr_blip_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        sequential_reference,
        stack_stage_params,
    )

    dist_utils.init_distributed_mode({"device": "cpu", "dist_timeout_s": 120})
    rank = dist_utils.get_rank()
    pairs = [tdist.new_group([0, 1]), tdist.new_group([2, 3])]
    groups = {2: pairs[rank // 2], 4: None}
    out = {}

    def mlp_stage(p, tree):
        h = torch.tanh(tree["x"] @ p["w1"] + p["b1"])
        return {"x": h @ p["w2"] + p["b2"]}

    def stages(pp, seed=0):
        return [nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v)) for k, v in
                                  _mlp_stage_arrays(s, seed).items()}) for s in range(pp)]

    for pp, m in MLP_CASES:
        stage = stack_stage_params(stages(pp), groups[pp])
        with torch.no_grad():
            y = pipeline_apply(mlp_stage, stage, {"x": torch.from_numpy(_mlp_x(m))},
                               groups[pp], num_microbatches=m)
        out[f"mlp_{pp}_{m}"] = y["x"]
    pp, m = MLP_GRAD_CASE
    stage = stack_stage_params(stages(pp, seed=3), groups[pp])
    pipeline_apply(mlp_stage, stage, {"x": torch.from_numpy(_mlp_grad_x(m))}, groups[pp],
                   num_microbatches=m)["x"].sum().backward()
    out["mlp_grads"] = {k: p.grad.clone() for k, p in stage.items()}

    # bf16 activations, a bool leaf riding along and a bf16 extra that trains:
    # gloo carries neither bf16 nor bool, so they cross as bytes (the extra's
    # gradient summed in fp32)
    def bf16_stage(p, tree, scale):
        h = torch.tanh(tree["x"] @ p["w1"] + p["b1"])
        return {"x": (h @ p["w2"] + p["b2"]) * scale, "keep": tree["keep"]}

    def bf16_run(stage_list, group, pp):
        scale = torch.tensor(1.5, dtype=torch.bfloat16, requires_grad=True)
        x = {"x": torch.from_numpy(_mlp_x(4)).bfloat16(),
             "keep": torch.arange(8) % 3 == 0}
        if group is False:  # the stages back to back in this process
            y = sequential_reference(bf16_stage, stage_list, x, extras=(scale,))
        else:
            y = pipeline_apply(bf16_stage, stack_stage_params(stage_list, group), x, group,
                               num_microbatches=pp, extras=(scale,))
        y["x"].float().sum().backward()
        return y, scale.grad

    bf16_stages = [s.to(torch.bfloat16) for s in stages(2)]
    y, g_scale = bf16_run(bf16_stages, groups[2], 2)
    mine = bf16_stages[tdist.get_rank(groups[2])]
    ref_stages = [s.to(torch.bfloat16) for s in stages(2)]
    y_ref, g_ref = bf16_run(ref_stages, False, 2)
    out["bf16"] = {"x": y["x"].float(), "x_ref": y_ref["x"].float(),
                   "keep": y["keep"], "keep_ref": y_ref["keep"],
                   "scale_grad": g_scale.float(), "scale_grad_ref": g_ref.float(),
                   "grads": {k: p.grad.float() for k, p in mine.items()},
                   "grads_ref": {k: p.grad.float() for k, p in
                                 ref_stages[tdist.get_rank(groups[2])].items()}}

    for pp, layers, lora in T5_CASES:
        case = torch.load(workdir / f"t5_{layers}_{lora}.pt", weights_only=True)
        cfg = t5_tiny_config(num_layers=layers, num_decoder_layers=layers, lora_rank=lora)
        group = groups[pp]
        stage_rank = tdist.get_rank(group)
        model = build_stage_model(cfg, pp)
        model.load_state_dict(stage_state_dict(case["state"], cfg, pp, stage_rank))
        x, ids = case["x"], case["ids"].long()
        kw = dict(encoder_mask=case["enc_mask"], decoder_mask=case["dec_mask"],
                  compute_dtype=torch.float32)
        with torch.no_grad():
            got = t5_pipeline_forward(cfg, model, x, ids, group, num_microbatches=pp, **kw)
            whole = T5ForConditionalGeneration(cfg).eval()
            whole.load_state_dict(case["state"])
            plain = whole.decode(ids, whole.encode(x, mask=case["enc_mask"]),
                                 decoder_mask=case["dec_mask"], encoder_mask=case["enc_mask"])
        res = {"logits": got, "plain": plain}
        if (pp, layers, lora) == T5_GRAD_CASE:
            logits = t5_pipeline_forward(cfg, model, x, ids, group, **kw)
            (logits ** 2).mean().backward()
            res["grads"] = {global_name(n, cfg, pp, stage_rank): p.grad.clone()
                            for n, p in model.named_parameters()}
        out[f"t5_{pp}_{layers}_{lora}"] = res
    torch.save(out, workdir / f"out_rank{rank}.pt")
    dist_utils.barrier()
    out["dryrun_rc"] = dryrun_multichip.main(["--options", "run.device=cpu"])
    torch.save(out, workdir / f"out_rank{rank}.pt")


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
    sys.exit(0)


# ------------------------------------------------------------------- tests
import pytest  # noqa: E402


def _random_tree(shapes, seed):
    """A parameter tree of ``shapes`` (``jax.eval_shape``'s) drawn from a
    numpy seed: norm scales 1 + 0.1 noise, the rest 0.1 noise."""
    import jax
    from flax import traverse_util

    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(lambda s: s, shapes))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.1 * noise
    return traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank launch and the JAX references, computed while it runs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mr_blip_tpu.models.t5 import T5ForConditionalGeneration, t5_tiny_config
    from mr_blip_tpu.models.t5_pipeline import t5_pipeline_forward
    from mr_blip_tpu.parallel.pipeline import pipeline_apply, stack_stage_params
    from mr_blip_tpu_torch.models.convert import state_dict_from_jax

    workdir = tmp_path_factory.mktemp("pp")
    t5 = {}
    for pp, layers, lora in T5_CASES:
        cfg = t5_tiny_config(num_layers=layers, num_decoder_layers=layers, lora_rank=lora)
        model = T5ForConditionalGeneration(cfg, compute_dtype=jnp.float32)
        x, ids, enc_mask, dec_mask = _t5_inputs(cfg.d_model, cfg.vocab_size)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, ids,
                                encoder_mask=enc_mask, decoder_mask=dec_mask)["params"]
        params = _random_tree(shapes, seed=layers * 10 + lora)
        torch.save({"state": state_dict_from_jax(params), "x": torch.from_numpy(x),
                    "ids": torch.from_numpy(ids), "enc_mask": torch.from_numpy(enc_mask),
                    "dec_mask": torch.from_numpy(dec_mask)},
                   workdir / f"t5_{layers}_{lora}.pt")
        t5[(pp, layers, lora)] = (cfg, params, x, ids, enc_mask, dec_mask)
    proc = launch(workdir, Path(__file__), nproc=NPROC)
    try:
        def mesh(pp):
            return Mesh(np.array(jax.devices()[:pp]), ("pp",))

        def mlp_stage(params, x):
            h = jnp.tanh(x @ params["w1"] + params["b1"])
            return h @ params["w2"] + params["b2"]

        def stacked(pp, seed=0):
            tree = stack_stage_params([jax.tree.map(jnp.asarray, _mlp_stage_arrays(s, seed))
                                       for s in range(pp)])
            return jax.device_put(tree, NamedSharding(mesh(pp), P("pp")))

        want = {}
        for pp, m in MLP_CASES:
            want[f"mlp_{pp}_{m}"] = np.asarray(jax.jit(lambda s, x, pp=pp, m=m: pipeline_apply(
                mlp_stage, s, x, mesh(pp), num_microbatches=m))(stacked(pp),
                                                                jnp.asarray(_mlp_x(m))))
        pp, m = MLP_GRAD_CASE
        want["mlp_grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(
            lambda s: pipeline_apply(mlp_stage, s, jnp.asarray(_mlp_grad_x(m)), mesh(pp),
                                     num_microbatches=m).sum()))(stacked(pp, seed=3)))
        for (pp, layers, lora), (cfg, params, x, ids, enc_mask, dec_mask) in t5.items():
            def logits_fn(p, pp=pp, cfg=cfg, x=x, ids=ids, em=enc_mask, dm=dec_mask):
                return t5_pipeline_forward(cfg, p, jnp.asarray(x), jnp.asarray(ids), mesh(pp),
                                           encoder_mask=jnp.asarray(em),
                                           decoder_mask=jnp.asarray(dm),
                                           num_microbatches=pp, compute_dtype=jnp.float32)

            jparams = jax.tree.map(jnp.asarray, params)
            res = {"logits": np.asarray(jax.jit(logits_fn)(jparams))}
            if (pp, layers, lora) == T5_GRAD_CASE:
                grads = jax.jit(jax.grad(lambda p: jnp.mean(logits_fn(p) ** 2)))(jparams)
                res["grads"] = {k: v.numpy() for k, v in state_dict_from_jax(
                    jax.tree.map(np.asarray, grads)).items()}
            want[f"t5_{pp}_{layers}_{lora}"] = res
    except BaseException:
        proc.kill()
        raise
    log = finish(proc)
    ranks = [torch.load(workdir / f"out_rank{r}.pt", weights_only=True) for r in range(NPROC)]
    return {"want": want, "ranks": ranks, "log": log}


@pytest.mark.parametrize("pp,m", MLP_CASES)
def test_pipeline_apply_matches_jax(runs, pp, m):
    key = f"mlp_{pp}_{m}"
    for r in range(NPROC):  # every rank holds the last stage's outputs
        np.testing.assert_allclose(runs["ranks"][r][key].numpy(), runs["want"][key],
                                   rtol=2e-5, atol=2e-5)


def test_pipeline_gradients_match_jax_grad(runs):
    want = runs["want"]["mlp_grads"]
    for r in range(MLP_GRAD_CASE[0]):  # rank r holds stage r
        for k, g in runs["ranks"][r]["mlp_grads"].items():
            np.testing.assert_allclose(g.numpy(), want[k][r], rtol=1e-4, atol=1e-4,
                                       err_msg=f"stage {r} {k}")


def test_pipeline_carries_bf16_and_bool_over_gloo(runs):
    """bf16 activations and gradients, a bool leaf and a bf16 extra's summed
    gradient through the two-stage schedule, against the stages back to
    back in one process (bf16: max |diff| within 1e-2 of the largest; the
    microbatches' gradients add in another order)."""
    for rank in runs["ranks"]:
        got = rank["bf16"]
        assert torch.equal(got["keep"], got["keep_ref"]) and got["keep"].dtype == torch.bool
        for a, b in ((got["x"], got["x_ref"]), (got["scale_grad"], got["scale_grad_ref"]),
                     *((got["grads"][k], got["grads_ref"][k]) for k in got["grads"])):
            a, b = a.detach(), b.detach()
            assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max()), (a, b)
        assert float(got["scale_grad"]) != 0.0


@pytest.mark.parametrize("pp,layers,lora", T5_CASES)
def test_t5_pipeline_forward_matches_jax_and_the_plain_port(runs, pp, layers, lora):
    key = f"t5_{pp}_{layers}_{lora}"
    want = runs["want"][key]["logits"]
    for rank in runs["ranks"]:
        got = rank[key]
        np.testing.assert_allclose(got["logits"].numpy(), want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["logits"].numpy(), got["plain"].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_t5_pipeline_gradients_match_jax_grad(runs):
    """Every tensor's gradient: the blocks from the stage holding them, the
    replicated tensors (embedding, rel-pos tables, final norms, LM head)
    equal on every stage."""
    pp, layers, lora = T5_GRAD_CASE
    key = f"t5_{pp}_{layers}_{lora}"
    want = runs["want"][key]["grads"]
    merged = {}
    for rank in runs["ranks"][:pp]:
        for name, g in rank[key]["grads"].items():
            if name in merged:
                assert torch.equal(merged[name], g), f"{name} differs between stages"
            merged[name] = g
    assert set(merged) == set(want)
    for name, g in merged.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(merged["encoder.rel_bias.rel_embedding"].abs().sum()) > 0


def test_dryrun_multichip_passes_the_jax_bars(runs):
    assert all(r["dryrun_rc"] == 0 for r in runs["ranks"])
    assert (f"dryrun_multichip pp={NPROC} (GPipe over the full T5 stack, one process a "
            "stage, cpu): OK") in runs["log"]
