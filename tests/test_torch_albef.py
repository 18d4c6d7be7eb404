"""ALBEF and the BLIP-v1 wrappers that share it in the port
(``models/albef.py``, the ALBEF and BLIP wrappers of ``zoo_wrappers.py``, the
multimodal classification task, the image datasets and the evaluation entry
point on an NLVR zoo config) against the JAX package, on the CPU.

Tiny configs in fp32 (``fusion_layer`` 1 where the split matters: a
base-like stack of text then fusion layers); every weight is drawn from a
numpy seed into the JAX tree (``jax.eval_shape`` of the flax init) and
carried over by ``state_dict_from_jax``. Bars: modules, losses, logits and
similarity matrices 1e-4; the EMA, the queues and the ring pointer of the
momentum state as JAX computes them (1e-6); predictions, ``rank_answers``
picks, top-k sets and task metrics identical. The random draws (queues,
hard negatives) come from JAX's keys in JAX and from a torch generator in
the port: the test hands the port the JAX state's queues and the negatives
JAX drew.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import mr_blip_tpu  # noqa: F401  (registers the JAX package)
import mr_blip_tpu_torch  # noqa: F401  (registers the port)
from mr_blip_tpu.common.registry import registry as jax_registry
from mr_blip_tpu.datasets import image_datasets as jax_images
from mr_blip_tpu.models import albef as jax_albef
from mr_blip_tpu.models import blip_v1 as jax_blip
from mr_blip_tpu.models import zoo_wrappers as jax_zoo
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets import image_datasets
from mr_blip_tpu_torch.models import albef, blip_v1, med, vit, zoo_wrappers
from mr_blip_tpu_torch.models.convert import state_dict_from_jax

TOL = 1e-4
TINY_IMG = 28


@pytest.fixture(autouse=True)
def _no_bert_vocab(monkeypatch):
    monkeypatch.delenv("MRBLIP_BERT_VOCAB", raising=False)


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(shapes)
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.1 * noise
    return traverse_util.unflatten_dict(flat)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol)


def _close_tree(got, want, tol=TOL):
    flat_got = traverse_util.flatten_dict({"v": got}) if isinstance(got, dict) else {"v": got}
    flat_want = traverse_util.flatten_dict({"v": want}) if isinstance(want, dict) else {
        "v": want}
    assert flat_got.keys() == flat_want.keys()
    for key, w in flat_want.items():
        _close(flat_got[key], w, tol)


def _config(fusion_layer=None):
    """The tiny ALBEF config, with ``fusion_layer`` 1 base-like (layer 0
    text, layer 1 fusion)."""
    cfg = jax_albef.albef_tiny_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                             fusion_layer=fusion_layer))


def _port_config(cfg):
    return albef.ALBEFConfig(embed_dim=cfg.embed_dim,
                             vision=vit.BaseViTConfig(**vars(cfg.vision)),
                             text=med.MedConfig(**vars(cfg.text)), temp=cfg.temp)


def _inputs(n=2, seed=9, length=6):
    rng = np.random.default_rng(seed)
    ims = rng.standard_normal((n, TINY_IMG, TINY_IMG, 3)).astype(np.float32)
    ids = rng.integers(4, 120, (n, length)).astype(np.int32)
    mask = np.ones((n, length), np.int32)
    mask[-1, length - 2:] = 0
    return ims, ids, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pair(jax_cls, port_cls, cfg, init_method, seed, **kw):
    """(JAX module, its parameters, the port's module on them)."""
    jm = jax_cls(cfg, compute_dtype=jnp.float32, **kw)
    ims, ids, mask = _inputs()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ims, ids, mask,
                                            method=init_method))["params"]
    params = _random_tree(shapes, seed)
    port = port_cls(_port_config(cfg), dtype=torch.float32, **kw)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, port.eval()


# ----------------------------------------------------------------- modules
def _albef_init(mdl, ims, ids, mask):
    mdl(ims, ids, mask)
    return mdl.extract_features(ims, ids, mask, mode="multimodal")


@pytest.fixture(scope="module")
def albef_pair():
    """The base-like split (the wrappers' tiny config, every layer
    cross-attending, runs through the retrieval and pretrain wrappers)."""
    return _pair(jax_albef.ALBEF, albef.ALBEF, _config(1), _albef_init, 31)


@pytest.mark.parametrize("method", ["forward", "itc_features", "image_feat", "text_feat",
                                    "itm_logits", "fused_states", "pretrain_states",
                                    "extract_features"])
def test_albef_methods_match_jax(albef_pair, method):
    jm, params, port = albef_pair
    ims, ids, mask = _inputs()
    t_ims, t_ids, t_mask = _t(ims, ids, mask)

    def jax_call(name, *args, **kw):
        return jm.apply({"params": params}, *args, method=name, **kw)

    with torch.no_grad():
        if method == "forward":
            want, got = jm.apply({"params": params}, ims, ids, mask), port(t_ims, t_ids, t_mask)
        elif method == "image_feat":
            want, got = jax_call(method, ims), port.image_feat(t_ims)
        elif method == "text_feat":
            want, got = jax_call(method, ids, mask), port.text_feat(t_ids, t_mask)
        elif method == "fused_states":
            states = jax_call("encode_image", ims)
            want = jax_call(method, states, ids, mask)
            got = port.fused_states(port.encode_image(t_ims), t_ids, t_mask)
        elif method == "extract_features":
            want = {m: jax_call(method, ims, ids, mask, mode=m)
                    for m in ("image", "text", "multimodal")}
            got = {m: port.extract_features(t_ims, t_ids, t_mask, mode=m)
                   for m in ("image", "text", "multimodal")}
        else:
            want = jax_call(method, ims, ids, mask)
            got = getattr(port, method)(t_ims, t_ids, t_mask)
    if isinstance(want, tuple):
        want, got = dict(enumerate(want)), dict(enumerate(got))
    _close_tree(got, want)


def test_fused_states_without_a_split_match_jax():
    """No ``fusion_layer`` (the tiny config): every layer cross-attends."""
    jm, params, port = _pair(jax_albef.ALBEF, albef.ALBEF, _config(None), _albef_init, 32)
    ims, ids, mask = _inputs()
    t_ims, t_ids, t_mask = _t(ims, ids, mask)
    assert all(hasattr(layer, "crossattention") for layer in port.text_encoder.layer)
    with torch.no_grad():
        _close(port.itm_logits(t_ims, t_ids, t_mask),
               jm.apply({"params": params}, ims, ids, mask, method="itm_logits"))


class _Jitted:
    """A flax module whose ``apply`` is jitted (``method`` static): the JAX
    functions (``rank_answers``, ``albef_pretrain_losses``) call ``module.apply``
    op by op otherwise."""

    def __init__(self, module):
        self.config = module.config
        self.apply = jax.jit(module.apply, static_argnames=("method",))


def _nlvr_init(mdl, ims, ids, mask):
    mdl(ims, ims, ids, mask)
    return mdl.classify_single(ims, ids, mask)


@pytest.fixture(scope="module")
def nlvr_pair():
    """AlbefNLVR on the base-like split config: its stack runs "multimodal"
    at every layer, so every layer holds a cross-attention."""
    return _pair(jax_albef.AlbefNLVR, albef.AlbefNLVR, _config(1), _nlvr_init, 33,
                 num_classes=3)


def test_albef_nlvr_pair_single_and_loss_match_jax(nlvr_pair):
    jm, params, port = nlvr_pair
    ims, ids, mask = _inputs()
    ims2 = ims[::-1].copy()
    t_ims, t_ims2, t_ids, t_mask = _t(ims, ims2, ids, mask)
    targets = np.array([2, 0], np.int32)
    with torch.no_grad():
        _close(port(t_ims, t_ims2, t_ids, t_mask), jm.apply({"params": params}, ims, ims2,
                                                            ids, mask))
        _close(port.classify_single(t_ims, t_ids, t_mask),
               jm.apply({"params": params}, ims, ids, mask, method="classify_single"))
        _close(port.loss(t_ims, t_ims2, t_ids, torch.from_numpy(targets), t_mask),
               jm.apply({"params": params}, ims, ims2, ids, targets, mask, method="loss"))
    assert all(hasattr(layer, "crossattention") for layer in port.text_encoder.layer)


def test_albef_nlvr_distill_loss_matches_jax(nlvr_pair):
    jm, params, port = nlvr_pair
    ims, ids, mask = _inputs()
    ims2 = ims[::-1].copy()
    targets = np.array([1, 2], np.int32)
    m_params = _random_tree(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                         params), 34)
    want, want_m = jax_albef.albef_nlvr_distill_loss(jm, params, m_params, ims, ims2, ids,
                                                     targets, mask, alpha=0.3, momentum=0.9)
    got, got_m = albef.albef_nlvr_distill_loss(
        port, state_dict_from_jax(m_params), *_t(ims, ims2, ids, targets, mask), alpha=0.3,
        momentum=0.9)
    _close(got, want)
    want_m = state_dict_from_jax(jax.tree.map(np.asarray, want_m))
    assert got_m.keys() == want_m.keys()
    for k, v in want_m.items():
        _close(got_m[k], v, 1e-6)


def _vqa_init(mdl, ims, ids, mask):
    return mdl.answer_loss(ims, ids, mask, ids, mask)


@pytest.fixture(scope="module")
def vqa_pair():
    return _pair(jax_albef.AlbefVQA, albef.AlbefVQA, _config(1), _vqa_init, 35)


def _answers():
    """Six candidates whose first content tokens repeat (ties in the first
    stage) and two identical rows (a tie in the second)."""
    rng = np.random.default_rng(36)
    ans = rng.integers(4, 120, (6, 4)).astype(np.int32)
    ans[:, 0] = 1
    ans[:, 1] = [7, 9, 7, 9, 7, 11]
    ans[4] = ans[2]
    mask = np.ones((6, 4), np.int32)
    mask[:3, 3] = 0
    return ans, mask


def test_albef_vqa_answer_loss_and_rank_answers_match_jax(vqa_pair):
    jm, params, port = vqa_pair
    ims, ids, mask = _inputs()
    ans, ans_mask = _answers()
    with torch.no_grad():
        _close(port.answer_loss(*_t(ims, ids, mask, ans[:2], ans_mask[:2])),
               jm.apply({"params": params}, ims, ids, mask, ans[:2], ans_mask[:2],
                        method="answer_loss"))
    want = jax_albef.rank_answers(_Jitted(jm), params, ims, ids, mask, ans, ans_mask, k=3)
    got = albef.rank_answers(port, *_t(ims, ids, mask, ans, ans_mask), k=3)
    np.testing.assert_array_equal(got, want)


def test_rank_answers_breaks_ties_by_the_lower_index():
    """Equal first-token scores: the first stage keeps the lower candidate
    index (``jax.lax.top_k``'s order); equal losses: the first pick."""

    class Flat(torch.nn.Module):  # every candidate scores alike
        def question_states(self, images, ids, mask):
            return torch.zeros(images.shape[0], 2, 4)

        def answer_logits(self, q, qm, ans, am):
            return torch.zeros(q.shape[0], ans.shape[1], 16)

    ans = torch.tensor([[1, 5, 6], [1, 5, 7], [1, 3, 6], [1, 5, 8]])
    picks = albef.rank_answers(Flat(), torch.zeros(3, 1), None, None, ans,
                               torch.ones_like(ans), k=2)
    np.testing.assert_array_equal(picks, [0, 0, 0])


# ---------------------------------------------------- pretraining losses
def _pretrain_inputs(b=4):
    return _inputs(n=b, seed=40, length=7)


def _recorded_categorical(monkeypatch):
    """Records what ``jax.random.categorical`` draws (the hard negatives)."""
    drawn, original = [], jax.random.categorical

    def categorical(*args, **kwargs):
        out = original(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "categorical", categorical)
    return drawn


def _port_state(jax_state):
    return {"m_params": state_dict_from_jax(jax.tree.map(np.asarray, jax_state["m_params"])),
            "image_queue": torch.from_numpy(np.array(jax_state["image_queue"])),
            "text_queue": torch.from_numpy(np.array(jax_state["text_queue"])),
            "queue_ptr": int(jax_state["queue_ptr"])}


def _hold_state(got, want):
    want = _port_state(want)
    assert got["queue_ptr"] == want["queue_ptr"]
    for k in ("image_queue", "text_queue"):
        _close(got[k], want[k], 1e-6)
    assert got["m_params"].keys() == want["m_params"].keys()
    for k, v in want["m_params"].items():
        _close(got["m_params"][k], v, 1e-6)


@pytest.mark.parametrize("family", ["albef", "blip_v1"])
def test_pretrain_losses_match_jax(family, monkeypatch):
    """ITC and the EMA and ring enqueue as JAX computes them; ITM on the
    negatives JAX drew. The parameters moved off the momentum copy, the
    queue half full after the step."""
    if family == "albef":
        jm, params, port = _pair(jax_albef.ALBEF, albef.ALBEF, _config(1), _albef_init, 41)
    else:
        cfg = jax_blip.blip_tiny_config()
        jm = jax_blip.BLIPv1(cfg, compute_dtype=jnp.float32)
        ims, ids, _ = _inputs()
        params = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), ims,
                                             ids)["params"], 42)
        port = blip_v1.BLIPv1(blip_v1.BLIPConfig(
            embed_dim=cfg.embed_dim, vision=vit.BaseViTConfig(**vars(cfg.vision)),
            text=med.MedConfig(**vars(cfg.text))), dtype=torch.float32).eval()
        port.load_state_dict(state_dict_from_jax(params), strict=True)
    drawn = _recorded_categorical(monkeypatch)
    state = jax_albef.init_momentum_state(params, jm.config.embed_dim, queue_size=8, seed=3)
    port_state = _port_state(state)
    params = jax.tree.map(lambda a: a + 0.01, params)
    with torch.no_grad():
        for k, v in state_dict_from_jax(params).items():
            port.get_parameter(k).copy_(v)
    ims, ids, mask = _inputs(n=4, seed=40, length=7)
    want, state = jax_albef.albef_pretrain_losses(
        _Jitted(jm), params, state, ims, ids, mask, jax.random.PRNGKey(1), alpha=0.4, momentum=0.9)
    assert len(drawn) == 2
    got, port_state = albef.albef_pretrain_losses(
        port, port_state, *_t(ims, ids, mask), alpha=0.4, momentum=0.9, neg_idx=tuple(drawn))
    for k in ("loss_itc", "loss_itm", "loss"):
        _close(got[k], want[k])
    _hold_state(port_state, state)


def test_pretrain_losses_draw_off_diagonal_negatives():
    """The port's own draw: the hard negatives come from the torch generator,
    never the matching pair, and the same seed draws the same negatives."""
    cfg = _port_config(_config(1))
    port = albef.ALBEF(cfg, dtype=torch.float32).eval()
    zoo_wrappers.init_blip_weights_(port, 5)
    ims, ids, mask = _t(*_inputs(n=4, seed=43, length=7))
    draws = []
    original = torch.multinomial

    def multinomial(probs, n, **kw):
        out = original(probs, n, **kw)
        draws.append(out[:, 0])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "multinomial", multinomial)
        for _ in range(2):
            state = albef.init_momentum_state(port, cfg.embed_dim, 8,
                                              torch.Generator().manual_seed(0))
            albef.albef_pretrain_losses(port, state, ims, ids, mask,
                                        generator=torch.Generator().manual_seed(1))
    assert all((d != torch.arange(4)).all() for d in draws)
    assert torch.equal(draws[0], draws[2]) and torch.equal(draws[1], draws[3])
    assert albef.rampup_factor(0, 5, 10) == jax_albef.rampup_factor(0, 5, 10) == 0.5


# ---------------------------------------------------------------- wrappers
JAX_MODULES = (jax_albef.ALBEF, jax_albef.AlbefNLVR, jax_albef.AlbefVQA, jax_blip.BLIPv1)


def _jax_wrapper(cls, seed, **kwargs):
    """The JAX wrapper with its parameters drawn from ``seed`` into the
    shapes of ``jax.eval_shape`` of its flax init (the slow part)."""
    with pytest.MonkeyPatch.context() as mp:
        for module_cls in JAX_MODULES:
            def shapes_only(self, *args, _init=module_cls.init, **kw):
                shapes = jax.eval_shape(lambda: _init(self, *args, **kw))
                return {"params": _random_tree(shapes["params"], seed)}

            mp.setattr(module_cls, "init", shapes_only)
        jm = cls(model_size="tiny", **kwargs)
    jm.params = jax.tree.map(jnp.asarray, jm.params)
    return jm


def _wrapper_pair(name, seed, strict=True, **kwargs):
    jm = _jax_wrapper(jax_registry.get_model_class(name), seed, **kwargs)
    port = registry.get_model_class(name)(model_size="tiny", device="cpu", **kwargs)
    missing, unexpected = port.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, jm.params)), strict=strict)
    return jm, port, missing, unexpected


def _samples(b=2, seed=50, answers=False):
    rng = np.random.default_rng(seed)
    out = {"image": rng.standard_normal((b, TINY_IMG, TINY_IMG, 3)).astype(np.float32),
           "image2": rng.standard_normal((b, TINY_IMG, TINY_IMG, 3)).astype(np.float32),
           "text_input": [f"the left image shows {i} dogs near a table" for i in range(b)],
           "label": [int(i) for i in rng.integers(0, 2, b)],
           "image_id": [f"img{i}" for i in range(b)]}
    if answers:
        out["answers"] = [["two dogs", "dogs"], "a table"][:b]
    return out


@pytest.mark.parametrize("name,kwargs", [("albef_nlvr_model", {}),
                                         ("albef_classification", {"num_classes": 3}),
                                         ("blip_classification", {"num_classes": 3}),
                                         ("blip_nlvr", {})])
def test_classification_wrappers_match_jax(name, kwargs):
    jm, port, missing, unexpected = _wrapper_pair(name, 51, strict=False, **kwargs)
    assert not unexpected
    if name == "blip_classification":  # JAX builds only what classify reads
        assert {k.split(".")[0] for k in missing} == {"text_decoder", "lm_head",
                                                      "vision_proj", "text_proj", "itm_head"}
    else:
        assert not missing
    batch = _samples(b=3)
    _close(port(batch)["loss"], jm(batch)["loss"])
    got, want = port.predict(batch), jm.predict(batch)
    assert got == want and len(got["predictions"]) == 3


def test_albef_retrieval_wrapper_matches_jax():
    jm, port, _, _ = _wrapper_pair("albef_retrieval", 52)
    assert isinstance(port.module, albef.ALBEF)
    rng = np.random.default_rng(53)
    batches = [{"image": rng.standard_normal((2, TINY_IMG, TINY_IMG, 3)).astype(np.float32),
                "text_input": [f"thing {lo + i} in a field" for i in range(2)],
                "image_id": [f"img{lo + i}" for i in range(2)]} for lo in (0, 2, 4)]
    _close(port(batches[0])["loss"], jm(batches[0])["loss"])
    for g, w in zip(port.compute_sim_matrix(batches, k_test=3),
                    jm.compute_sim_matrix(batches, k_test=3)):
        _close(g, w)
        assert ((g > -100) == (w > -100)).all(), "top-k sets differ"


@pytest.mark.parametrize("name", ["albef_pretrain", "blip_pretrain"])
def test_pretrain_wrappers_match_jax(name, monkeypatch):
    """Two forwards: the momentum state the wrapper carries (JAX's queues
    handed over once) moves as JAX's does, the second step reading the
    first's queues; the negatives are JAX's draws."""
    jm, port, _, _ = _wrapper_pair(name, 54)
    jm.module = _Jitted(jm.module)
    port.momentum_state = _port_state(jm.momentum_state)
    drawn = _recorded_categorical(monkeypatch)
    for step in range(2):
        batch = _samples(b=4, seed=55 + step)
        drawn.clear()
        want = jm(batch)
        got = port(batch, neg_idx=tuple(drawn))
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
        _hold_state(port.momentum_state, jm.momentum_state)


def test_blip_vqa_wrapper_matches_jax():
    answers = ["yes", "no", "two dogs", "two cats", "a table", "two dogs"]
    jm, port, _, _ = _wrapper_pair("blip_vqa", 56, answer_list=answers)
    jm.module = _Jitted(jm.module)
    batch = _samples(b=2, answers=True)
    _close(port(batch)["loss"], jm(batch)["loss"])
    assert port.predict_answers(batch, 3) == jm.predict_answers(batch, 3)


def test_feature_extractor_and_itm_wrappers_match_jax():
    jm, port, _, _ = _wrapper_pair("blip_image_text_matching", 57)
    assert isinstance(port, zoo_wrappers.BlipFeatureExtractorModel)
    batch = _samples(b=2)
    for mode in ("image", "text", "multimodal"):
        _close_tree(port.extract_features(batch, mode), jm.extract_features(batch, mode))
    for head in ("itm", "itc"):
        _close(port.itm(batch, head), jm.itm(batch, head))
    jm, port, _, _ = _wrapper_pair("blip_feature_extractor", 58)
    _close_tree(port.extract_features(batch), jm.extract_features(batch))


# ------------------------------------------------------------ task, data
class _ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def test_multimodal_classification_metrics_identical_to_jax(tmp_path):
    class Fixed:  # predictions 0, 1, 1 against labels 0, 1, 0
        def predict(self, samples):
            return {"predictions": [0, 1, 1][:len(samples["label"])],
                    "targets": list(np.asarray(samples["label"], np.int64))}

    batches = [{"label": [0, 1, 0]}, {"label": [1]}]
    logs = []
    for reg, sub in ((jax_registry, "jax"), (registry, "port")):
        reg.register_path("result_dir", str(tmp_path / sub))
        task = reg.get_task_class("multimodal_classification")()
        val = task.evaluation(Fixed(), _ListLoader(batches))
        logs.append((val, task.after_evaluation(val, "val", 0)))
    assert logs[0] == logs[1]
    assert logs[1][1]["acc"] == 50.0 and logs[1][1]["total"] == 4


def _ann(path, rows):
    path.write_text(json.dumps(rows))
    return str(path)


def test_dataset_rows_match_jax(tmp_path, monkeypatch):
    from mr_blip_tpu.processors.text_processors import BlipCaptionProcessor as JaxCaption
    from mr_blip_tpu_torch.processors.text_processors import BlipCaptionProcessor

    names = ("ImageQADataset", "ClassificationDataset", "ImageTextPairDataset",
             "ImageFolderDataset")
    for mod in (image_datasets, jax_images):
        for name in names:
            monkeypatch.setattr(getattr(mod, name), "image_size", TINY_IMG)
    anns = {
        "ImageQADataset": [{"image": f"1x40x48#{i}", "question": f"What Is {i}?",
                            "question_id": i, "answers": ["a", "b"]} for i in range(2)]
        + [{"image": "1x40x48#9", "question": "Why?", "answer": "no"}],
        "ClassificationDataset": [  # NLVR pairs, then an SNLI-VE row
            {"image": f"1x40x48#{i}", "image2": f"1x32x32#{i + 5}",
             "sentence": f"Two Dogs, {i}!", "label": i % 2} for i in range(2)]
        + [{"image": "1x40x48#7", "sentence": "A cat.", "label": 2, "instance_id": "x"}],
        "ImageTextPairDataset": [{"image": f"1x40x48#{i}", "caption": f"A Pair; {i}"}
                                 for i in range(2)],
        "ImageFolderDataset": [{"image": f"1x40x48#{i}", "label": i} for i in range(2)],
    }
    for name in names:
        ann = _ann(tmp_path / f"{name}.json", anns[name])
        kw = dict(vis_root="synthetic://", ann_paths=[ann])
        port = getattr(image_datasets, name)(text_processor=BlipCaptionProcessor(), **kw)
        ref = getattr(jax_images, name)(text_processor=JaxCaption(), **kw)
        assert len(port) == len(ref) == len(anns[name])
        for i in range(len(port)):
            got, want = port[i], ref[i]
            assert got.keys() == want.keys()
            for key in ("image", "image2"):
                if key in want:
                    np.testing.assert_array_equal(got[key], want[key])
                    assert got[key].shape == (TINY_IMG, TINY_IMG, 3)
            assert {k: v for k, v in got.items() if not k.startswith("image")} == {
                k: v for k, v in want.items() if not k.startswith("image")}


def test_image_folder_scan_matches_jax(tmp_path):
    """No annotation rows: the class-per-directory tree under ``vis_root``
    (sorted class names, image extensions only)."""
    for cls, files in (("zebra", ["b.png", "a.JPG", "notes.txt"]), ("ant", ["x.webp"]),
                       ("empty", [])):
        os.makedirs(tmp_path / cls)
        for f in files:
            (tmp_path / cls / f).write_bytes(b"")
    (tmp_path / "stray.jpg").write_bytes(b"")
    port = image_datasets.ImageFolderDataset(vis_root=str(tmp_path))
    ref = jax_images.ImageFolderDataset(vis_root=str(tmp_path))
    assert port.annotation == ref.annotation and port.classnames == ref.classnames
    assert port.annotation == [{"image": "ant/x.webp", "label": 0},
                               {"image": "zebra/a.JPG", "label": 2},
                               {"image": "zebra/b.png", "label": 2}]


def test_registered_builders_are_the_jax_package_s():
    def names(reg, module):
        return {n for n, c in reg.mapping["builder_name_mapping"].items()
                if c.__module__ == module}

    got = names(registry, "mr_blip_tpu_torch.datasets.image_datasets")
    assert got == names(jax_registry, "mr_blip_tpu.datasets.image_datasets")
    assert {"nocaps", "coco_vqa", "ok_vqa", "aok_vqa", "gqa", "vg_vqa", "nlvr", "snli_ve",
            "conceptual_caption_3m", "conceptual_caption_12m", "sbu_caption", "vg_caption",
            "laion2B_multi", "imagenet"} <= got
    for name in got:
        assert registry.get_builder_class(name).data_type == "images"
        assert (registry.get_builder_class(name).train_dataset_cls.__name__
                == jax_registry.get_builder_class(name).train_dataset_cls.__name__)


@pytest.mark.parametrize("name", ["albef_nlvr_model", "albef_retrieval", "albef_pretrain",
                                  "albef_classification", "blip_classification", "blip_nlvr",
                                  "blip_vqa", "blip_feature_extractor",
                                  "blip_image_text_matching", "blip_pretrain"])
def test_from_config_reads_the_jax_wrappers_keys(name):
    """Each wrapper's ``from_config`` builds its own class from the keys the
    JAX one reads (``model_size``, and ``num_classes``, ``queue_size`` /
    ``alpha`` or ``answer_list`` where it reads them)."""
    cfg = {"model_size": "tiny", "num_classes": 2, "queue_size": 8, "alpha": 0.3,
           "answer_list": ["a", "b"]}
    cls = registry.get_model_class(name)
    model = cls.from_config(cfg, device="cpu")
    assert type(model) is cls and model.model_size == "tiny"
    for key in ("num_classes", "alpha", "answer_list"):
        if hasattr(model, key):
            assert getattr(model, key) == cfg[key], key
    if hasattr(model, "momentum_state"):
        assert model.momentum_state["image_queue"].shape == (8, model.config.embed_dim)
    if name in ("albef_classification", "blip_classification"):
        batch = _samples(b=2)
        assert model.predict(batch)["predictions"][0] in (0, 1)


def test_load_model_and_preprocess_albef_nlvr():
    from mr_blip_tpu_torch.models import load_model_and_preprocess

    model, vis, txt = load_model_and_preprocess("albef_nlvr_model", "nlvr", device="cpu")
    assert isinstance(model, zoo_wrappers.AlbefNLVRModel) and model.model_size == "tiny"
    assert vis["eval"].image_size == vis["train"].image_size == TINY_IMG
    base = zoo_wrappers.AlbefNLVRModel.__new__(zoo_wrappers.AlbefNLVRModel)
    base.config = albef.albef_base_config()
    assert base.img_size == 224 and base.config.text.fusion_layer == 6


# ----------------------------------------------------------- entry points
def _tiny_nlvr_config(tmp_path):
    """nlvr_eval.yaml at the tiny widths, over synthetic image pairs."""
    rows = [{"image": f"1x40x48#{i}", "image2": f"1x40x48#{i + 10}",
             "sentence": f"There are {i} dogs in the left image.", "label": i % 2}
            for i in range(5)]
    ann = _ann(tmp_path / "nlvr.json", rows)
    path = tmp_path / "tiny_nlvr.yaml"
    path.write_text(
        "model:\n  arch: albef_nlvr_model\n  model_type: nlvr\n  model_size: tiny\n"
        "datasets:\n  nlvr:\n    text_processor:\n      eval:\n        name: blip_caption\n"
        "    build_info:\n      annotations:\n"
        + "".join(f"        {s}:\n          storage: {ann}\n" for s in ("train", "val", "test"))
        + "      images:\n        storage: synthetic://\n"
        f"run:\n  task: multimodal_classification\n  batch_size_eval: 2\n  num_workers: 1\n"
        f"  output_dir: {tmp_path / 'out'}\n  evaluate: True\n  test_splits: ['test']\n"
        "  device: tpu\n  distributed: False\n")
    return str(path)


def test_evaluate_tiny_nlvr_config_identical_to_jax(tmp_path, monkeypatch):
    """The runners' evaluation of a tiny NLVR zoo config, JAX then port, on
    the same weights: rows and metrics identical; then
    ``mr_blip_tpu_torch.evaluate.main`` as a user runs it on the host."""
    from mr_blip_tpu import tasks as jax_tasks
    from mr_blip_tpu.common.config import Config as JaxConfig
    from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
    from mr_blip_tpu_torch import evaluate, tasks
    from mr_blip_tpu_torch.common.config import Config
    from mr_blip_tpu_torch.runners.runner_base import RunnerBase

    for cls in (image_datasets.ClassificationDataset, jax_images.ClassificationDataset):
        monkeypatch.setattr(cls, "image_size", TINY_IMG)
    cfg_path = _tiny_nlvr_config(tmp_path)
    jmodel, port_model, _, _ = _wrapper_pair("albef_nlvr_model", 60)
    jcfg = JaxConfig(cfg_path=cfg_path, options=[f"run.output_dir={tmp_path / 'jax'}"])
    jtask = jax_tasks.setup_task(jcfg)
    assert jax_registry.get_model_class(jcfg.model_cfg.arch) is type(jmodel)

    class OneDevice(JaxRunnerBase):
        mesh = None  # evaluate.py's single-device run

    want = OneDevice(cfg=jcfg, job_id="job", task=jtask, model=jmodel,
                     datasets=jtask.build_datasets(jcfg)).evaluate(skip_reload=True)
    cfg = Config(cfg_path=cfg_path, options=[f"run.output_dir={tmp_path / 'port'}",
                                             "run.device=cpu"])
    ptask = tasks.setup_task(cfg)
    built = ptask.build_model(cfg)
    assert type(built) is type(port_model) and built.model_size == "tiny"
    got = RunnerBase(cfg=cfg, job_id="job", task=ptask, model=port_model,
                     datasets=ptask.build_datasets(cfg)).evaluate(skip_reload=True)
    assert got == want and got["test"]["total"] == 5
    rows = [json.loads((tmp_path / sub / "job" / "result" / "test_epochbest.json").read_text())
            for sub in ("jax", "port")]
    assert rows[0] == rows[1]
    logs = evaluate.main(["--cfg-path", cfg_path, "--options", "run.device=cpu"])
    assert set(logs["test"]) == {"agg_metrics", "acc", "total"}


def test_published_nlvr_config_builds_the_tiny_model(monkeypatch):
    """``nlvr_eval.yaml`` sets ``model_type: nlvr``, which neither package's
    wrapper reads: both build the tiny model (ROADMAP Queue 3);
    ``model.model_size=base`` reaches the wrapper (ALBEF base: ViT-B/16 at
    224, fusion at layer 6; its build is phase 28's on the card)."""
    from mr_blip_tpu_torch import tasks
    from mr_blip_tpu_torch.common.config import Config

    path = "configs/projects/zoo/nlvr_eval.yaml"
    cfg = Config(cfg_path=path, options=["run.device=cpu"])
    task = tasks.setup_task(cfg)
    assert isinstance(task, registry.get_task_class("multimodal_classification"))
    assert task.build_model(cfg).model_size == "tiny"
    cfg = Config(cfg_path=path, options=["run.device=cpu", "model.model_size=base"])
    built = []
    monkeypatch.setattr(zoo_wrappers.AlbefNLVRModel, "__init__",
                        lambda self, **kw: built.append(kw))
    task.build_model(cfg)
    assert built[0]["model_size"] == "base" and built[0]["device"] == torch.device("cpu")
    base = zoo_wrappers._albef_config("base")
    assert base.vision.img_size == 224 and base.text.fusion_layer == 6
