"""The BLIP-v1 zoo's evaluation path in the port (``models/vit.py``,
``models/med.py``, ``models/blip_v1.py``, ``models/zoo_wrappers.py``, the
captioning and retrieval tasks, the image datasets and processors,
WordPiece, the caption metrics) against the JAX package, on the CPU.

Tiny configs in fp32; every weight is drawn from a numpy seed into the JAX
tree (``jax.eval_shape`` of the flax init where the test builds a module
itself) and carried over by ``state_dict_from_jax``, which must consume
every leaf and load ``strict=True``. Bars: modules and losses 1e-4, the
similarity matrices 1e-4 with equal top-k sets, captions (greedy and beam 3)
and task metrics identical. The text side is the hash-bucket WordTokenizer
in both packages (no BERT vocabulary in the repo); WordPiece is held against
the JAX tokenizer over a vocabulary the test writes.
"""

import json

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
from mr_blip_tpu.models import blip_v1 as jax_blip
from mr_blip_tpu.models import med as jax_med
from mr_blip_tpu.models import vit as jax_vit
from mr_blip_tpu.models import zoo_wrappers as jax_zoo
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets import image_datasets
from mr_blip_tpu_torch.models import blip_v1, med, vit, zoo_wrappers
from mr_blip_tpu_torch.models.convert import state_dict_from_jax

TOL = 1e-4
TINY_IMG = 28
K_TEST = 3  # one k and one batch of 2 everywhere: the JAX wrappers' steps compile once


@pytest.fixture(autouse=True)
def _no_bert_vocab(monkeypatch):
    monkeypatch.delenv("MRBLIP_BERT_VOCAB", raising=False)


def _random_tree(shapes, seed):
    """Parameters of ``shapes`` from a numpy seed: LayerNorm scales 1 + 0.1
    noise, the rest 0.1 noise (biases too, so that each one counts)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(shapes)
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.1 * noise
    return traverse_util.unflatten_dict(flat)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(params), strict=True)
    return module.eval()


def _images(n, seed=0, size=TINY_IMG):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=tol, atol=tol)


# ----------------------------------------------------------------- modules
@pytest.mark.parametrize("act,pre_norm", [("gelu", False), ("quick_gelu", True)])
def test_vision_transformer_matches_jax(act, pre_norm):
    cfg = jax_vit.BaseViTConfig(img_size=TINY_IMG, patch_size=14, embed_dim=32, depth=2,
                                num_heads=2, act=act, pre_norm=pre_norm)
    jm = jax_vit.VisionTransformer(cfg, compute_dtype=jnp.float32)
    ims = _images(3)
    params = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), ims)["params"], 1)
    want = jm.apply({"params": params}, ims)
    port = _load(vit.VisionTransformer(vit.BaseViTConfig(**vars(cfg)), dtype=torch.float32),
                 params)
    _close(port(torch.from_numpy(ims)), want)


def _med_inputs(cfg):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 5:] = 0
    states = rng.standard_normal((3, 5, cfg.encoder_width)).astype(np.float32)
    image_mask = np.ones((3, 5), np.int32)
    image_mask[2, 3:] = 0
    return ids, mask, states, image_mask


@pytest.mark.parametrize("mode", ["text", "multimodal", "decoder", "fusion"])
def test_med_model_modes_match_jax(mode):
    """BLIP's stack (cross-attention in every layer) in the first three
    modes; an ALBEF-style split (``fusion_layer`` 1: text then fusion) for
    the fourth."""
    cfg = jax_med.med_tiny_config(fusion_layer=1 if mode == "fusion" else None)
    jm = jax_med.MedModel(cfg, compute_dtype=jnp.float32)
    ids, mask, states, image_mask = _med_inputs(cfg)

    def init(mdl, ids, mask, states, image_mask):
        text = mdl(ids, mask, mode="text")
        if mode == "fusion":
            return mdl(None, mask, states, image_mask, mode="fusion", input_embeds=text)
        return mdl(ids, mask, states, image_mask, mode="multimodal")

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ids, mask, states,
                                            image_mask, method=init))["params"]
    params = _random_tree(shapes, 2)
    port = _load(med.MedModel(med.MedConfig(**vars(cfg)), dtype=torch.float32), params)
    t = {k: torch.from_numpy(v) for k, v in
         dict(ids=ids, mask=mask, states=states, image_mask=image_mask).items()}
    if mode == "fusion":
        text = jm.apply({"params": params}, ids, mask, mode="text")
        want = jm.apply({"params": params}, None, mask, states, image_mask, mode="fusion",
                        input_embeds=text)
        got = port(None, t["mask"], t["states"], t["image_mask"], mode="fusion",
                   input_embeds=torch.from_numpy(np.asarray(text)))
    else:
        want = jm.apply({"params": params}, ids, mask, states, image_mask, mode=mode)
        got = port(t["ids"], t["mask"], t["states"], t["image_mask"], mode=mode)
    _close(got, want)


def test_med_lm_head_matches_jax():
    cfg = jax_med.med_tiny_config()
    jm = jax_med.MedLMHead(cfg, compute_dtype=jnp.float32)
    h = np.random.default_rng(6).standard_normal((2, 4, cfg.hidden_size)).astype(np.float32)
    params = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), h)["params"], 3)
    port = _load(med.MedLMHead(med.MedConfig(**vars(cfg)), dtype=torch.float32), params)
    got = port(torch.from_numpy(h))
    assert got.dtype == torch.float32
    _close(got, jm.apply({"params": params}, h))


@pytest.fixture(scope="module")
def blip_pair():
    """(JAX module, its parameters, the port's module) of the tiny BLIPv1
    with a 3-way classification head, every method's parameters drawn."""
    import dataclasses

    cfg = dataclasses.replace(jax_blip.blip_tiny_config(), num_classes=3)
    jm = jax_blip.BLIPv1(cfg, compute_dtype=jnp.float32)
    ims, ids, mask = _blip_inputs()

    def every_method(mdl, ims, ids, mask):
        mdl(ims, ids, mask)
        mdl.classify(ims, ids, mask)
        return mdl.vqa_answer_loss(ims, ids, mask, ids, mask)

    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), ims, ids, mask,
                                            method=every_method))["params"]
    params = _random_tree(shapes, 4)
    port_cfg = blip_v1.BLIPConfig(
        embed_dim=cfg.embed_dim, vision=vit.BaseViTConfig(**vars(cfg.vision)),
        text=med.MedConfig(**vars(cfg.text)), temp=cfg.temp, num_classes=3)
    port = _load(blip_v1.BLIPv1(port_cfg, dtype=torch.float32), params)
    return jm, params, port


def _blip_inputs():
    ims = _images(2, seed=9)
    ids = np.random.default_rng(9).integers(4, 120, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    return ims, ids, mask


@pytest.mark.parametrize("method", ["forward", "classify", "vqa_answer_loss",
                                    "extract_features", "nlvr_logits", "answer_logits",
                                    "caption_step_logits"])
def test_blip_v1_method_surface_matches_jax(blip_pair, method):
    """The module's methods beyond captioning and retrieval, against JAX's."""
    jm, params, port = blip_pair
    ims, ids, mask = _blip_inputs()
    t_ims, t_ids, t_mask = (torch.from_numpy(a) for a in (ims, ids, mask))

    def jax_call(name, *args, **kw):
        return jm.apply({"params": params}, *args, method=name, **kw)

    with torch.no_grad():
        if method == "forward":
            want, got = jm.apply({"params": params}, ims, ids, mask), port(t_ims, t_ids, t_mask)
        elif method == "classify":
            want, got = jax_call("classify", ims, ids, mask), port.classify(t_ims, t_ids, t_mask)
        elif method == "vqa_answer_loss":
            want = jax_call("vqa_answer_loss", ims, ids, mask, ids[:, ::-1].copy(), mask)
            got = port.vqa_answer_loss(t_ims, t_ids, t_mask, t_ids.flip(1), t_mask)
        elif method == "extract_features":
            want = {mode: jax_call("extract_features", ims, ids, mask, mode=mode)
                    for mode in ("image", "text", "multimodal")}
            got = {mode: port.extract_features(t_ims, t_ids, t_mask, mode=mode)
                   for mode in ("image", "text", "multimodal")}
        elif method == "nlvr_logits":
            want = jax_call("nlvr_logits", ims, ims[::-1].copy(), ids, mask)
            got = port.nlvr_logits(t_ims, t_ims.flip(0), t_ids, t_mask)
        elif method == "answer_logits":
            q = jax_call("question_states", ims, ids, mask)
            want = jax_call("answer_logits", q, mask, ids, mask)
            got = port.answer_logits(port.question_states(t_ims, t_ids, t_mask), t_mask,
                                     t_ids, t_mask)
        else:
            want = jax_call("caption_step_logits", ims, ids)
            got = port.caption_step_logits(t_ims, t_ids)
    flat_want = traverse_util.flatten_dict({"v": want}) if isinstance(want, dict) else {
        "v": want}
    flat_got = traverse_util.flatten_dict({"v": got}) if isinstance(got, dict) else {
        "v": got}
    assert flat_got.keys() == flat_want.keys()
    for key, w in flat_want.items():
        _close(flat_got[key], w)


# ---------------------------------------------------------------- wrappers
def _jax_wrapper(cls, seed):
    """The JAX wrapper with its parameters drawn from ``seed`` into the
    shapes of ``jax.eval_shape`` of its flax init (the init itself, eager
    op by op, is the slow part of building it)."""
    def shapes_only(self, *args, **kwargs):
        shapes = jax.eval_shape(lambda: flax_init(self, *args, **kwargs))
        return {"params": _random_tree(shapes["params"], seed)}

    flax_init = jax_blip.BLIPv1.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blip.BLIPv1, "init", shapes_only)
        jm = cls(model_size="tiny")
    jm.params = jax.tree.map(jnp.asarray, jm.params)
    return jm


@pytest.fixture(scope="module")
def caption_pair():
    """(JAX wrapper, port wrapper) of the tiny captioner on the same weights."""
    jm = _jax_wrapper(jax_zoo.BlipCaptionModel, 11)
    port = zoo_wrappers.BlipCaptionModel(model_size="tiny", device="cpu")
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jm.params)))
    return jm, port


@pytest.fixture(scope="module")
def retrieval_pair():
    jm = _jax_wrapper(jax_zoo.BlipRetrievalModel, 12)
    port = zoo_wrappers.BlipRetrievalModel(model_size="tiny", device="cpu")
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jm.params)))
    return jm, port


def _batches(n_batches=3, b=2, captions_per_image=1, seed=0):
    rng = np.random.default_rng(seed)
    out, k = [], 0
    for _ in range(n_batches):
        caps = [f"object {k + i} in a scene number {(k + i) % 3}" for i in range(b)]
        out.append({"image": rng.standard_normal((b, TINY_IMG, TINY_IMG, 3)).astype(np.float32),
                    "text_input": caps,
                    "image_id": [f"img{(k + i) // captions_per_image}" for i in range(b)],
                    "gt_captions": [[c] for c in caps]})
        k += b
    return out


def test_caption_loss_and_captions_match_jax(caption_pair):
    jm, port = caption_pair
    batch = _batches(1, b=2)[0]  # the tasks' batch: the JAX steps compile once
    _close(port(batch)["loss"], jm(batch)["loss"])
    ims_j, ims_t = jnp.asarray(batch["image"]), torch.from_numpy(batch["image"])
    np.testing.assert_array_equal(port._greedy(ims_t, 10).numpy(),
                                  np.asarray(jm._greedy(jm.params, ims_j, 10)))
    np.testing.assert_array_equal(port._beam(ims_t, 10, 3, 2, 1.0).numpy(),
                                  np.asarray(jm._beam(jm.params, ims_j, 10, 3, 2, 1.0)))
    for beams in (1, 3):
        assert (port.generate(batch, max_length=10, num_beams=beams, min_length=2)
                == jm.generate(batch, max_length=10, num_beams=beams, min_length=2))


def test_retrieval_loss_and_sim_matrix_match_jax(retrieval_pair):
    jm, port = retrieval_pair
    batches = _batches(3, b=2)
    _close(port(batches[0])["loss"], jm(batches[0])["loss"])
    for k_test in (K_TEST,):
        got, want = port.compute_sim_matrix(batches, k_test=k_test), \
            jm.compute_sim_matrix(batches, k_test=k_test)
        for g, w in zip(got, want):
            _close(g, w)
            assert ((g > -100) == (w > -100)).all(), "top-k sets differ"
            assert ((g > -100).sum(axis=1) == min(k_test, g.shape[1])).all()


class _ListLoader:
    def __init__(self, batches, dataset=None):
        self.batches, self.dataset = batches, dataset

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


@pytest.mark.parametrize("task_name", ["captioning", "retrieval"])
def test_task_metrics_identical_to_jax(task_name, caption_pair, retrieval_pair, tmp_path):
    jm, port = caption_pair if task_name == "captioning" else retrieval_pair
    kw = dict(num_beams=3, max_len=10, min_len=2) if task_name == "captioning" else dict(
        k_test=K_TEST)
    batches = _batches(3, b=2)
    logs = []
    for reg, model, sub in ((jax_registry, jm, "jax"), (registry, port, "port")):
        reg.register_path("result_dir", str(tmp_path / sub))
        task = reg.get_task_class(task_name)(**kw)
        logs.append(task.after_evaluation(task.evaluation(model, _ListLoader(batches)),
                                          "val", 0))
    assert logs[0] == logs[1]
    assert logs[1]["tokenizer_fallback"] is True
    assert all(np.isfinite(v) for v in logs[1].values() if isinstance(v, float))


def test_retrieval_task_reads_the_datasets_ground_truth(retrieval_pair, tmp_path):
    """Two captions an image: the port reads ``i2t_gt`` through the loader
    the runner hands it (a ``PrefetchLoader`` round the dataset's); the JAX
    runner's loader has no ``dataset``, and the JAX task's identity ground
    truth raises there (ROADMAP Queue 3)."""
    from mr_blip_tpu_torch.datasets.loader import PrefetchLoader
    from mr_blip_tpu_torch.metrics.caption_metrics import retrieval_metrics

    _, port = retrieval_pair
    batches = _batches(3, b=2, captions_per_image=2)

    class Gallery:
        i2t_gt = {0: [0, 1], 1: [2, 3], 2: [4, 5]}

    loader = PrefetchLoader(_ListLoader(batches, Gallery()), device="cpu")
    task = registry.get_task_class("retrieval")(k_test=4)
    val = task.evaluation(port, loader)
    assert val["i2t_gt"] == Gallery.i2t_gt and val["sims"].shape == (3, 6)
    metrics = task.after_evaluation(val, "val", 0)
    want = retrieval_metrics(val["sims"], Gallery.i2t_gt, score_matrix_t2i=val["sims_t2i"])
    assert {k: metrics[k] for k in want} == want
    jax_task = jax_registry.get_task_class("retrieval")(k_test=4)
    with pytest.raises(KeyError):
        jax_task.after_evaluation(dict(val, i2t_gt=None), "val", 0)


# ---------------------------------------------------------- data and text
def _annotations(path, n_images=3, per_image=2):
    anns = [{"image": f"1x48x64#{i}", "caption": f"A Photo; of thing {i}, take {j}!",
             "image_id": f"img{i}"} for i in range(n_images) for j in range(per_image)]
    path.write_text(json.dumps(anns))
    return str(path)


def test_dataset_rows_match_jax(tmp_path, monkeypatch):
    from mr_blip_tpu.processors.text_processors import BlipCaptionProcessor as JaxCaption
    from mr_blip_tpu_torch.processors.text_processors import BlipCaptionProcessor

    ann = _annotations(tmp_path / "ann.json")
    for cls in (image_datasets.CaptionDataset, jax_images.CaptionDataset):
        monkeypatch.setattr(cls, "image_size", TINY_IMG)
    for port_cls, jax_cls in ((image_datasets.CaptionDataset, jax_images.CaptionDataset),
                              (image_datasets.RetrievalDataset, jax_images.RetrievalDataset)):
        port = port_cls(text_processor=BlipCaptionProcessor(prompt="a picture of "),
                        vis_root="synthetic://", ann_paths=[ann])
        ref = jax_cls(text_processor=JaxCaption(prompt="a picture of "),
                      vis_root="synthetic://", ann_paths=[ann])
        assert len(port) == len(ref) == 6
        for i in range(len(port)):
            got, want = port[i], ref[i]
            assert got.keys() == want.keys()
            np.testing.assert_array_equal(got["image"], want["image"])
            assert got["image"].shape == (TINY_IMG, TINY_IMG, 3)
            assert {k: v for k, v in got.items() if k != "image"} == {
                k: v for k, v in want.items() if k != "image"}
        if port_cls is image_datasets.RetrievalDataset:
            assert port.i2t_gt == ref.i2t_gt == {0: [0, 1], 1: [2, 3], 2: [4, 5]}
    for name in ("coco_caption", "coco_retrieval", "flickr30k"):
        assert registry.get_builder_class(name).data_type == "images"


def test_image_processors_match_jax():
    from mr_blip_tpu.processors import image_processors as jax_proc
    from mr_blip_tpu_torch.processors import image_processors as port_proc

    img = np.random.default_rng(8).uniform(0, 255, (40, 56, 3)).astype(np.float32)
    for name in ("BlipImageEvalProcessor", "ClipImageEvalProcessor"):
        np.testing.assert_array_equal(getattr(port_proc, name)(image_size=32)(img),
                                      getattr(jax_proc, name)(image_size=32)(img))
    for name in ("BlipImageTrainProcessor", "ClipImageTrainProcessor"):
        got = getattr(port_proc, name)(image_size=32, seed=4)(img)
        want = getattr(jax_proc, name)(image_size=32, seed=4)(img)
        np.testing.assert_array_equal(got, want)


WORDPIECE_VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the a un ##aff ##able want ##ed runn "
                   "##ing dog cat ##s , . ! ? ' s 1 ##2 ##3 over jump ##ps quick brown "
                   "fox lazy do ##g e ##x ##am ##ple te ##st co ##co ##a").split()


def test_wordpiece_ids_match_jax(tmp_path, monkeypatch):
    from mr_blip_tpu.text.wordpiece import BertWordPieceTokenizer as JaxWordPiece
    from mr_blip_tpu_torch.text.wordpiece import BertWordPieceTokenizer

    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(WORDPIECE_VOCAB) + "\n")
    texts = ["The quick brown fox jumps over the lazy dog!", "unaffable wanted",
             "runnings cats, dogs?", "Téstcoca 123 éxample", "没有 the a"]
    port, ref = BertWordPieceTokenizer(str(path)), JaxWordPiece(str(path))
    for t in texts:
        assert port.tokenize(t) == ref.tokenize(t)
        assert port.encode(t, max_len=8) == ref.encode(t, max_len=8)
    ids, mask = port(texts, 12)
    want_ids, want_mask = ref(texts, 12)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    assert [port.decode(r) for r in ids] == [ref.decode(r) for r in want_ids]
    assert port.bos_token_id == ref.bos_token_id == len(WORDPIECE_VOCAB)
    monkeypatch.setenv("MRBLIP_BERT_VOCAB", str(path))
    tok = zoo_wrappers._zoo_tokenizer(120)
    assert isinstance(tok, BertWordPieceTokenizer) and not getattr(tok, "is_fallback", False)


def test_caption_metrics_match_jax():
    from mr_blip_tpu.metrics import caption_metrics as jax_metrics
    from mr_blip_tpu_torch.metrics import caption_metrics

    preds = ["a dog runs on grass", "two cats", "a man rides a horse in a field"]
    refs = [["a dog is running on the grass", "dog runs"], ["two cats sleep"],
            ["a man riding a horse", "a person on a horse in the field"]]
    for fn in ("corpus_bleu", "cider_d"):
        assert getattr(caption_metrics, fn)(preds, refs) == getattr(jax_metrics, fn)(
            preds, refs)
    sims = np.random.default_rng(2).standard_normal((3, 6))
    gt = {0: [0, 1], 1: [2, 3], 2: [4, 5]}
    assert caption_metrics.retrieval_metrics(sims, gt) == jax_metrics.retrieval_metrics(
        sims, gt)


def test_load_model_and_preprocess_blip_caption():
    from mr_blip_tpu_torch.models import load_model_and_preprocess
    from mr_blip_tpu_torch.processors.image_processors import (
        BlipImageEvalProcessor,
        BlipImageTrainProcessor,
    )

    model, vis, txt = load_model_and_preprocess("blip_caption", "tiny", device="cpu")
    assert isinstance(model, zoo_wrappers.BlipCaptionModel) and model.model_size == "tiny"
    assert isinstance(vis["train"], BlipImageTrainProcessor)
    assert isinstance(vis["eval"], BlipImageEvalProcessor)
    assert vis["train"].image_size == vis["eval"].image_size == TINY_IMG
    assert txt["train"]("A Dog.  Runs!") == "a dog runs"
    out = model.generate({"image": vis["eval"](np.full((40, 40, 3), 128.0, np.float32))[None]},
                         max_length=5)
    assert len(out["captions"]) == 1


# ----------------------------------------------------------- entry points
def _tiny_zoo_config(tmp_path, task):
    """A zoo project config at the tiny widths: the published
    caption_coco_eval / ret_coco_eval with ``model_size: tiny``."""
    ann = _annotations(tmp_path / "ann.json", n_images=4,
                       per_image=1 if task == "retrieval" else 2)
    arch, ds = (("blip_caption", "coco_caption") if task == "captioning"
                else ("blip_retrieval", "coco_retrieval"))
    extra = "  num_beams: 3\n  max_len: 10\n  min_len: 2\n" if task == "captioning" else (
        f"  k_test: {K_TEST}\n")
    path = tmp_path / f"tiny_{task}.yaml"
    path.write_text(
        f"model:\n  arch: {arch}\n  model_type: tiny\n  model_size: tiny\n"
        f"datasets:\n  {ds}:\n    text_processor:\n      eval:\n        name: blip_caption\n"
        f"    build_info:\n      annotations:\n"
        + "".join(f"        {s}:\n          storage: {ann}\n" for s in ("train", "val", "test"))
        + "      images:\n        storage: synthetic://\n"
        f"run:\n  task: {task}\n  batch_size_eval: 2\n  num_workers: 1\n"
        f"  output_dir: {tmp_path / 'out'}\n  evaluate: True\n  test_splits: ['test']\n"
        f"  device: tpu\n  distributed: False\n" + extra)
    return str(path)


@pytest.mark.parametrize("task", ["captioning", "retrieval"])
def test_evaluate_tiny_zoo_config_identical_to_jax(task, tmp_path, monkeypatch,
                                                   caption_pair, retrieval_pair):
    """The runners' evaluation of a tiny zoo config, JAX then port, on the
    same weights (the wrapper pairs above, whose compiled steps the JAX
    side reuses; each task's ``build_model`` is checked to build that
    wrapper): rows (captioning) and metrics identical."""
    from mr_blip_tpu import tasks as jax_tasks
    from mr_blip_tpu.common.config import Config as JaxConfig
    from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
    from mr_blip_tpu_torch import tasks
    from mr_blip_tpu_torch.common.config import Config
    from mr_blip_tpu_torch.runners.runner_base import RunnerBase

    for cls in (image_datasets.CaptionDataset, jax_images.CaptionDataset):
        monkeypatch.setattr(cls, "image_size", TINY_IMG)
    cfg_path = _tiny_zoo_config(tmp_path, task)
    out = {}
    jcfg = JaxConfig(cfg_path=cfg_path, options=[f"run.output_dir={tmp_path / 'jax'}"])
    jtask = jax_tasks.setup_task(jcfg)
    jmodel, port_model = caption_pair if task == "captioning" else retrieval_pair
    assert jax_registry.get_model_class(jcfg.model_cfg.arch) is type(jmodel)

    class OneDevice(JaxRunnerBase):
        mesh = None  # evaluate.py's single-device run

    out["jax"] = OneDevice(cfg=jcfg, job_id="job", task=jtask, model=jmodel,
                           datasets=jtask.build_datasets(jcfg)).evaluate(skip_reload=True)
    cfg = Config(cfg_path=cfg_path, options=[f"run.output_dir={tmp_path / 'port'}",
                                             "run.device=cpu"])
    ptask = tasks.setup_task(cfg)
    built = ptask.build_model(cfg)
    assert type(built) is type(port_model) and built.model_size == "tiny"
    assert built.device == port_model.device == torch.device("cpu")
    out["port"] = RunnerBase(cfg=cfg, job_id="job", task=ptask, model=port_model,
                             datasets=ptask.build_datasets(cfg)).evaluate(skip_reload=True)
    assert out["port"] == out["jax"]
    assert out["port"]["test"]["tokenizer_fallback"] is True
    if task == "captioning":
        rows = [json.loads((tmp_path / sub / "job" / "result" / "test_epochbest.json")
                           .read_text()) for sub in ("jax", "port")]
        assert rows[0] == rows[1] and len(rows[1]) == 4


def test_evaluate_main_on_a_tiny_zoo_config(tmp_path, monkeypatch):
    """``mr_blip_tpu_torch.evaluate.main`` as a user runs it, on the host."""
    from mr_blip_tpu_torch import evaluate

    monkeypatch.setattr(image_datasets.CaptionDataset, "image_size", TINY_IMG)
    logs = evaluate.main(["--cfg-path", _tiny_zoo_config(tmp_path, "retrieval"),
                          "--options", "run.device=cpu"])
    metrics = logs["test"]
    assert set(metrics) >= {"txt_r1", "img_r1", "r_mean", "agg_metrics"}
    assert all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))


def test_zoo_config_device_tpu_is_the_card(caplog):
    """The published zoo configs say ``run.device: tpu``: the port reads it
    as the card (one log line); an unknown device raises naming the key."""
    import logging

    from mr_blip_tpu_torch.common import dist as dist_utils
    from mr_blip_tpu_torch.common.config import Config

    cfg = Config(cfg_path="configs/projects/zoo/ret_coco_eval.yaml")
    assert cfg.run_cfg.device == "tpu"
    dist_utils._TPU_READ.clear()
    with caplog.at_level(logging.INFO):
        assert dist_utils.local_device(cfg.run_cfg.device) == torch.device("cuda")
        assert dist_utils.local_device("tpu") == torch.device("cuda")
    assert sum("'tpu' read as" in r.message for r in caplog.records) == 1
    assert dist_utils.local_device(Config(
        cfg_path="configs/projects/zoo/ret_coco_eval.yaml",
        options=["run.device=cpu"]).run_cfg.device) == torch.device("cpu")
    with pytest.raises(ValueError, match="run.device='xpu9'"):
        dist_utils.local_device("xpu9")
    if not torch.cuda.is_available():  # the card is the default: no CPU retreat
        from mr_blip_tpu_torch import tasks

        with pytest.raises((RuntimeError, AssertionError)):
            tasks.setup_task(cfg).build_model(cfg)
