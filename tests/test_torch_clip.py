"""The CLIP family in the port (``text/clip_bpe.py``, ``models/clip_resnet.py``,
``models/clip.py``, ``zoo_wrappers.ClipModel``, the retrieval task and the
evaluation entry point on a CLIP zoo config) against the JAX package, on the
CPU.

Tiny configs in fp32; every weight is drawn from a numpy seed into the JAX
tree (``jax.eval_shape`` of the flax init) and carried over by
``state_dict_from_jax``, which must consume every leaf and load
``strict=True``. Bars: modules, losses and similarity matrices 1e-4,
argsorts, BPE ids and task metrics identical. The BPE table is one the test
writes (no CLIP merge table in the repo).
"""

import dataclasses
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
from mr_blip_tpu.models import clip as jax_clip
from mr_blip_tpu.models import clip_resnet as jax_resnet
from mr_blip_tpu.models import zoo_wrappers as jax_zoo
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets import image_datasets
from mr_blip_tpu_torch.models import clip, clip_resnet, vit, zoo_wrappers
from mr_blip_tpu_torch.models.convert import state_dict_from_jax

TOL = 1e-4
TINY_IMG = 28
RESNET = dict(layers=(1, 1, 1, 1), output_dim=16, image_size=64, width=8)


def _random_tree(shapes, seed):
    """Parameters of ``shapes`` from a numpy seed: LayerNorm and BatchNorm
    scales and BatchNorm variances 1 + 0.1 noise, the rest 0.1 noise."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(shapes)
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] in ("scale", "var") else 0.1 * noise
    return traverse_util.unflatten_dict(flat)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _port_config(cfg):
    """The port's CLIPConfig of a JAX one."""
    d = dataclasses.asdict(cfg)
    res = d.pop("resnet")
    return clip.CLIPConfig(
        vision=vit.BaseViTConfig(**d.pop("vision")),
        resnet=clip_resnet.ResNetVisionConfig(**dict(res, layers=tuple(res["layers"])))
        if res else None, **d)


def _tiny(resnet=False, quick_gelu=False):
    cfg = dataclasses.replace(jax_clip.clip_tiny_config(), quick_gelu=quick_gelu)
    if resnet:
        cfg = dataclasses.replace(cfg, resnet=jax_resnet.ResNetVisionConfig(**RESNET))
    return cfg


def _inputs(cfg, n=3, seed=0):
    img = cfg.resnet.image_size if cfg.resnet is not None else cfg.vision.img_size
    rng = np.random.default_rng(seed)
    ims = rng.standard_normal((n, img, img, 3)).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size - 1, (n, cfg.context_length)).astype(np.int32)
    ids[0, 3] = cfg.vocab_size - 1  # an EOT mid-row: pooled there, ties after
    ids[1, 5:] = 0
    ids[1, 4] = cfg.vocab_size - 1
    return ims, ids


# -------------------------------------------------------------------- BPE
MERGES = ["#version: 0.2", "t h", "th e</w>", "a n", "an d</w>", "c a", "ca t</w>",
          "d o", "do g</w>", "i n", "in g</w>", "r u", "ru n", "run n", "o n</w>", "é t</w>"]
TEXTS = ["The cat and the dog", "  running ON &amp; on   the  dog's mat, 42!",
         "Été éte café ☃ x_y", "the " * 40]


@pytest.fixture
def merge_table(tmp_path):
    path = tmp_path / "merges.txt"
    path.write_text("\n".join(MERGES) + "\n")
    return str(path)


def test_bpe_ids_and_decode_match_jax(merge_table, monkeypatch):
    from mr_blip_tpu.text.clip_bpe import ClipBPETokenizer as JaxBPE
    from mr_blip_tpu_torch.text.clip_bpe import ClipBPETokenizer

    port, ref = ClipBPETokenizer(merge_table, context_length=16), JaxBPE(merge_table, 16)
    assert port.vocab_size == ref.vocab_size == 512 + len(MERGES) - 1 + 2
    assert (port.sot_token, port.eot_token) == (ref.sot_token, ref.eot_token)
    for t in TEXTS:
        assert port.encode(t) == ref.encode(t)
        assert port.decode(port.encode(t)) == ref.decode(ref.encode(t))
    np.testing.assert_array_equal(port(TEXTS), ref(TEXTS))
    assert port(TEXTS)[3, -1] == port.eot_token  # truncated, the EOT kept
    monkeypatch.setenv("MR_BLIP_CLIP_BPE", merge_table)
    assert ClipBPETokenizer().encode(TEXTS[0]) == ref.encode(TEXTS[0])


def test_bpe_without_a_table_raises(monkeypatch, tmp_path):
    from mr_blip_tpu_torch.text.clip_bpe import ClipBPETokenizer

    monkeypatch.delenv("MR_BLIP_CLIP_BPE", raising=False)
    for path in (None, str(tmp_path / "missing.txt")):
        with pytest.raises(FileNotFoundError, match="MR_BLIP_CLIP_BPE"):
            ClipBPETokenizer(path)


def test_wrapper_takes_the_bpe_table(merge_table):
    """With a table the vocabulary grows to its size and ``tokenize`` is the
    JAX wrapper's; without one the word fallback pads to context_length with
    the EOS at the highest id."""
    port = zoo_wrappers.ClipModel(model_size="tiny", bpe_path=merge_table, device="cpu")
    jm = _jax_wrapper(jax_zoo.ClipModel, 3, bpe_path=merge_table)
    assert port.config.vocab_size == jm.config.vocab_size == port.tokenizer.vocab_size > 100
    assert port.module.token_embedding.weight.shape[0] == port.config.vocab_size
    np.testing.assert_array_equal(port.tokenize(TEXTS).numpy(), np.asarray(jm.tokenize(TEXTS)))
    fallback = zoo_wrappers.ClipModel(model_size="tiny", device="cpu")
    ids = fallback.tokenize(["a dog runs"]).numpy()
    assert ids.shape == (1, 12) and ids[0, 4] == 99 and not ids[0, 5:].any()


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", sorted(jax_clip.CLIP_MODEL_ZOO) + sorted(jax_clip.CLIP_RESNET_ZOO))
def test_zoo_config_matches_jax(name):
    want = dataclasses.asdict(jax_clip.clip_config_from_name(name))
    assert dataclasses.asdict(clip.clip_config_from_name(name)) == want
    assert dataclasses.asdict(_port_config(jax_clip.clip_config_from_name(name))) == want


# ----------------------------------------------------------------- modules
@pytest.mark.parametrize("deterministic", [True, False])
def test_modified_resnet_matches_jax(deterministic):
    """Eval mode (running statistics) and the batch-statistics mode, whose
    running statistics stay as they were."""
    cfg = jax_resnet.ResNetVisionConfig(**RESNET)
    jm = jax_resnet.ModifiedResNet(cfg, compute_dtype=jnp.float32)
    ims = np.random.default_rng(3).standard_normal((3, 64, 64, 3)).astype(np.float32)
    params = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), ims)["params"], 4)
    port = clip_resnet.ModifiedResNet(clip_resnet.ResNetVisionConfig(**RESNET),
                                      dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port(torch.from_numpy(ims), deterministic=deterministic)
    _close(got, jm.apply({"params": params}, ims, deterministic=deterministic))
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())


def test_attention_pool_matches_jax():
    jm = jax_resnet.AttentionPool2d(64, 4, 12, spacial_dim=3, compute_dtype=jnp.float32)
    x = np.random.default_rng(5).standard_normal((2, 3, 3, 64)).astype(np.float32)
    params = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"], 6)
    port = clip_resnet.AttentionPool2d(3, 64, 4, 12, dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got, jm.apply({"params": params}, x))


@pytest.mark.parametrize("resnet", [False, True], ids=["vit", "resnet"])
@pytest.mark.parametrize("quick_gelu", [False, True])
def test_clip_matches_jax(resnet, quick_gelu):
    cfg = _tiny(resnet, quick_gelu)
    jm = jax_clip.CLIP(cfg, compute_dtype=jnp.float32)
    ims, ids = _inputs(cfg)
    params = _random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), ims, ids)["params"],
                          7)
    port = clip.CLIP(_port_config(cfg), dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    t_ims, t_ids = torch.from_numpy(ims), torch.from_numpy(ids)
    with torch.no_grad():
        _close(port.encode_image(t_ims), jm.apply({"params": params}, ims,
                                                  method="encode_image"))
        _close(port.encode_text(t_ids), jm.apply({"params": params}, ids,
                                                 method="encode_text"))
        got = port(t_ims, t_ids)
    want = jm.apply({"params": params}, ims, ids)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[0].dtype == torch.float32
    _close(clip.clip_contrastive_loss(got[0]), jax_clip.clip_contrastive_loss(want[0]))


def test_clip_random_weights_follow_the_jax_rules():
    """The wrappers' seeded weights: the logit scale is the constant
    log(1 / 0.07), the embeddings and the attention pool draw their own
    scales, BatchNorm is the identity."""
    cfg = _port_config(_tiny(resnet=True))
    module = clip.CLIP(cfg, dtype=torch.float32)
    zoo_wrappers.init_clip_weights_(module, seed=3)
    assert float(module.logit_scale.detach()) == pytest.approx(np.log(1 / 0.07))
    for name, std in (("token_embedding.weight", 0.02), ("positional_embedding", 0.01),
                      ("visual.attnpool.pos_embed", cfg.resnet.embed_dim ** -0.5)):
        got = float(module.get_parameter(name).detach().std())
        assert got == pytest.approx(std, rel=0.15), name
    bn = module.visual.bn1
    assert bn.weight.eq(1).all() and bn.bias.eq(0).all()
    assert bn.mean.eq(0).all() and bn.var.eq(1).all()


def test_load_model_on_a_module_registration_raises_as_jax():
    """``clip_feature_extractor`` (and ``blip_v1``, the ALBEF modules) name
    modules, not wrappers: ``load_model`` raises AttributeError in both
    packages (no default config)."""
    from mr_blip_tpu.models import load_model as jax_load_model
    from mr_blip_tpu_torch.models import load_model

    for name in ("clip_feature_extractor", "blip_v1", "albef_feature_extractor",
                 "albef_nlvr", "albef_vqa"):
        assert registry.get_model_class(name).__name__ == \
            jax_registry.get_model_class(name).__name__
        with pytest.raises(AttributeError, match="default_config_path"):
            jax_load_model(name)
        with pytest.raises(AttributeError, match="default_config_path"):
            load_model(name, device="cpu")


def test_load_model_and_preprocess_takes_the_resnet_image_size(monkeypatch):
    """A ResNet tower's processors at its own image size (a narrow RN
    geometry of 64 pixels added to the zoo for the test)."""
    from mr_blip_tpu_torch.models import load_model_and_preprocess

    monkeypatch.setitem(clip.CLIP_RESNET_ZOO, "RN-tiny", (16, 64, 8, (1, 1, 1, 1), 32, 2, 2,
                                                          False))
    model, vis, _ = load_model_and_preprocess("clip", device="cpu", model_size="RN-tiny")
    assert model.config.resnet.image_size == model.img_size == 64
    assert vis["eval"].image_size == vis["train"].image_size == 64
    model, vis, _ = load_model_and_preprocess("clip", "tiny", device="cpu")
    assert vis["eval"].image_size == TINY_IMG


# ---------------------------------------------------------------- wrapper
def _jax_wrapper(cls, seed, **kwargs):
    """The JAX wrapper with its parameters drawn from ``seed`` into the
    shapes of ``jax.eval_shape`` of its flax init (the slow part)."""
    def shapes_only(self, *args, **kw):
        shapes = jax.eval_shape(lambda: flax_init(self, *args, **kw))
        return {"params": _random_tree(shapes["params"], seed)}

    flax_init = jax_clip.CLIP.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_clip.CLIP, "init", shapes_only)
        jm = cls(model_size="tiny", **kwargs)
    jm.params = jax.tree.map(jnp.asarray, jm.params)
    return jm


@pytest.fixture(scope="module")
def clip_pair():
    jm = _jax_wrapper(jax_zoo.ClipModel, 21)
    port = zoo_wrappers.ClipModel(model_size="tiny", device="cpu")
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jm.params)))
    return jm, port


class _ListLoader:
    def __init__(self, batches, dataset=None):
        self.batches, self.dataset = batches, dataset

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _batches(n_batches=3, b=4, captions_per_image=2, seed=0):
    """Caption batches whose images repeat within and across batches (one
    image id per ``captions_per_image`` rows)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n_batches * b, TINY_IMG, TINY_IMG, 3)).astype(np.float32)
    out = []
    for lo in range(0, n_batches * b, b):
        rows = range(lo, lo + b)
        out.append({"image": np.stack([images[r // captions_per_image] for r in rows]),
                    "text_input": [f"a photo of thing {r} number {r % 3}" for r in rows],
                    "image_id": [f"img{r // captions_per_image}" for r in rows]})
    return out


def test_forward_and_sim_matrix_match_jax(clip_pair):
    jm, port = clip_pair
    batches = _batches()
    _close(port(batches[0])["loss"], jm(batches[0])["loss"])
    got, want = port.compute_sim_matrix(batches), jm.compute_sim_matrix(batches)
    assert got.shape == want.shape == (6, 12)
    _close(got, want)
    np.testing.assert_array_equal(np.argsort(-got, axis=1), np.argsort(-want, axis=1))
    np.testing.assert_array_equal(np.argsort(-got, axis=0), np.argsort(-want, axis=0))


def test_retrieval_task_metrics_identical_to_jax(clip_pair, tmp_path):
    jm, port = clip_pair
    batches = _batches(captions_per_image=1)
    logs = []
    for reg, model in ((jax_registry, jm), (registry, port)):
        task = reg.get_task_class("retrieval")(k_test=4)
        logs.append(task.after_evaluation(task.evaluation(model, _ListLoader(batches)),
                                          "val", 0))
    assert logs[0] == logs[1]
    assert logs[1]["tokenizer_fallback"] is True


# ----------------------------------------------------------- entry points
def _tiny_clip_config(tmp_path):
    """clip_ret_coco_eval.yaml at the tiny widths, over synthetic images."""
    anns = [{"image": f"1x48x64#{i}", "caption": f"A Photo; of thing {i}!",
             "image_id": f"img{i}"} for i in range(5)]
    (tmp_path / "ann.json").write_text(json.dumps(anns))
    path = tmp_path / "tiny_clip.yaml"
    path.write_text(
        "model:\n  arch: clip\n  model_type: ViT-B-16\n  model_size: tiny\n"
        "datasets:\n  coco_retrieval:\n    text_processor:\n      eval:\n"
        "        name: blip_caption\n    build_info:\n      annotations:\n"
        + "".join(f"        {s}:\n          storage: {tmp_path / 'ann.json'}\n"
                  for s in ("train", "val", "test"))
        + "      images:\n        storage: synthetic://\n"
        f"run:\n  task: retrieval\n  batch_size_eval: 2\n  num_workers: 1\n"
        f"  output_dir: {tmp_path / 'out'}\n  evaluate: True\n  test_splits: ['test']\n"
        "  device: tpu\n  distributed: False\n  k_test: 4\n")
    return str(path)


def test_evaluate_tiny_clip_config_identical_to_jax(tmp_path, monkeypatch, clip_pair):
    """The runners' evaluation of a tiny CLIP zoo config, JAX then port, on
    the same weights (the wrapper pair; each task's ``build_model`` is
    checked to build that wrapper): metrics identical; then
    ``mr_blip_tpu_torch.evaluate.main`` as a user runs it on the host."""
    from mr_blip_tpu import tasks as jax_tasks
    from mr_blip_tpu.common.config import Config as JaxConfig
    from mr_blip_tpu.runners.runner_base import RunnerBase as JaxRunnerBase
    from mr_blip_tpu_torch import evaluate, tasks
    from mr_blip_tpu_torch.common.config import Config
    from mr_blip_tpu_torch.runners.runner_base import RunnerBase

    for cls in (image_datasets.CaptionDataset, jax_images.CaptionDataset):
        monkeypatch.setattr(cls, "image_size", TINY_IMG)
    cfg_path = _tiny_clip_config(tmp_path)
    jcfg = JaxConfig(cfg_path=cfg_path, options=[f"run.output_dir={tmp_path / 'jax'}"])
    jtask = jax_tasks.setup_task(jcfg)
    jmodel, port_model = clip_pair
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
    assert built.device == torch.device("cpu")
    got = RunnerBase(cfg=cfg, job_id="job", task=ptask, model=port_model,
                     datasets=ptask.build_datasets(cfg)).evaluate(skip_reload=True)
    assert got == want and got["test"]["tokenizer_fallback"] is True
    logs = evaluate.main(["--cfg-path", cfg_path, "--options", "run.device=cpu"])
    assert set(logs["test"]) >= {"txt_r1", "img_r1", "r_mean", "agg_metrics"}
    assert all(np.isfinite(v) for v in logs["test"].values() if isinstance(v, float))


@pytest.mark.parametrize("name", ["clip_ret_coco_eval", "clip_ret_flickr_eval"])
def test_published_clip_configs_build_the_tiny_model(name):
    """The published configs set ``model_type: ViT-B-16``, which neither
    package's wrapper reads (it reads ``model_size``): both build the tiny
    model, 28 pixels (ROADMAP Queue 3); ``model.model_size=ViT-B-16`` gives
    base width."""
    from mr_blip_tpu_torch import tasks
    from mr_blip_tpu_torch.common.config import Config

    path = f"configs/projects/zoo/{name}.yaml"
    cfg = Config(cfg_path=path, options=["run.device=cpu"])
    task = tasks.setup_task(cfg)
    model = task.build_model(cfg)
    assert model.model_size == "tiny" and cfg.model_cfg.model_type == "ViT-B-16"
    cfg = Config(cfg_path=path, options=["run.device=cpu", "model.model_size=ViT-B-16"])
    built = []
    with pytest.MonkeyPatch.context() as mp:  # ViT-B/16's build is phase 28's on the card
        mp.setattr(zoo_wrappers.ClipModel, "__init__", lambda self, **kw: built.append(kw))
        task.build_model(cfg)
    assert built[0]["model_size"] == "ViT-B-16"
    vision = clip.clip_config_from_name("ViT-B-16").vision
    assert vision.img_size == 224 and vision.patch_size == 16
