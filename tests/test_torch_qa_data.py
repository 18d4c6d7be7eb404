"""The port's grounded-QA data and metrics against the JAX package's, on the
CPU.

The MC-VideoQA (NExT-QA / NExT-GQA) and MR-questions (qvhQ) datasets give
the JAX package's items (prompts byte for byte, timestamps, frames, windows,
``video_path``; the default window ``[[0, duration]]``; the random re-draw
over an undecodable video), their builders register under the JAX names
with the same default configs, the loader's collate gives the JAX
``DataLoader``'s batches at batch 2, the QA project configs read as the JAX
package reads them, the synthetic generators write the same annotations, and
``eval_ground`` / ``get_tIoU`` give the JAX package's numbers on random
records with degenerate spans. Arrays are compared bit for bit, dtypes
included; metrics exactly.
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest

import mr_blip_tpu  # noqa: F401
import mr_blip_tpu_torch  # noqa: F401
from mr_blip_tpu.common.config import Config as JaxConfig
from mr_blip_tpu.common.registry import registry as jax_registry
from mr_blip_tpu.datasets import loader as jloader
from mr_blip_tpu.datasets import mr_datasets as jds
from mr_blip_tpu.datasets import synthetic as jsynth
from mr_blip_tpu.metrics import grounded_qa as jgqa
from mr_blip_tpu.processors import text_processors as jtext
from mr_blip_tpu.processors import video_processors as jvideo
from mr_blip_tpu_torch.common.config import Config, load_yaml
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets import loader as tloader
from mr_blip_tpu_torch.datasets import mr_datasets as tds
from mr_blip_tpu_torch.datasets import synthetic as tsynth
from mr_blip_tpu_torch.metrics import eval_ground, get_tIoU
from mr_blip_tpu_torch.processors import text_processors as ttext
from mr_blip_tpu_torch.processors import video_processors as tvideo

REPO = Path(__file__).resolve().parent.parent
QA_BUILDERS = ("nextqa", "nextgqa", "star", "tvqa", "how2qa", "vlep", "qvh_sevilla")


def _assert_same(got, want):
    assert type(got) is type(want) or (
        isinstance(got, np.ndarray) and isinstance(want, np.ndarray))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


def _datasets(cls_name, ann_paths, vis_root="", n_frms=4, normalize=False):
    """The port's and the JAX package's dataset ``cls_name`` over the same
    annotations, each with its package's eval processors."""
    kw = dict(image_size=28, n_frms=n_frms, normalize=normalize)
    got = getattr(tds, cls_name)(
        vis_processor=tvideo.BlipVideoEvalProcessor(**kw),
        text_processor=ttext.BlipQuestionProcessor(), vis_root=vis_root,
        ann_paths=ann_paths)
    want = getattr(jds, cls_name)(
        vis_processor=jvideo.BlipVideoEvalProcessor(**kw),
        text_processor=jtext.BlipQuestionProcessor(), vis_root=vis_root,
        ann_paths=ann_paths)
    return got, want


def _qa_annotations(tmp_path, with_grounding=True):
    return tsynth.make_qa_annotations(
        str(tmp_path), n_train=2, n_val=2, n_test=3, n_video_frames=40, fps=5.0,
        height=48, width=64, with_grounding=with_grounding)


# ---------------------------------------------------------------- datasets
@pytest.mark.parametrize("with_grounding", [True, False])
@pytest.mark.parametrize("normalize", [False, True])
def test_mc_videoqa_items_equal_jax(tmp_path, with_grounding, normalize):
    paths = _qa_annotations(tmp_path, with_grounding)
    got, want = _datasets("MCVideoQADataset", [paths["train"], paths["test"]],
                          normalize=normalize)
    assert len(got) == len(want) == 5
    for i in range(len(got)):
        g, w = got[i], want[i]
        _assert_same(g, w)
        assert g["video"].dtype == (np.float32 if normalize else np.uint8)
        assert g["video_path"].startswith("synthetic://")
        assert g["qa_input"].startswith("Question: ") and g["qa_input"].endswith(
            "Considering the information presented in the frames, select the "
            "correct answer from the options.")
        assert g["query_prompt"].endswith(")\n") and g["qa_output"].startswith("Option ")
        if not with_grounding:  # the default window: the whole video
            _assert_same(g["relevant_windows"], np.asarray([[0.0, g["duration"]]]))


def test_mc_videoqa_clip_proposal_equals_jax(tmp_path):
    """An annotation with ``start``/``end`` samples its frames inside them."""
    paths = _qa_annotations(tmp_path)
    anns = json.loads(Path(paths["test"]).read_text())
    for a in anns:
        a["start"], a["end"] = 1.0, 5.5
    path = tmp_path / "clipped.json"
    path.write_text(json.dumps(anns))
    got, want = _datasets("MCVideoQADataset", [str(path)])
    for i in range(len(got)):
        _assert_same(got[i], want[i])
        assert got[i]["timestamps"].min() >= 1.0 and got[i]["timestamps"].max() <= 5.5


def test_mc_videoqa_redraws_an_undecodable_video_as_jax(tmp_path):
    """An item whose video cannot be decoded is replaced by a random other
    one (``random.randint``, up to 10 attempts), as in JAX; past 10 the error
    propagates."""
    paths = _qa_annotations(tmp_path)
    anns = json.loads(Path(paths["test"]).read_text())
    anns[0]["video"] = str(tmp_path / "missing_clip.mp4")
    path = tmp_path / "broken.json"
    path.write_text(json.dumps(anns))
    got, want = _datasets("MCVideoQADataset", [str(path)])
    random.seed(3)
    g = got[0]
    random.seed(3)
    w = want[0]
    _assert_same(g, w)
    assert g["question_id"] != anns[0]["qid"]
    for a in anns:
        a["video"] = str(tmp_path / "missing_clip.mp4")
    path.write_text(json.dumps(anns))
    got, _ = _datasets("MCVideoQADataset", [str(path)])
    with pytest.raises(Exception):
        got[1]


@pytest.mark.parametrize("with_options", [True, False])
def test_mr_questions_items_equal_jax(tmp_path, with_options):
    """qvhQ: the options folded into the query prompt when the annotation has
    them."""
    paths = tsynth.make_mr_annotations(str(tmp_path), n_train=0, n_val=0, n_test=3,
                                       n_video_frames=40, fps=5.0, height=48, width=64)
    anns = json.loads(Path(paths["test"]).read_text())
    if with_options:
        for a in anns:
            a["num_option"] = 3
            a.update({f"a{j}": f"choice {j}" for j in range(3)})
    path = tmp_path / "qvhq.json"
    path.write_text(json.dumps(anns))
    got, want = _datasets("MomentRetrievalQuestionsDataset", [str(path)])
    for i in range(len(got)):
        _assert_same(got[i], want[i])
    expect = ("Query: action number 0 happening (choice 0 choice 1 choice 2)\n"
              if with_options else "Query: action number 0 happening\n")
    assert got[0]["query_prompt"].replace("Options: ", "") == expect


def test_qa_prompts_are_the_jax_package_s():
    assert tds.ANS_MAPPING == jds.ANS_MAPPING
    assert tds.TASK_PROMPT == jds.TASK_PROMPT


# --------------------------------------------------------- builders, loader
@pytest.mark.parametrize("name", QA_BUILDERS + ("qvhQ",))
def test_qa_builders_register_under_the_jax_names(name):
    got, want = registry.get_builder_class(name), jax_registry.get_builder_class(name)
    assert got is not None and want is not None
    assert got.DATASET_CONFIG_DICT == want.DATASET_CONFIG_DICT
    assert got.train_dataset_cls.__name__ == want.train_dataset_cls.__name__
    assert got.eval_dataset_cls.__name__ == want.eval_dataset_cls.__name__
    default = got.default_config_path()
    assert Path(default).is_file()
    assert got().config == want().config  # the default YAML, read without pyyaml
    assert load_yaml(default)["datasets"]


def test_nextgqa_builder_and_collate_equal_jax_dataloader(tmp_path):
    """The nextgqa builder over the layered project config, then the loaders
    at batch 2 (string lists, the (B, n, 2) window arrays, ``video_path``)."""
    paths = _qa_annotations(tmp_path)
    options = [f"datasets.nextgqa.build_info.annotations.{s}.storage={paths[s]}"
               for s in ("train", "val", "test")]
    options += ["datasets.nextgqa.build_info.videos.storage=synthetic",
                "datasets.nextgqa.vis_processor.eval.image_size=28",
                "datasets.nextgqa.vis_processor.eval.n_frms=4"]
    cfg = Config(cfg_path=str(REPO / "configs/projects/eval/nextGQA.yaml"), options=options)
    jcfg = JaxConfig(cfg_path=str(REPO / "configs/projects/eval/nextGQA.yaml"),
                     options=options)
    got = registry.get_builder_class("nextgqa")(cfg.datasets_cfg.nextgqa).build_datasets()
    want = jax_registry.get_builder_class("nextgqa")(
        jcfg.datasets_cfg.nextgqa).build_datasets()
    assert set(got) == set(want) == {"train", "val", "test"}
    gbatches = list(tloader.DataLoader(got["test"], batch_size=2, num_workers=1))
    wbatches = list(jloader.DataLoader(want["test"], batch_size=2, num_workers=1))
    assert len(gbatches) == len(wbatches) == 2
    for g, w in zip(gbatches, wbatches):
        _assert_same(g, w)
    first = gbatches[0]
    assert first["video"].shape == (2, 4, 28, 28, 3) and first["video"].dtype == np.uint8
    assert first["relevant_windows"].shape == (2, 1, 2)
    assert isinstance(first["qa_input"], list) and isinstance(first["video_path"], list)
    assert first["duration"].dtype == np.float64
    # PrefetchLoader passes the batch through on the CPU.
    (p, *_), = [list(tloader.PrefetchLoader(
        tloader.DataLoader(got["test"], batch_size=2, num_workers=1), device="cpu"))]
    _assert_same(p, first)


@pytest.mark.parametrize("project", ["eval/nextGQA", "eval/nextQA", "train/nextGQA",
                                     "train/nextQA", "train/qvhQ"])
def test_qa_project_configs_equal_jax(project):
    path = str(REPO / f"configs/projects/{project}.yaml")
    got = Config(cfg_path=path).to_dict()
    want = JaxConfig(cfg_path=path).to_dict()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_qa_annotations_equal_jax(tmp_path):
    for grounding in (True, False):
        got = tsynth.make_qa_annotations(str(tmp_path / f"t{grounding}"), seed=4,
                                         with_grounding=grounding)
        want = jsynth.make_qa_annotations(str(tmp_path / f"j{grounding}"), seed=4,
                                          with_grounding=grounding)
        for split in ("train", "val", "test"):
            assert Path(got[split]).read_text() == Path(want[split]).read_text()


def test_benchmark_annotations_equal_jax(tmp_path):
    """The encoded-clip generators (skipped only where FFmpeg is absent)."""
    from tests.test_torch_video_reader import encoder_or_skip, native_readers

    native_readers()
    with encoder_or_skip("mpeg4"):
        clips = tsynth.make_benchmark_clips(str(tmp_path / "clips"), n_clips=2,
                                            seconds=3, fps=10.0, width=64, height=48,
                                            gop=8, codec="mpeg4")
    assert [Path(c).name for c in clips] == ["clip0_3s_64x48_g8.avi", "clip1_3s_64x48_g8.avi"]
    for make in ("make_benchmark_annotations", "make_benchmark_qa_annotations"):
        got = getattr(tsynth, make)(clips, str(tmp_path / f"t_{make}.json"), n_queries=5)
        want = getattr(jsynth, make)(clips, str(tmp_path / f"j_{make}.json"), n_queries=5)
        assert Path(got).read_text() == Path(want).read_text()
        assert json.loads(Path(got).read_text())[0]["duration"] == 3.0


# ------------------------------------------------------------------ metrics
@pytest.mark.parametrize("loc,span", [
    ([2.0, 6.0], [3.0, 3.0]),    # a point inside the window: IoP 1, IoU 0
    ([2.0, 6.0], [7.0, 7.0]),    # a point outside
    ([2.0, 6.0], [2.0, 6.0]),
    ([2.0, 6.0], [4.0, 9.0]),
    ([2.0, 6.0], [7.0, 9.0]),    # disjoint
    ([0.0, 0.0], [0.0, 5.0]),    # a degenerate window
])
def test_get_tiou_equals_jax(loc, span):
    assert get_tIoU(loc, span) == jgqa.get_tIoU(loc, span)


@pytest.mark.parametrize("seed", range(6))
def test_eval_ground_equals_jax_on_random_records(seed):
    rng = np.random.default_rng(seed)
    results = []
    for i in range(40):
        d = float(rng.uniform(10, 60))
        s = float(rng.uniform(0, d))
        e = s if i % 5 == 0 else float(rng.uniform(s, d))   # degenerate spans
        gt = [[float(a), float(a + rng.uniform(0, 10))]
              for a in rng.uniform(0, d, int(rng.integers(1, 4)))]
        if i % 7 == 0:
            s, e = gt[0][0] + 0.5, gt[0][0] + 0.5        # a point inside the GT
        results.append({"relevant_moments": [[s, e]], "relevant_moments_gt": gt,
                        "prediction": int(rng.integers(0, 5)),
                        "target": int(rng.integers(0, 5))})
    for pred_qa in (True, False):
        got = eval_ground(results, pred_qa=pred_qa)
        want = jgqa.eval_ground(results, pred_qa=pred_qa)
        assert got == want
        assert list(got) == ["Acc@GQA", "mIoP", "TIoP@0.3", "TIoP@0.5", "mIoU",
                             "TIoU@0.3", "TIoU@0.5"]
