"""The port's data path (``mr_blip_tpu_torch/datasets/``, ``processors/``)
against the JAX package's, on the CPU.

Synthetic video, frame sampling, processors, the moment-retrieval dataset
built by its builder from the layered config, the loaders' order and
sharding: all must equal the JAX package's exactly (arrays bit for bit,
dtypes included). ``PrefetchLoader`` passes batches through unchanged on the
CPU.
"""

import random
from pathlib import Path

import numpy as np
import pytest

import mr_blip_tpu  # noqa: F401
import mr_blip_tpu_torch  # noqa: F401
from mr_blip_tpu.common.config import Config as JaxConfig
from mr_blip_tpu.common.registry import registry as jax_registry
from mr_blip_tpu.datasets import loader as jloader
from mr_blip_tpu.datasets import sampling as jsampling
from mr_blip_tpu.datasets.synthetic import make_mr_annotations as jax_make_mr_annotations
from mr_blip_tpu.datasets.video_reader import SyntheticVideo as JaxSyntheticVideo
from mr_blip_tpu.processors import text_processors as jtext
from mr_blip_tpu.processors import video_processors as jvideo
from mr_blip_tpu_torch.common.config import Config
from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.datasets import loader as tloader
from mr_blip_tpu_torch.datasets import sampling as tsampling
from mr_blip_tpu_torch.datasets.mr_datasets import TASK_PROMPT, MomentRetrievalDataset
from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
from mr_blip_tpu_torch.datasets.video_reader import SyntheticVideo, VideoReader
from mr_blip_tpu_torch.processors import text_processors as ttext
from mr_blip_tpu_torch.processors import video_processors as tvideo

REPO = Path(__file__).resolve().parent.parent


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


# ------------------------------------------------------- video and sampling
def test_synthetic_video_equals_jax():
    got = VideoReader("synthetic://40x48x64@5.0#3", width=28, height=28)
    want = JaxSyntheticVideo(40, 48, 64, fps=5.0, seed=3, out_w=28, out_h=28)
    assert len(got) == len(want) and got.get_avg_fps() == want.get_avg_fps()
    _assert_same(got.get_batch([0, 7, 39]), want.get_batch([0, 7, 39]))
    _assert_same(SyntheticVideo(40, 48, 64, fps=5.0, seed=3).get_window(1.0, 2.5),
                 JaxSyntheticVideo(40, 48, 64, fps=5.0, seed=3).get_window(1.0, 2.5))


def test_file_videos_raise_not_implemented(tmp_path):
    """Once refused (the reader served synthetic:// only), a file URI now goes
    to the FFmpeg reader: a missing file raises ``IOError``, or where FFmpeg is
    absent ``FFmpegUnavailable``; never ``NotImplementedError``
    (tests/test_torch_video_reader.py holds the reader)."""
    from mr_blip_tpu_torch.native.build import FFmpegUnavailable

    with pytest.raises((IOError, FFmpegUnavailable)):
        VideoReader(str(tmp_path / "clip.mp4"))


@pytest.mark.parametrize("sampling", ["uniform", "random", "headtail"])
@pytest.mark.parametrize("vlen,n_frms,clip", [(150, 60, None), (40, 8, (1.0, 3.5)),
                                              (5, 8, None)])
def test_frame_sampling_equals_jax(sampling, vlen, n_frms, clip):
    if sampling == "headtail" and (clip is not None or vlen < 2 * n_frms):
        return
    got = tsampling.sample_frame_indices(vlen, 10.0, n_frms, sampling, clip,
                                         rng=random.Random(5))
    want = jsampling.sample_frame_indices(vlen, 10.0, n_frms, sampling, clip,
                                          rng=random.Random(5))
    assert got == want


# ----------------------------------------------------------------- processors
@pytest.mark.parametrize("normalize", [False, True])
def test_video_processors_equal_jax(normalize):
    uri = "synthetic://32x48x48@10.0#3"
    for name in ("blip_video_eval", "blip2_video_train"):
        cfg = {"name": name, "image_size": 28, "n_frms": 4, "normalize": normalize}
        got_proc = registry.get_processor_class(name).from_config(cfg)
        want_proc = jax_registry.get_processor_class(name).from_config(cfg)
        random.seed(7)
        got = got_proc(uri, clip_proposal=[0.5, 2.5])
        random.seed(7)
        want = want_proc(uri, clip_proposal=[0.5, 2.5])
        _assert_same(got, want)
        assert got[0].dtype == (np.float32 if normalize else np.uint8)


def test_eval_processor_uint8_passthrough_matches_normalized():
    raw = tvideo.BlipVideoEvalProcessor(image_size=28, n_frms=4, normalize=False)
    norm = tvideo.BlipVideoEvalProcessor(image_size=28, n_frms=4, normalize=True)
    uri = "synthetic://32x48x48@10.0#3"
    f_raw, idx_raw, fps_raw = raw(uri)
    f_norm, idx_norm, fps_norm = norm(uri)
    assert f_raw.dtype == np.uint8 and f_norm.dtype == np.float32
    assert list(idx_raw) == list(idx_norm) and fps_raw == fps_norm
    np.testing.assert_allclose(tvideo.normalize_clip(f_raw), f_norm, rtol=1e-6, atol=1e-6)
    assert tvideo.MAX_INT == jvideo.MAX_INT


def test_text_processors_equal_jax():
    texts = ["A Man (slowly) walks; to the DOOR!", "  what * happens # next?  ",
             " ".join(f"w{i}" for i in range(60))]
    for t in texts:
        assert ttext.BlipQuestionProcessor(max_words=50)(t) == jtext.BlipQuestionProcessor(
            max_words=50)(t)


# ------------------------------------------------------------ the MR dataset
def _split_configs(tmp_path):
    paths = make_mr_annotations(str(tmp_path), n_train=4, n_val=2, n_test=3,
                                n_video_frames=30, fps=5.0, height=48, width=64)
    assert (tmp_path / "test.json").read_text() == _jax_annotations(tmp_path)
    options = [f"datasets.qvh.build_info.annotations.{s}.storage={p}"
               for s, p in paths.items()]
    path = str(REPO / "configs/projects/train/tiny_synthetic.yaml")
    return Config(cfg_path=path, options=options), JaxConfig(cfg_path=path, options=options)


def _jax_annotations(tmp_path):
    out = tmp_path / "jax"
    jax_make_mr_annotations(str(out), n_train=4, n_val=2, n_test=3,
                            n_video_frames=30, fps=5.0, height=48, width=64)
    return (out / "test.json").read_text()


def test_mr_dataset_items_equal_jax(tmp_path):
    cfg, jcfg = _split_configs(tmp_path)
    got = registry.get_builder_class("qvh")(cfg.datasets_cfg.qvh).build_datasets()
    want = jax_registry.get_builder_class("qvh")(jcfg.datasets_cfg.qvh).build_datasets()
    assert set(got) == set(want) == {"train", "val", "test"}
    for split in got:
        assert isinstance(got[split], MomentRetrievalDataset)
        assert len(got[split]) == len(want[split])
        items = []
        for i in range(len(got[split])):
            random.seed(i)  # the train processor samples and crops at random
            g = got[split][i]
            random.seed(i)
            w = want[split][i]
            _assert_same(g, w)
            assert g["video"].dtype == np.uint8 and g["video"].shape == (4, 28, 28, 3)
            assert g["task_prompt"] == TASK_PROMPT
            items.append((g, w))
        _assert_same(got[split].collater([g for g, _ in items[:2]]),
                     want[split].collater([w for _, w in items[:2]]))


def test_mr_dataset_preserves_uint8(tmp_path):
    import json

    ann = [{"qid": 0, "video": "synthetic://32x48x48@10.0", "duration": 3.2,
            "query": "a thing happens", "relevant_windows": [[0.5, 1.5]]}]
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps(ann))
    ds = MomentRetrievalDataset(
        vis_processor=tvideo.BlipVideoEvalProcessor(image_size=28, n_frms=4,
                                                    normalize=False),
        text_processor=ttext.BlipQuestionProcessor(),
        vis_root=str(tmp_path), ann_paths=[str(ann_path)])
    assert ds[0]["video"].dtype == np.uint8
    ds.vis_processor = tvideo.BlipVideoEvalProcessor(image_size=28, n_frms=4,
                                                     normalize=True)
    assert ds[0]["video"].dtype == np.float32


# ----------------------------------------------------------------- loaders
class _Ints:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": i, "x": np.full((2,), i, np.int64), "s": f"s{i}"}


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True), (True, False)])
def test_dataloader_order_and_sharding_equal_jax(world, shuffle, drop_last):
    """Each rank's batches equal the JAX loader's for that rank; in training
    (``drop_last``) over several ranks, where every rank takes only whole
    global batches, the union of the ranks' i-th batches is the i-th batch
    of the JAX loader over one process with the global batch size."""
    ds = _Ints(11)
    seen, global_steps = [], []
    for rank in range(world):
        kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, num_workers=2,
                  rank=rank, world_size=world, seed=5)
        got = tloader.DataLoader(ds, **kw)
        if drop_last and world > 1:
            kw.update(batch_size=3 * world, rank=0, world_size=1)
        want = jloader.DataLoader(ds, **kw)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert len(got) == len(want)
            got_batches, want_batches = list(got), list(want)
            if drop_last and world > 1:
                global_steps.append((epoch, got_batches, want_batches))
            else:
                _assert_same(got_batches, want_batches)
            if epoch == 0:
                seen += [i for b in got_batches for i in b["i"].tolist()]
    for epoch in (0, 1):
        steps = [(g, w) for e, g, w in global_steps if e == epoch]
        for i in range(len(steps[0][1]) if steps else 0):
            union = sorted(x for g, _ in steps for x in g[i]["i"].tolist())
            assert union == sorted(steps[0][1][i]["i"].tolist())
        if not shuffle:
            assert [i for b in got_batches for i in b["i"].tolist()] == list(
                range(rank, 11, world))
    if not drop_last:
        assert sorted(seen) == list(range(11))  # the shards cover the dataset once


def test_prefetch_loader_passes_batches_through_on_cpu():
    loader = tloader.DataLoader(_Ints(7), batch_size=2, num_workers=1)
    batches = list(loader)
    prefetch = tloader.PrefetchLoader(loader, device="cpu")
    assert len(prefetch) == len(loader)
    got = list(prefetch)
    _assert_same(got, batches)
    assert all(isinstance(b["x"], np.ndarray) for b in got)


def test_iter_and_multi_iter_loaders_equal_jax():
    def pair(mod):
        a = mod.IterLoader(mod.DataLoader(_Ints(5), batch_size=2, shuffle=True,
                                          drop_last=True, num_workers=1))
        b = mod.IterLoader(mod.DataLoader(_Ints(3), batch_size=1, num_workers=1))
        return a, mod.MultiIterLoader([a, b], ratios=[2.0, 1.0], seed=3)

    (ta, tm), (ja, jm) = pair(tloader), pair(jloader)
    for _ in range(9):
        _assert_same(next(tm), next(jm))
    assert ta.epoch == ja.epoch and ta.epoch > 0
