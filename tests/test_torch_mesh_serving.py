"""Model replicas in one process (``BLIP2_MR.set_mesh``, the dp server), on
the CPU.

The counterpart of the dp cases of ``tests/test_mesh_generate.py`` and of
``tests/test_serving.py::TestServerMesh``: ``set_mesh(["cpu", "cpu"])``
keeps a second copy of the weights, ``generate`` splits the prepared rows
into contiguous blocks, one a replica (an empty block skipped), and the
rows come back identical to one device's, for 8 rows, 5 rows and 1 row;
the server over such a model serves 8 requests and then a ragged 3
(bucket-padded to 4) row-identical; ``set_mesh`` with tp > 1 raises and
names the launcher; ``python -m mr_blip_tpu_torch.serve --devices cpu,cpu``
serves a request and exits 0 on SIGTERM. The tiny model in fp32, random
weights from its seed.
"""

import json
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from mr_blip_tpu_torch.datasets.mr_datasets import TASK_PROMPT
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.blip2_mr_opt import BLIP2_MR_OPT
from mr_blip_tpu_torch.serving import MomentRetrievalServer, MRRequest

REPO = Path(__file__).resolve().parent.parent
TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", task="lora", num_beams=2,
            max_new_tokens=8, compute_dtype="float32")
CLIP = "synthetic://20x48x48@10#3"


def _samples(b, t=2, img=28, seed=0):
    """``tests/test_mesh_generate.py``'s rows."""
    rng = np.random.default_rng(seed)
    durations = np.full((b,), 30.0)
    return {
        "video": rng.integers(0, 256, (b, t, img, img, 3), dtype=np.uint8),
        "timestamps": np.stack([np.linspace(0.0, d, t, endpoint=False) for d in durations]),
        "duration": durations,
        "query_id": [f"q{i}" for i in range(b)],
        "video_prompt_end": ["<extra_id_0>"] * b,
        "query_prompt": [f"Query: action {i}\n" for i in range(b)],
        "task_prompt": [TASK_PROMPT] * b,
    }


@pytest.fixture(scope="module")
def models():
    """(one-device model, the same weights over two replicas)."""
    base = BLIP2_MR(**TINY, device="cpu")
    mesh = BLIP2_MR(**TINY, device="cpu")
    return base, mesh.set_mesh(["cpu", "cpu"])


@pytest.fixture
def blocks(monkeypatch):
    """The (replica module, rows) of every block the replicas run."""
    seen, real = [], BLIP2_MR._generate_prepared

    def tapped(self, batch):
        seen.append((id(self.module), len(batch["end_ids"])))
        return real(self, batch)

    monkeypatch.setattr(BLIP2_MR, "_generate_prepared", tapped)
    return seen


@pytest.mark.parametrize("b, seed, rows", [(8, 0, [4, 4]), (5, 3, [3, 2]), (1, 4, [1])])
def test_mesh_generate_identical_to_one_device(models, blocks, b, seed, rows):
    """8 rows as 4 + 4, 5 rows as 3 + 2 (the JAX package pads them to the
    mesh; the port runs the blocks as they are), 1 row on the first replica
    alone: predictions, raw predictions and ids identical to one device's."""
    base, mesh = models
    samples = _samples(b, seed=seed)
    want = base.generate(samples)
    blocks.clear()
    got = mesh.generate(samples)
    assert [n for _, n in blocks] == rows
    assert len({m for m, _ in blocks}) == len(rows)  # each block on its replica
    for key in ("raw_prediction", "prediction", "qid", "duration"):
        assert got[key] == want[key], key


def test_replicas_hold_their_own_copy(models):
    """The second replica's tensors are equal to the first's and share no
    storage with them; the wrapper keeps the first replica's device."""
    _, mesh = models
    first, second = (r.module for r in mesh._replicas)
    assert first is mesh.module and second is not first
    a, b = first.state_dict(), second.state_dict()
    assert a.keys() == b.keys()
    for name, t in a.items():
        assert torch.equal(t, b[name]) and t.data_ptr() != b[name].data_ptr(), name
    assert mesh.replica_devices == [torch.device("cpu")] * 2
    assert mesh.device == torch.device("cpu")


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu", "cpu:0"]])
def test_server_over_the_mesh_serves_rows_identical(models, blocks, devices):
    """``TestServerMesh``: 8 requests in full batches, then a ragged 3
    bucket-padded to 4 and split 2 + 2 over the replicas; every row equal
    to the one-device model's on the same rows. With two device names the
    server stages nothing and each replica copies its own rows (the path of
    replicas on several cards)."""
    base = models[0]
    mesh = BLIP2_MR(**TINY, device="cpu").set_mesh(devices)
    reqs = [MRRequest(query=f"action {i}", duration=30.0,
                      video=_samples(1, seed=40 + i)["video"][0], qid=f"q{i}")
            for i in range(8)]
    want = base.generate({
        "video": np.stack([r.video for r in reqs]),
        "timestamps": np.stack([np.linspace(0.0, 30.0, 2, endpoint=False)] * 8),
        "duration": np.full((8,), 30.0), "query_id": [r.qid for r in reqs],
        "video_prompt_end": ["<extra_id_0>"] * 8,
        "query_prompt": ["Query: " + r.query + "\n" for r in reqs],
        "task_prompt": [TASK_PROMPT] * 8})
    blocks.clear()
    with MomentRetrievalServer(mesh, max_batch=4, max_wait_ms=5) as server:
        assert server.device == torch.device("cpu")
        assert server._spread == (devices[1] != "cpu")
        got = [f.result(timeout=240) for f in [server.submit(r) for r in reqs]]
        got2 = [f.result(timeout=240) for f in [server.submit(r) for r in reqs[:3]]]
        stats = server.stats()
    for i, g in enumerate(got + got2):
        assert g["raw_prediction"] == want["raw_prediction"][i % 8], i
        assert g["prediction"] == want["prediction"][i % 8], i
    assert stats.completed == 11 and stats.failed == 0
    assert [n for _, n in blocks][-2:] == [2, 2]


def test_set_mesh_with_tp_raises_naming_the_launcher():
    """The port's tensor parallelism is a group of processes."""
    model = BLIP2_MR(**TINY, device="cpu")
    with pytest.raises(ValueError, match=r"torch.distributed.run.*run.tp=2"):
        model.set_mesh(["cpu", "cpu"], tp=2)
    assert model.replica_devices == [torch.device("cpu")]


def test_opt_variant_over_the_mesh_generates_identical():
    """The OPT variant's ``generate`` through the same split (its prompt
    right-aligned before the split)."""
    cfg = dict(opt_model="tiny", img_size=28, vit_model="tiny", task="lora",
               num_beams=2, max_new_tokens=6, compute_dtype="float32")
    base = BLIP2_MR_OPT(**cfg, device="cpu")
    mesh = BLIP2_MR_OPT(**cfg, device="cpu").set_mesh(["cpu", "cpu"])
    samples = _samples(3, seed=9)
    assert mesh.generate(samples)["raw_prediction"] == base.generate(samples)["raw_prediction"]


def test_serve_module_with_devices_serves_and_exits_0():
    """``python -m mr_blip_tpu_torch.serve --devices cpu,cpu``: two replicas,
    one request served, SIGTERM drains and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mr_blip_tpu_torch.serve", "--model-type", "tiny",
         "--devices", "cpu,cpu", "--port", "0", "--host", "127.0.0.1", "--n-frms", "2",
         "--max-wait-ms", "5"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        while not lines or not lines[-1].startswith("serving on"):
            line = proc.stdout.readline()
            assert line, f"server exited early: {proc.stderr.read()}"
            lines.append(line.strip())
        assert "replicas on cpu, cpu" in lines
        port = int(lines[-1].rsplit(":", 1)[1])
        payload = {"query": "a person", "duration": 2.0, "video_path": CLIP, "qid": "m1"}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/moment_retrieval",
                                     data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and json.loads(r.read())["qid"] == "m1"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1])["completed"] == 1
