"""The port's online serving against the JAX package's, on the CPU.

``mr_blip_tpu_torch.serving.MomentRetrievalServer`` over the tiny model on
weights converted from the JAX model's (fp32, the kernels' plain versions):
its rows equal the JAX package's ``generate`` on the same padded rows, its
batch counts and occupancy the JAX server's; the behaviour tests of
``tests/test_serving.py`` (deadline, decode offload, close races, rejection,
staging accounting, warmup, latency quantiles) and its HTTP tests, on the
port; ``python -m mr_blip_tpu_torch.serve`` in a subprocess, stopped by
SIGTERM; ``models.load_model``. Every future is awaited with a timeout, so
a lost one fails its test.
"""

import json
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import mr_blip_tpu  # noqa: F401
from mr_blip_tpu.common.registry import registry as jax_registry
from mr_blip_tpu.models.blip2_mr import BLIP2_MR as JaxBLIP2_MR
from mr_blip_tpu.models.scan_utils import stack_blip2_mr_params
from mr_blip_tpu.serving import MomentRetrievalServer as JaxServer
from mr_blip_tpu.serving import MRRequest as JaxRequest
from mr_blip_tpu_torch.common.config import load_yaml
from mr_blip_tpu_torch.datasets.mr_datasets import TASK_PROMPT, _as_model_frames
from mr_blip_tpu_torch.models import (
    UNPORTED_FAMILIES,
    ZOO_FAMILIES,
    load_model,
    load_model_and_preprocess,
    model_zoo,
)
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.processors.video_processors import BlipVideoEvalProcessor
from mr_blip_tpu_torch.serve import make_httpd, parse_args
from mr_blip_tpu_torch.serving import MomentRetrievalServer, MRRequest

REPO = Path(__file__).resolve().parent.parent
TINY = dict(img_size=28, vit_model="tiny", t5_model="tiny", task="lora", num_beams=2,
            max_new_tokens=8, compute_dtype="float32")
CLIP = "synthetic://20x48x48@10#3"  # 20 frames at 10 fps: a 2 s video
LONG_WAIT_MS = 600_000  # only a full batch or the drain on close launches


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port tiny model on the same weights: every leaf of
    ``init_params_fast``'s tree redrawn from a numpy seed (the flax init
    takes ~30 s), so the LoRA deltas count."""
    jm = JaxBLIP2_MR(**TINY, init_params=False)
    tree = jax.tree.map(np.asarray, jm.init_params_fast(jax.random.PRNGKey(0),
                                                        dtype=jnp.float32))
    from mr_blip_tpu.models.scan_utils import unstack_blip2_mr_params

    rng = np.random.default_rng(21)
    flat = traverse_util.flatten_dict(unstack_blip2_mr_params(tree))
    for key, leaf in flat.items():
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        flat[key] = 1.0 + 0.1 * noise if key[-1] == "scale" else 0.3 * noise
    params = traverse_util.unflatten_dict(flat)
    jm.params = jax.tree.map(jnp.asarray, stack_blip2_mr_params(params))
    port = BLIP2_MR(**TINY, device="cpu", init_params=False)
    port.load_state_dict(state_dict_from_jax(params))
    return jm, port


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _frames(t=2, img=28, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (t, img, img, 3), dtype=np.uint8)


def _request(i, duration=30.0, cls=MRRequest, t=2):
    return cls(query=f"action {i}", duration=duration, video=_frames(t=t, seed=i),
               qid=f"q{i}")


def _samples(reqs):
    """The rows a server dispatches for ``reqs`` (uniform timestamps, as it
    fills them in when a request has none)."""
    return {
        "video": np.stack([np.asarray(r.video) for r in reqs]),
        "timestamps": np.stack([
            np.asarray(r.timestamps, np.float64) if r.timestamps is not None
            else np.linspace(0.0, r.duration, r.video.shape[0], endpoint=False)
            for r in reqs]),
        "duration": np.asarray([r.duration for r in reqs]),
        "query_id": [r.qid for r in reqs],
        "video_prompt_end": ["<extra_id_0>"] * len(reqs),
        "query_prompt": ["Query: " + r.query + "\n" for r in reqs],
        "task_prompt": [TASK_PROMPT] * len(reqs),
    }


def _results(futs, timeout=120):
    return [f.result(timeout=timeout) for f in futs]


# ------------------------------------------------------ against the JAX package
def test_full_batch_equals_jax_generate(pair):
    jm, port = pair
    reqs = [_request(i) for i in range(4)]
    want = jm.generate(_samples(reqs))
    with MomentRetrievalServer(port, max_batch=4, max_wait_ms=LONG_WAIT_MS) as srv:
        got = _results([srv.submit(r) for r in reqs])
        st = srv.stats()
    assert st.batches == 1 and st.mean_batch_occupancy == 1.0
    for i, g in enumerate(got):
        assert g["raw_prediction"] == want["raw_prediction"][i]
        assert g["prediction"] == want["prediction"][i]
        assert g["qid"] == f"q{i}" and g["duration"] == 30.0


def test_ragged_batch_equals_jax_generate_on_the_padded_rows(pair):
    """3 requests drained by close() as one batch, padded to the bucket of 4
    by repeating the last row: the rows equal the JAX package's generate on
    those 4 padded rows, and the padded row's result is dropped."""
    jm, port = pair
    reqs = [_request(i, duration=25.0) for i in range(3)]
    want = jm.generate(_samples(reqs + [reqs[-1]]))
    srv = MomentRetrievalServer(port, max_batch=4, max_wait_ms=LONG_WAIT_MS,
                                batch_buckets=[4])
    futs = [srv.submit(r) for r in reqs]
    srv.close(drain=True, timeout=120)
    got = _results(futs)
    for i, g in enumerate(got):
        assert g["raw_prediction"] == want["raw_prediction"][i]
        assert g["prediction"] == want["prediction"][i]
    st = srv.stats()
    assert (st.completed, st.batches, st.mean_batch_occupancy) == (3, 1, 0.75)


def test_batches_and_occupancy_equal_the_jax_server_s(pair):
    """The same single-thread submissions (6 requests, max_batch 4, bucket
    4, a deadline no request reaches, then close): the same batches, the
    same occupancy and the same rows on both servers."""
    jm, port = pair
    out = {}
    for name, cls, req_cls, model in (("jax", JaxServer, JaxRequest, jm),
                                      ("port", MomentRetrievalServer, MRRequest, port)):
        srv = cls(model, max_batch=4, max_wait_ms=LONG_WAIT_MS, batch_buckets=[4],
                  decode_workers=0)
        futs = [srv.submit(_request(i, cls=req_cls)) for i in range(6)]
        srv.close(drain=True, timeout=120)
        st = srv.stats()
        out[name] = ((st.submitted, st.completed, st.failed, st.batches,
                      st.mean_batch_occupancy),
                     [f.result(timeout=5)["raw_prediction"] for f in futs])
    assert out["port"] == out["jax"]
    assert out["port"][0] == (6, 6, 0, 2, 0.75)


# ------------------------------------------------------- behaviour (port only)
def test_single_request_deadline(model):
    with MomentRetrievalServer(model, max_batch=4, max_wait_ms=10) as srv:
        out = srv.submit(_request(0)).result(timeout=120)
        st = srv.stats()
    assert isinstance(out["prediction"], str)
    assert st.batches == 1 and st.mean_batch_occupancy == 1.0  # bucket 1


def test_video_path_decode(model):
    """A ``synthetic://`` request decoded in the pool equals the direct flow:
    the eval processor's frames and timestamps through ``generate``."""
    proc = BlipVideoEvalProcessor(image_size=28, n_frms=2, normalize=False)
    with MomentRetrievalServer(model, vis_processor=proc, max_batch=2, max_wait_ms=5,
                               decode_workers=1) as srv:
        out = srv.submit(MRRequest(query="anything", duration=2.0,
                                   video_path=CLIP)).result(timeout=120)
    frames, indices, fps = proc(CLIP, clip_proposal=None)
    req = MRRequest(query="anything", duration=2.0, video=_as_model_frames(frames),
                    timestamps=np.asarray([round(float(i / fps), 2) for i in indices]))
    assert out["raw_prediction"] == model.generate(_samples([req]))["raw_prediction"][0]


def test_close_drains_inflight_decode(model):
    """close(drain=True) while a request is still in the decode pool: the
    device loop waits for it to enqueue, so its future resolves."""
    proc = BlipVideoEvalProcessor(image_size=28, n_frms=2, normalize=False)

    class SlowProc:
        def __call__(self, path, clip_proposal=None):
            time.sleep(0.4)  # the device loop sees an empty, closed queue meanwhile
            return proc(path, clip_proposal=clip_proposal)

    srv = MomentRetrievalServer(model, vis_processor=SlowProc(), max_batch=2,
                                max_wait_ms=1, decode_workers=1)
    fut = srv.submit(MRRequest(query="anything", duration=2.0, video_path=CLIP))
    srv.close(drain=True, timeout=120)
    assert "prediction" in fut.result(timeout=5)


def test_inline_decode_is_counted_and_drains(model):
    """With no decode pool the decode runs in ``submit``; it is counted as
    in flight like a pooled one, so the loop still exits on close."""
    proc = BlipVideoEvalProcessor(image_size=28, n_frms=2, normalize=False)
    srv = MomentRetrievalServer(model, vis_processor=proc, max_batch=2, max_wait_ms=1,
                                decode_workers=0)
    fut = srv.submit(MRRequest(query="anything", duration=2.0, video_path=CLIP))
    assert srv._decoding == 0
    srv.close(drain=True, timeout=120)
    assert not srv._device_thread.is_alive()
    assert "prediction" in fut.result(timeout=5)


def test_bad_request_fails_future(model):
    with MomentRetrievalServer(model, max_batch=2, max_wait_ms=5) as srv:
        fut = srv.submit(MRRequest(query="x", duration=1.0))  # no video
        with pytest.raises(ValueError):
            fut.result(timeout=10)
        no_proc = srv.submit(MRRequest(query="x", duration=1.0, video_path=CLIP))
        with pytest.raises(RuntimeError, match="vis_processor"):
            no_proc.result(timeout=10)
        assert "prediction" in srv.submit(_request(3)).result(timeout=120)
    st = srv.stats()
    assert st.failed == 2 and st.completed == 1


def test_mixed_n_frms_fails_only_the_offender(model):
    """A request with another frame count is rejected alone, before staging
    (its co-batched requests complete) and holds no staging slot."""
    with MomentRetrievalServer(model, max_batch=4, max_wait_ms=5) as srv:
        good = [srv.submit(_request(i)) for i in range(2)]
        bad = srv.submit(_request(9, t=3))
        with pytest.raises(ValueError, match="n_frms"):
            bad.result(timeout=30)
        for f in good:
            assert "prediction" in f.result(timeout=120)
    st = srv.stats()
    assert st.failed == 1 and st.completed == 2
    assert srv._staged == 0


def test_submit_after_close_raises(model):
    srv = MomentRetrievalServer(model, max_batch=2, max_wait_ms=5)
    srv.close(drain=True)
    with pytest.raises(RuntimeError):
        srv.submit(_request(0))


def test_enqueue_racing_close_fails_its_future(model):
    """A request that reaches the queue after the device loop's last drain
    (a decode finishing after close) fails instead of hanging."""
    srv = MomentRetrievalServer(model, max_batch=2, max_wait_ms=5)
    srv.close(drain=True, timeout=60)
    from concurrent.futures import Future

    fut = Future()
    srv._enqueue(_request(0), fut)
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)
    assert srv.stats().failed == 1


def test_close_drains(model):
    srv = MomentRetrievalServer(model, max_batch=4, max_wait_ms=LONG_WAIT_MS)
    futs = [srv.submit(_request(i)) for i in range(2)]
    t0 = time.time()
    srv.close(drain=True, timeout=120)  # the deadline is never reached: close launches
    assert all(f.done() for f in futs) and time.time() - t0 < 120
    for f in futs:
        assert "prediction" in f.result(timeout=1)


def test_close_without_drain_cancels_the_queue(model):
    """close(drain=False) cancels the queued requests, and a request still in
    the decode pool when it is called is cancelled once it enqueues: every
    future resolves and the device loop ends."""
    proc = BlipVideoEvalProcessor(image_size=28, n_frms=2, normalize=False)

    class SlowProc:
        def __call__(self, path, clip_proposal=None):
            time.sleep(0.3)
            return proc(path, clip_proposal=clip_proposal)

    srv = MomentRetrievalServer(model, vis_processor=SlowProc(), max_batch=4,
                                max_wait_ms=LONG_WAIT_MS, decode_workers=1)
    futs = [srv.submit(_request(i)) for i in range(2)]
    futs.append(srv.submit(MRRequest(query="x", duration=2.0, video_path=CLIP)))
    srv.close(drain=False, timeout=60)
    assert not srv._device_thread.is_alive()
    assert all(f.cancelled() for f in futs)
    assert srv.stats().batches == 0 and srv._decoding == 0


def test_max_staged_holds_no_slot_on_the_cpu(model):
    """Staging copies frames to the card; a model on the CPU stages nothing,
    so no request ever holds a slot, and every row still equals generate."""
    reqs = [_request(i) for i in range(6)]
    want = model.generate(_samples(reqs))
    srv = MomentRetrievalServer(model, max_batch=2, max_wait_ms=5, max_staged=2)
    try:
        futs = [srv.submit(r) for r in reqs]
        assert srv.stats().staged == 0 and srv._stage_stream is None
        got = _results(futs, timeout=240)
    finally:
        srv.close()
    assert srv._staged == 0
    assert all(isinstance(r.video, np.ndarray) and not r._staged_by_server for r in reqs)
    for i, g in enumerate(got):
        assert g["raw_prediction"] == want["raw_prediction"][i]


def test_frames_as_a_tensor_on_the_model_s_device(model):
    """A tensor already on the model's device is taken as it is."""
    reqs = [_request(i) for i in range(2)]
    want = model.generate(_samples(reqs))
    tensor_reqs = [MRRequest(query=r.query, duration=r.duration, qid=r.qid,
                             video=torch.from_numpy(r.video)) for r in reqs]
    with MomentRetrievalServer(model, max_batch=2, max_wait_ms=5) as srv:
        got = _results([srv.submit(r) for r in tensor_reqs])
    assert [g["raw_prediction"] for g in got] == want["raw_prediction"]
    assert all(isinstance(r.video, torch.Tensor) and not r._staged_by_server
               for r in tensor_reqs)


def test_warmup_runs_every_bucket_without_touching_stats(model, monkeypatch):
    calls = []
    dispatch = model.generate_dispatch

    def counted(samples):
        calls.append(len(samples["query_id"]))
        return dispatch(samples)

    monkeypatch.setattr(model, "generate_dispatch", counted)
    reqs = [_request(i) for i in range(2)]
    want = model.generate(_samples(reqs))
    calls.clear()
    with MomentRetrievalServer(model, max_batch=2, max_wait_ms=5,
                               batch_buckets=[1, 2]) as srv:
        assert srv.warmup(n_frms=2, image_size=28, duration=30.0) >= 0.0
        assert calls == [1, 2]
        st = srv.stats()
        assert st.submitted == 0 and st.completed == 0 and st.batches == 0
        got = _results([srv.submit(r) for r in reqs])
    for i, g in enumerate(got):
        assert g["raw_prediction"] == want["raw_prediction"][i]


def test_each_batch_is_collected_before_the_next_dispatch(model, monkeypatch):
    """``generate_dispatch`` runs the whole beam search, so by default the
    device loop collects a batch right after its dispatch: with a second
    full batch queued while the first runs, the first batch's futures have
    resolved before the second is dispatched."""
    events, queued = [], threading.Event()
    dispatch, collect = model.generate_dispatch, model.generate_collect

    def logged_dispatch(samples):
        queued.wait(timeout=60)  # the second batch is queued meanwhile
        events.append(("dispatch", [f.done() for f in futs]))
        return dispatch(samples)

    def logged_collect(handle):
        events.append(("collect", None))
        return collect(handle)

    monkeypatch.setattr(model, "generate_dispatch", logged_dispatch)
    monkeypatch.setattr(model, "generate_collect", logged_collect)
    futs = []
    with MomentRetrievalServer(model, max_batch=4, max_wait_ms=LONG_WAIT_MS) as srv:
        futs.extend(srv.submit(_request(i)) for i in range(8))
        queued.set()
        _results(futs)
    assert [e for e, _ in events] == ["dispatch", "collect", "dispatch", "collect"]
    assert events[2][1] == [True] * 4 + [False] * 4


def test_stats_latency_quantiles(model):
    with MomentRetrievalServer(model, max_batch=2, max_wait_ms=5) as srv:
        _results([srv.submit(_request(i)) for i in range(4)])
        st = srv.stats()
    assert st.submitted == 4 and st.completed == 4
    assert 0 < st.latency_p50_s <= st.latency_p95_s <= st.latency_p99_s
    assert st.throughput_rps > 0 and st.queued == 0


def test_concurrent_submitters_lose_no_request(model):
    """16 threads (more than the cores) submit frame, ``video_path`` and
    malformed requests while the interpreter switches threads every
    microsecond: every future resolves, and the counters the device thread,
    the decode pool and the submitters share add up."""
    proc = BlipVideoEvalProcessor(image_size=28, n_frms=2, normalize=False)
    srv = MomentRetrievalServer(model, vis_processor=proc, max_batch=4, max_wait_ms=2,
                                decode_workers=3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(k):
            futs = []
            for j in range(3):
                kind = (k + j) % 3
                req = (_request(k) if kind == 0 else
                       MRRequest(query="x", duration=2.0, video_path=CLIP, qid=f"p{k}")
                       if kind == 1 else MRRequest(query="no frames", duration=1.0))
                futs.append((kind, srv.submit(req)))
            return futs

        with ThreadPoolExecutor(16) as pool:
            futs = [f for fs in pool.map(client, range(16)) for f in fs]
        srv.close(drain=True, timeout=240)
    finally:
        sys.setswitchinterval(interval)
    assert not srv._device_thread.is_alive()
    for kind, fut in futs:
        if kind == 2:
            with pytest.raises(ValueError):
                fut.result(timeout=1)
        else:
            assert "prediction" in fut.result(timeout=1)
    st = srv.stats()
    bad = sum(kind == 2 for kind, _ in futs)
    assert (st.submitted, st.completed, st.failed) == (48, 48 - bad, bad)
    assert st.queued == 0 and srv._decoding == 0 and srv._staged == 0


def test_quantiles_and_bucket_choice_equal_the_jax_server_s(model):
    from mr_blip_tpu.serving import server as jax_server
    from mr_blip_tpu_torch.serving import server as port_server

    vals = sorted(np.random.default_rng(0).random(37).tolist())
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert port_server._quantile(vals, q) == jax_server._quantile(vals, q)
    assert np.isnan(port_server._quantile([], 0.5))
    srv = MomentRetrievalServer(model, max_batch=6, batch_buckets=[2, 5])
    srv.close()
    assert srv.batch_buckets == [2, 5, 6]
    assert [srv._bucket_for(n) for n in range(1, 7)] == [2, 2, 5, 5, 5, 6]


# ------------------------------------------------------------------- HTTP
@pytest.fixture()
def httpd(model):
    proc = BlipVideoEvalProcessor(image_size=28, n_frms=2, normalize=False)
    srv = MomentRetrievalServer(model, vis_processor=proc, max_batch=2, max_wait_ms=5,
                                decode_workers=1)
    server = make_httpd(srv, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()
    srv.close()


def _call(server, route, payload=None):
    url = f"http://127.0.0.1:{server.server_address[1]}{route}"
    req = (urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                  headers={"Content-Type": "application/json"})
           if payload is not None else url)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_and_stats(httpd):
    assert _call(httpd, "/healthz") == (200, {"ok": True})
    code, st = _call(httpd, "/v1/stats")
    assert code == 200 and "throughput_rps" in st and st["submitted"] == 0
    assert _call(httpd, "/nope")[0] == 404
    assert _call(httpd, "/v1/nope", {"query": "x"})[0] == 404


def test_predict_matches_direct_flow(httpd, model):
    code, out = _call(httpd, "/v1/moment_retrieval", {
        "query": "anything", "duration": 2.0, "video_path": CLIP, "qid": "http1"})
    assert code == 200, out
    assert out["qid"] == "http1" and out["duration"] == 2.0
    proc = BlipVideoEvalProcessor(image_size=28, n_frms=2, normalize=False)
    frames, indices, fps = proc(CLIP, clip_proposal=None)
    req = MRRequest(query="anything", duration=2.0, video=_as_model_frames(frames),
                    timestamps=np.asarray([round(float(i / fps), 2) for i in indices]))
    want = model.generate(_samples([req]))
    assert out["raw_prediction"] == want["raw_prediction"][0]
    assert out["prediction"] == want["prediction"][0]


def test_bad_request_400_and_decode_failure_500(httpd):
    code, out = _call(httpd, "/v1/moment_retrieval", {"query": "no duration or path"})
    assert code == 400 and "error" in out
    code, out = _call(httpd, "/v1/moment_retrieval",
                      {"query": "x", "duration": "soon", "video_path": CLIP})
    assert code == 400 and "error" in out
    # a decode failure is the request's, not the server's
    code, out = _call(httpd, "/v1/moment_retrieval", {
        "query": "x", "duration": 1.0, "video_path": "/nonexistent/clip.mp4"})
    assert code == 500 and "error" in out
    assert _call(httpd, "/healthz")[0] == 200
    assert _call(httpd, "/v1/stats")[1]["failed"] == 1


def test_serve_module_drains_on_sigterm_and_exits_0():
    """``python -m mr_blip_tpu_torch.serve`` on the CPU: one request served,
    then SIGTERM stops the HTTP server, drains the engine, prints the stats
    as one JSON line and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mr_blip_tpu_torch.serve", "--model-type", "tiny",
         "--device", "cpu", "--port", "0", "--host", "127.0.0.1", "--n-frms", "2",
         "--max-wait-ms", "5", "--warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        while not lines or not lines[-1].startswith("serving on"):
            line = proc.stdout.readline()
            assert line, f"server exited early: {proc.stderr.read()}"
            lines.append(line.strip())
        port = int(lines[-1].rsplit(":", 1)[1])
        assert lines[0].startswith("warmup: 3 batch buckets")
        payload = {"query": "a person", "duration": 2.0, "video_path": CLIP, "qid": "s1"}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/moment_retrieval",
                                     data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and json.loads(r.read())["qid"] == "s1"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["completed"] == 1 and stats["submitted"] == 1 and stats["queued"] == 0


def test_serve_flags_default_to_the_card():
    args = parse_args([])
    assert args.device == "cuda" and args.model_type == "pretrain_flant5xl"
    assert (args.port, args.max_batch, args.max_wait_ms, args.n_frms) == (8080, 4, 50.0, 60)


# ------------------------------------------------------------- load_model
def test_load_model_equals_from_config(tmp_path):
    cfg = dict(load_yaml(str(REPO / "configs/models/blip2/blip2_tiny.yaml"))["model"])
    want = BLIP2_MR.from_config(cfg, device="cpu")
    got = load_model("blip2_mr", "tiny", device="cpu")
    assert type(got) is BLIP2_MR and got.t5_config == want.t5_config
    assert got.vit_config == want.vit_config and got.num_beams == want.num_beams == 2
    sd = got.state_dict()
    assert sd.keys() == want.state_dict().keys()
    assert all(torch.equal(v, want.state_dict()[k]) for k, v in sd.items())
    # a torch.save checkpoint, loaded non-strict over the built weights
    ckpt = {k: torch.full_like(v, 0.5) for k, v in sd.items() if "lora_" in k}
    torch.save(ckpt, tmp_path / "ft.pth")
    loaded = load_model("blip2_mr", "tiny", device="cpu", checkpoint=str(tmp_path / "ft.pth"))
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in ckpt.items())
    with pytest.raises(ValueError, match="msgpack"):
        load_model("blip2_mr", "tiny", device="cpu", checkpoint=str(tmp_path / "x.msgpack"))
    # kwargs over the YAML, as the reference's load_model takes them
    assert load_model("blip2_mr", "tiny", device="cpu", num_beams=1).num_beams == 1


def test_load_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would build there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model("blip2_mr", "tiny")


def test_load_model_and_preprocess():
    model, vis, txt = load_model_and_preprocess("blip2_mr", "tiny", device="cpu")
    assert isinstance(model, BLIP2_MR)
    assert vis["eval"].image_size == vis["train"].image_size == 28
    assert not vis["eval"].do_normalize and not vis["train"].do_normalize
    # the JAX package's text processors: blip_caption to train, blip_question
    # to evaluate
    assert txt["train"]("What  Happens?") == "what happens?"
    assert txt["eval"]("What  Happens?") == "what  happens?"


@pytest.mark.parametrize("name,item", [("blip2_feature_extractor", "Dormant LAVIS zoo"),
                                       ("clip", "Dormant LAVIS zoo"),
                                       ("timesformer", "Dormant LAVIS zoo")])
def test_unported_family_raises_with_its_roadmap_item(name, item):
    with pytest.raises(NotImplementedError, match=f'ROADMAP Queue 1, "{item}"'):
        load_model(name, device="cpu")


def test_families_are_the_jax_registry_s():
    """Every family the JAX package registers is either ported (in the
    port's zoo) or named with its ROADMAP item; an unknown name is a
    ValueError. Classes other test files register in either registry (in
    this worker's process) are left out of both sides."""
    from mr_blip_tpu_torch.common.registry import registry

    def families(reg, package):
        return {name for name, cls in reg.mapping["model_name_mapping"].items()
                if cls.__module__.startswith(package + ".")}

    jax_names = families(jax_registry, "mr_blip_tpu")
    ported = families(registry, "mr_blip_tpu_torch")
    zoo = dict(model_zoo)
    assert ported == {"blip2_mr", "blip2_opt_mr", "blip2_fmr", "blip_caption",
                      "blip_retrieval"} <= zoo.keys()
    assert sum(len(zoo[name]) for name in ported) == 13
    assert jax_names == ported | set(UNPORTED_FAMILIES) | set(ZOO_FAMILIES)
    with pytest.raises(ValueError, match="unknown model"):
        load_model("no_such_model", device="cpu")
