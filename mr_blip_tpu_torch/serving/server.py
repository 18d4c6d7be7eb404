"""Online serving for moment retrieval: deadline batching over the
dispatch/collect pipeline (counterpart of ``mr_blip_tpu/serving/server.py``).

The reference has no serving subsystem: its only batch-inference path is the
offline evaluation loop (``evaluate.py:66-120``). This server accepts single
(video, query) requests as they arrive, batches them, and returns span
predictions with bounded queueing latency.

Design:

* **Batch buckets.** Requests are padded (the last row replicated) up to the
  next size in ``batch_buckets`` (default 1/2/4/``max_batch``), so the model
  sees few batch shapes (the per-length encoder-bias cache and cuBLAS's
  algorithm choices are per shape). Padded rows cost compute and are
  dropped before post-processing; rows are independent (encoder masks,
  per-row beam search), so the real rows' results do not depend on them.
* **One device thread.** Every dispatch and collect runs on one thread, in
  order. ``BLIP2_MR.generate_dispatch`` runs the whole beam search before it
  returns, so each batch is collected right after its dispatch
  (``pipeline_depth=1``, the default). A deeper pipeline would overlap
  nothing: it would only hold a finished batch's results while the next
  batch runs. The parameter is kept for the launch rule below, which reads
  what is in flight.
* **Deadline batching, device-aware.** A full ``max_batch`` batch launches
  at once; a ragged (padded) batch launches only when the oldest queued
  request has waited ``max_wait_ms`` AND nothing is in flight. With a
  pipeline deeper than 1, an early ragged launch would only queue behind
  the batch in flight and waste its padded rows, so under load the server
  waits for full batches. At depth 1 nothing is in flight when a batch
  forms, and a ragged batch leaves once its oldest request's deadline
  has passed.
* **Decode offload.** A request carries decoded frames or a ``video_path``;
  path requests are decoded by a thread pool through the eval processor
  (the native reader releases the GIL), so the decode of request k overlaps
  the device work of earlier batches.
* **Host-to-card staging at enqueue.** With the model on the card, each
  request's frames are copied from a pinned host tensor on a side CUDA
  stream the moment the request is ready; the dispatch stream waits on the
  copy's event and stacks the batch on the card. A staged block is marked
  used by the dispatch stream (``record_stream``), so the caching allocator
  does not hand it out again before the batch has read it. At most
  ``max_staged`` queued requests hold staged frames; past the cap frames
  wait on the host and are copied inside the dispatch. Frames already on
  the model's device are taken as they are. A model on the CPU stages
  nothing.
* **Replicas** (``model.set_mesh(devices)``, the dp server). The server
  does not change: ``generate_dispatch`` splits each batch over the
  replicas. ``self.device`` is the first replica's; with every replica on
  that card the frames are staged there as above, and with replicas on
  several cards each batch's frames wait in pinned host memory and each
  replica copies its block of rows to its own card.

Usage::

    server = MomentRetrievalServer(model, vis_processor=eval_proc)
    fut = server.submit(MRRequest(query="person opens the door",
                                  video_path="clip.mp4", duration=150.0))
    print(fut.result()["prediction"])    # "[[12.0, 17.5]]"
    server.close()
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from mr_blip_tpu_torch.datasets.mr_datasets import TASK_PROMPT, _as_model_frames


@dataclass
class MRRequest:
    """One moment-retrieval query against one video.

    Either ``video`` (decoded ``(T, H, W, 3)`` uint8 frames, a numpy array or
    a tensor, + ``timestamps`` in seconds) or ``video_path`` (decoded by the
    server through the eval processor; ``clip_proposal`` crops in seconds as
    the reference's ``load_video`` does, ``data_utils.py:30-85``).
    ``duration`` is required: it feeds the prompt and the span clamping as
    the dataset path does.
    """

    query: str
    duration: float
    video: Any = None
    timestamps: Optional[np.ndarray] = None
    video_path: Optional[str] = None
    clip_proposal: Optional[Sequence[float]] = None
    qid: str = ""
    # filled by the server
    _t_submit: float = field(default=0.0, repr=False)
    _staged_by_server: bool = field(default=False, repr=False)
    _stage_event: Any = field(default=None, repr=False)


@dataclass
class ServerStats:
    """Point-in-time snapshot (``MomentRetrievalServer.stats()``)."""

    submitted: int
    completed: int
    failed: int
    queued: int
    staged: int  # queued requests holding frames staged on the card
    batches: int
    mean_batch_occupancy: float  # real rows / padded rows, dispatched
    throughput_rps: float  # completed / wall since the first submit
    latency_p50_s: float
    latency_p95_s: float
    latency_p99_s: float

    def as_dict(self) -> Dict[str, Any]:
        return self.__dict__.copy()


def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _host_tensor(video) -> torch.Tensor:
    return video if isinstance(video, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(video))


class MomentRetrievalServer:
    """Batched online inference over ``model.generate_dispatch/collect``.

    ``model`` is a ready ``BLIP2_MR`` (weights loaded, quantized or not: the
    server does not care); it serves on the model's device. ``vis_processor``
    (e.g. ``BlipVideoEvalProcessor`` with ``normalize=False``) is needed only
    for ``video_path`` requests.
    """

    def __init__(
        self,
        model,
        vis_processor=None,
        max_batch: int = 4,
        max_wait_ms: float = 15.0,
        decode_workers: int = 2,
        pipeline_depth: int = 1,
        batch_buckets: Optional[Sequence[int]] = None,
        latency_window: int = 10000,
        stage_to_device: bool = True,
        max_staged: int = 64,
    ):
        self.model = model
        self.vis_processor = vis_processor
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        devices = [torch.device(d) for d in getattr(
            model, "replica_devices", [getattr(model, "device", "cpu")])]
        self.device = devices[0]
        # Replicas on several devices: each copies its own rows (no staging).
        self._spread = len(set(devices)) > 1
        self.stage_to_device = bool(stage_to_device)
        self._staging = (self.stage_to_device and self.device.type == "cuda"
                         and not self._spread)
        self._stage_stream = torch.cuda.Stream(self.device) if self._staging else None
        # Card-memory guard: at most this many queued requests hold staged
        # frames (~9 MB each at 60 frames of 224²); a backlog past the cap
        # waits on the host and is copied when dispatched instead.
        self.max_staged = int(max_staged)
        self._staged = 0
        self._expected_t: Optional[int] = None  # n_frms, fixed by request 1
        self.pipeline_depth = max(1, int(pipeline_depth))
        if batch_buckets is None:
            batch_buckets = sorted({1, 2, 4, self.max_batch})
        self.batch_buckets = sorted(b for b in set(batch_buckets) if b <= self.max_batch)
        if not self.batch_buckets or self.batch_buckets[-1] != self.max_batch:
            self.batch_buckets.append(self.max_batch)

        self._lock = threading.Lock()
        self._queue: deque = deque()  # (req, future), decoded and ready
        self._wakeup = threading.Event()
        self._closed = False
        self._drain = True  # close(drain=False) cancels what is queued
        # video_path requests still in the decode pool: the device loop must
        # not exit on close() while one could still enqueue (its future
        # would never resolve).
        self._decoding = 0

        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._batches = 0
        self._rows_real = 0
        self._rows_padded = 0
        self._t_first_submit: Optional[float] = None
        self._latencies: deque = deque(maxlen=latency_window)

        self._decode_pool = (
            ThreadPoolExecutor(decode_workers, thread_name_prefix="mrserve-dec")
            if decode_workers > 0 else None)
        self._device_thread = threading.Thread(
            target=self._device_loop, name="mrserve-device", daemon=True)
        self._device_thread.start()

    # ------------------------------------------------------------- public
    def submit(self, req: MRRequest) -> Future:
        """Enqueue one request; the future resolves to the per-request
        result dict ``{prediction, raw_prediction, qid, duration}``."""
        fut: Future = Future()
        req._t_submit = time.monotonic()
        with self._lock:
            # Checked under the lock close() takes: a submit racing close()
            # could otherwise slip past the device loop's last drain check
            # and leave its future pending forever.
            if self._closed:
                raise RuntimeError("server is closed")
            self._submitted += 1
            if self._t_first_submit is None:
                self._t_first_submit = req._t_submit
        if req.video is None:
            if req.video_path is None:
                return self._fail(fut, ValueError("request needs video frames or video_path"))
            if self.vis_processor is None:
                return self._fail(fut, RuntimeError("video_path request but no vis_processor"))
            # Counted on both paths, the inline one too: its decrement in
            # _decode_and_enqueue's finally would otherwise drive the count
            # below zero and the device loop would never see it at 0 again.
            with self._lock:
                self._decoding += 1
            if self._decode_pool is None:
                self._decode_and_enqueue(req, fut)
            else:
                self._decode_pool.submit(self._decode_and_enqueue, req, fut)
        else:
            self._enqueue(req, fut)
        return fut

    def warmup(
        self,
        n_frms: int,
        image_size: Optional[int] = None,
        duration: float = 150.0,
        example_queries: Optional[Sequence[str]] = None,
        buckets: Optional[Sequence[int]] = None,
    ) -> float:
        """Run one synthetic batch per bucket before taking traffic, so that
        no request pays for the first call at a shape: the kernels' build
        and load, the per-length encoder-bias cache, cuBLAS's set-up. The
        batches go straight through ``generate_dispatch/collect`` on the
        caller's thread, outside the queue and the stats. Returns the wall
        seconds spent.

        The prompt's text length is padded to a multiple of 16 tokens
        (``prepare_mr_batch``), so ``example_queries`` and ``duration``
        should look like production traffic.
        """
        image_size = int(image_size or getattr(self.model, "img_size", 224))
        queries = list(example_queries or ["a person opens the door and walks into the room"])
        frames = np.zeros((n_frms, image_size, image_size, 3), np.uint8)
        ts = np.linspace(0.0, float(duration), n_frms, endpoint=False)
        t0 = time.monotonic()
        for b in (buckets if buckets is not None else self.batch_buckets):
            b = int(b)
            samples = {
                "video": np.stack([frames] * b),
                "timestamps": np.stack([ts] * b),
                "duration": np.asarray([float(duration)] * b),
                "query_id": [""] * b,
                "video_prompt_end": ["<extra_id_0>"] * b,
                "query_prompt": ["Query: " + queries[i % len(queries)] + "\n"
                                 for i in range(b)],
                "task_prompt": [TASK_PROMPT] * b,
            }
            self.model.generate_collect(self.model.generate_dispatch(samples))
        return time.monotonic() - t0

    def stats(self) -> ServerStats:
        with self._lock:
            lat = sorted(self._latencies)
            wall = time.monotonic() - self._t_first_submit if self._t_first_submit else 0.0
            return ServerStats(
                submitted=self._submitted,
                completed=self._completed,
                failed=self._failed,
                queued=len(self._queue),
                staged=self._staged,
                batches=self._batches,
                mean_batch_occupancy=(self._rows_real / self._rows_padded
                                      if self._rows_padded else float("nan")),
                throughput_rps=self._completed / wall if wall > 0 else 0.0,
                latency_p50_s=_quantile(lat, 0.50),
                latency_p95_s=_quantile(lat, 0.95),
                latency_p99_s=_quantile(lat, 0.99),
            )

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop accepting requests; by default finish everything queued.
        With ``drain=False`` every queued request's future is cancelled
        instead, those a decode still in the pool enqueues later too."""
        with self._lock:
            self._closed = True
            self._drain = drain
            self._cancel_queued()
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=drain)
        self._wakeup.set()
        self._device_thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ decode
    def _fail(self, fut: Future, error: BaseException) -> Future:
        with self._lock:
            self._failed += 1
        fut.set_exception(error)
        return fut

    def _decode_and_enqueue(self, req: MRRequest, fut: Future):
        try:
            try:
                frames, indices, fps = self.vis_processor(
                    req.video_path, clip_proposal=req.clip_proposal)
                req.video = _as_model_frames(frames)
                req.timestamps = np.asarray(
                    [round(float(i / fps), 2) for i in indices], np.float64)
            except Exception as e:  # noqa: BLE001 - fail the one request
                self._fail(fut, e)
                return
            self._enqueue(req, fut)
        finally:
            with self._lock:
                self._decoding -= 1
            self._wakeup.set()  # re-check the exit and launch conditions

    def _stage(self, req: MRRequest):
        """Copy the request's frames to the card on the side stream, from a
        pinned host tensor; the copy's event goes with the request."""
        host = _host_tensor(req.video).pin_memory()
        with torch.cuda.stream(self._stage_stream):
            req.video = host.to(self.device, non_blocking=True)
            req._stage_event = torch.cuda.Event()
            req._stage_event.record(self._stage_stream)
        req._staged_by_server = True

    def _enqueue(self, req: MRRequest, fut: Future):
        if req.timestamps is None:
            req.timestamps = np.linspace(0.0, float(req.duration), req.video.shape[0],
                                         endpoint=False)
        # The frame count is checked per request before staging: one odd
        # request fails alone (not its whole batch) and never holds a slot.
        t = int(req.video.shape[0])
        with self._lock:
            if self._expected_t is None:
                self._expected_t = t
            expected = self._expected_t
        if t != expected:
            self._fail(fut, ValueError(
                f"request n_frms={t} != server n_frms={expected} "
                "(all requests in one server share the frame count)"))
            return
        on_device = isinstance(req.video, torch.Tensor) and req.video.device == self.device
        if self._staging and not on_device:
            with self._lock:
                stage_now = self._staged < self.max_staged
                if stage_now:
                    self._staged += 1
            if stage_now:
                try:
                    self._stage(req)
                except Exception as e:  # noqa: BLE001 - fail the one request
                    with self._lock:
                        self._staged -= 1
                    self._fail(fut, e)
                    return
        with self._lock:
            if self._closed and not self._device_thread.is_alive():
                # Raced close(): the device loop has made its last drain, so
                # nothing would ever collect this future.
                self._failed += 1
                if req._staged_by_server:
                    self._staged -= 1
                fut.set_exception(RuntimeError("server is closed"))
                return
            self._queue.append((req, fut))
        self._wakeup.set()

    # ------------------------------------------------------- device loop
    def _bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _cancel_queued(self):
        """After ``close(drain=False)``: cancel the queued requests' futures
        (caller holds the lock)."""
        while self._closed and not self._drain and self._queue:
            req, fut = self._queue.popleft()
            if req._staged_by_server:
                self._staged -= 1
            fut.cancel()

    def _maybe_form_batch(self, allow_ragged: bool):
        """Pop a batch if the launch condition holds (caller holds the lock).

        ``allow_ragged``: nothing is in flight, so a padded batch may launch
        once the deadline has passed. Otherwise only full batches (or the
        drain on close) launch.
        """
        self._cancel_queued()
        n = len(self._queue)
        if n == 0:
            return None
        if n >= self.max_batch or self._closed:
            return [self._queue.popleft() for _ in range(min(n, self.max_batch))]
        if allow_ragged:
            oldest_wait = time.monotonic() - self._queue[0][0]._t_submit
            if oldest_wait >= self.max_wait_s:
                return [self._queue.popleft() for _ in range(n)]
        return None

    def _batch_frames(self, rows) -> torch.Tensor:
        """(bucket, T, H, W, 3) frames on the model's device. A staged row
        is read on the dispatch stream after its copy's event; other rows
        are copied here. Replicas on several cards: the frames in pinned
        host memory (host tensors) for the replicas to copy."""
        if self._spread:
            host = torch.stack([_host_tensor(r.video).cpu() for r in rows])
            return host.pin_memory() if torch.cuda.is_available() else host
        stream = torch.cuda.current_stream(self.device) if self._staging else None
        videos = []
        for r in rows:
            video = r.video
            if r._stage_event is not None:
                stream.wait_event(r._stage_event)
                video.record_stream(stream)
            elif not (isinstance(video, torch.Tensor) and video.device == self.device):
                video = _host_tensor(video).to(self.device)
            videos.append(video)
        return torch.stack(videos)

    def _form_samples(self, entries) -> Dict[str, Any]:
        reqs = [r for r, _ in entries]
        rows = reqs + [reqs[-1]] * (self._bucket_for(len(reqs)) - len(reqs))
        # Mixed frame counts are rejected per request in _enqueue; this is a
        # cannot-happen guard, inside the try so the slots are released.
        try:
            t_counts = {r.video.shape[0] for r in rows}
            if len(t_counts) != 1:
                raise RuntimeError(f"mixed n_frms in one dispatch: {t_counts}")
            video = self._batch_frames(rows)
        finally:
            # Always release the staged slots of this dispatch: a raise above
            # must not shrink the staging budget for good.
            released = sum(r._staged_by_server for r in reqs)
            if released:
                with self._lock:
                    self._staged -= released
        return {
            "video": video,
            "timestamps": np.stack([np.asarray(r.timestamps, np.float64) for r in rows]),
            "duration": np.asarray([float(r.duration) for r in rows]),
            "query_id": [r.qid for r in rows],
            "video_prompt_end": ["<extra_id_0>"] * len(rows),
            "query_prompt": ["Query: " + r.query + "\n" for r in rows],
            "task_prompt": [TASK_PROMPT] * len(rows),
        }

    def _collect(self, inflight_entry):
        entries, handle = inflight_entry
        try:
            out = self.model.generate_collect(handle)
        except Exception as e:  # noqa: BLE001 - fail the whole batch
            with self._lock:
                self._failed += len(entries)
            for _req, fut in entries:
                if not fut.done():
                    fut.set_exception(e)
            return
        now = time.monotonic()
        lats = []
        for i, (req, fut) in enumerate(entries):  # padded rows are not read
            lats.append(now - req._t_submit)
            fut.set_result({
                "prediction": out["prediction"][i],
                "raw_prediction": out["raw_prediction"][i],
                "qid": req.qid,
                "duration": float(req.duration),
            })
        with self._lock:
            self._completed += len(entries)
            self._latencies.extend(lats)

    def _device_loop(self):
        inflight: deque = deque()
        while True:
            with self._lock:
                batch_entries = self._maybe_form_batch(allow_ragged=not inflight)
            if batch_entries is not None:
                try:
                    samples = self._form_samples(batch_entries)
                    handle = self.model.generate_dispatch(samples)
                except Exception as e:  # noqa: BLE001
                    with self._lock:
                        self._failed += len(batch_entries)
                    for _req, fut in batch_entries:
                        fut.set_exception(e)
                    continue
                with self._lock:
                    self._batches += 1
                    self._rows_real += len(batch_entries)
                    self._rows_padded += samples["video"].shape[0]
                inflight.append((batch_entries, handle))
                if len(inflight) < self.pipeline_depth:
                    continue  # fill the pipeline before blocking
            if inflight:
                self._collect(inflight.popleft())
                continue
            # Idle: nothing in flight and no batch to launch.
            with self._lock:
                if not self._queue and self._decoding == 0 and self._closed:
                    return
                wait = (max(1e-3, self.max_wait_s
                            - (time.monotonic() - self._queue[0][0]._t_submit))
                        if self._queue else None)
            self._wakeup.wait(timeout=wait if wait is not None else 0.05)
            self._wakeup.clear()
