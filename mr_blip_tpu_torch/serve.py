"""HTTP serving daemon for moment retrieval (the port's counterpart of the
repo's ``scripts/serve.py``).

A stdlib-only (``http.server``) JSON API over
:class:`mr_blip_tpu_torch.serving.MomentRetrievalServer`. Each connection
blocks in its own handler thread on ``submit().result()``, so requests are
batched by the batching engine, not here.

Endpoints:
  POST /v1/moment_retrieval   {"query": str, "duration": float,
                               "video_path": str,
                               "clip_proposal": [s, e]?, "qid": str?}
                              -> {"prediction", "raw_prediction",
                                  "qid", "duration"}
  GET  /v1/stats              -> ServerStats (occupancy, p50/p95/p99, ...)
  GET  /healthz               -> {"ok": true}

Usage:
    python -m mr_blip_tpu_torch.serve --model blip2_mr \
        --model-type pretrain_flant5xl --checkpoint mr_blip_qvh.pth \
        --n-frms 60 --int8 --port 8080

The model runs on ``--device``, the card unless ``--device cpu``; with
``--devices cuda:0,cuda:1,...`` one replica of it runs on each device and
every batch is split over them (``BLIP2_MR.set_mesh``). The replicas are
threads of this process: on one card two serve fewer requests a second
than one model (their host-bound decodes share one interpreter lock).
SIGTERM or SIGINT stops the HTTP server, drains the batching engine (queued
requests finish), prints the final stats as one JSON line and exits 0.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def make_httpd(mr_server, host="127.0.0.1", port=0, request_timeout=600.0):
    """Build (but do not start) the HTTP server bound to ``mr_server``."""
    from mr_blip_tpu_torch.serving import MRRequest

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet; the numbers are at /v1/stats
            pass

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, {"ok": True})
            if self.path == "/v1/stats":
                return self._reply(200, mr_server.stats().as_dict())
            return self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/moment_retrieval":
                return self._reply(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                req = MRRequest(
                    query=payload["query"],
                    duration=float(payload["duration"]),
                    video_path=payload["video_path"],
                    clip_proposal=payload.get("clip_proposal"),
                    qid=str(payload.get("qid", "")),
                )
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad request: {e!r}"})
            try:
                out = mr_server.submit(req).result(timeout=request_timeout)
            except Exception as e:  # noqa: BLE001 - reported per request
                return self._reply(500, {"error": repr(e)})
            return self._reply(200, out)

    return ThreadingHTTPServer((host, port), Handler)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Moment-retrieval HTTP server")
    ap.add_argument("--model", default="blip2_mr")
    ap.add_argument("--model-type", default="pretrain_flant5xl")
    ap.add_argument("--checkpoint", default=None,
                    help="finetuned torch.save state dict (non-strict load)")
    ap.add_argument("--params-dtype", default=None, choices=("bfloat16", "float32"),
                    help="zero init instead of random weights, for load tests where "
                         "--checkpoint covers (or stands in for) every tensor")
    ap.add_argument("--n-frms", type=int, default=60)
    ap.add_argument("--int8", action="store_true",
                    help="quantize_for_inference() before serving")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--decode-workers", type=int, default=2)
    ap.add_argument("--warmup", action="store_true",
                    help="run one batch per batch bucket before binding the port, so "
                         "that no request pays for a first call")
    ap.add_argument("--warmup-duration", type=float, default=150.0,
                    help="video duration (s) of the warmup prompts; match production "
                         "traffic so that its prompt lengths are the ones warmed")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: the card unless 'cpu'")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices, one model replica on each "
                         "(e.g. cuda:0,cuda:1); each batch is split over them, "
                         "in threads of this process")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from mr_blip_tpu_torch.models import load_model
    from mr_blip_tpu_torch.processors.video_processors import BlipVideoEvalProcessor
    from mr_blip_tpu_torch.serving import MomentRetrievalServer

    extra = {"params_dtype": args.params_dtype} if args.params_dtype else {}
    devices = args.devices.split(",") if args.devices else [args.device]
    model = load_model(args.model, args.model_type, is_eval=True,
                       checkpoint=args.checkpoint, device=devices[0], **extra)
    if args.int8:
        model.quantize_for_inference()
    if args.devices:
        model.set_mesh(devices)
        print(f"replicas on {', '.join(devices)}", flush=True)
    proc = BlipVideoEvalProcessor(image_size=getattr(model, "img_size", 224),
                                  n_frms=args.n_frms, normalize=False)
    mr_server = MomentRetrievalServer(
        model, vis_processor=proc, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, decode_workers=args.decode_workers)
    if args.warmup:
        secs = mr_server.warmup(n_frms=args.n_frms, duration=args.warmup_duration)
        print(f"warmup: {len(mr_server.batch_buckets)} batch buckets run in {secs:.1f} s",
              flush=True)
    httpd = make_httpd(mr_server, host=args.host, port=args.port)

    def _shutdown(signum, frame):
        # stop accepting; the batching engine drains below, then exit 0
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    print(f"serving on {args.host}:{httpd.server_address[1]}", flush=True)
    httpd.serve_forever()
    httpd.server_close()
    mr_server.close(drain=True)
    print(json.dumps(mr_server.stats().as_dict()), flush=True)


if __name__ == "__main__":
    main()
