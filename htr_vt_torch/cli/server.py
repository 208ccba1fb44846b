"""HTTP transcription server over an exported bundle (port of
``htr_vt_tpu/cli/server.py``).

    python -m htr_vt_torch.cli.export IAM --checkpoint ... --out bundle/
    python -m htr_vt_torch.cli.server --bundle bundle/ --port 8000

    curl -s --data-binary @line.png http://localhost:8000/transcribe
    -> {"text": "...", "width_bucket": 512}

The server loads only the bundle (``htr_vt_torch/deploy.py``), none of the
model code. Requests are micro-batched: a collector thread groups up to
``batch_size`` pending images (waiting at most ``--batch-wait-ms`` for
stragglers) and serves each width bucket in the group with one program
call, so concurrent clients share the card's work. Each image is resized
to height H, routed to the smallest bucket that holds its natural width
(the rule of ``cli/serve.py``) and padded white.

Endpoints:
    POST /transcribe   image bytes (png/jpg) -> {"text": ..., "width_bucket": ...}
    GET  /healthz      bundle meta, uptime and the worker's counts

PIL decodes the posted bytes and is imported in the handler only, so the
module imports on a machine without it; ``BatchWorker.submit`` takes
prepared numpy lines there.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from htr_vt_torch.data.image import prepare_line_image
from htr_vt_torch.deploy import ServingBundle


class _Pending:
    __slots__ = ("image", "width", "event", "text", "error")

    def __init__(self, image, width):
        self.image = image
        self.width = width
        self.event = threading.Event()
        self.text = None
        self.error = None


class BatchWorker(threading.Thread):
    """Groups pending requests per width bucket and serves each group with
    one bundle call."""

    def __init__(self, bundle: ServingBundle, batch_wait_ms: float = 5.0):
        super().__init__(daemon=True)
        self.bundle = bundle
        self.batch_wait = batch_wait_ms / 1e3
        self.inbox: "queue.Queue[_Pending]" = queue.Queue()
        self.served = 0
        self.batches = 0
        self._stopping = threading.Event()  # not _stop: Thread.join calls self._stop()

    def submit(self, image: np.ndarray, width: int) -> _Pending:
        """Queue one prepared line [H, width, 1] float32 for the ``width``
        bucket; wait on the returned request's ``event``."""
        p = _Pending(image, width)
        if self._stopping.is_set():  # refuse instead of queueing forever
            p.error = "server shutting down"
            p.event.set()
            return p
        self.inbox.put(p)
        if self._stopping.is_set():
            # stop() may have raced us between the check above and the put:
            # run()'s final drain could already be done, leaving p queued
            # with no reader. Drain is idempotent; whoever dequeues p first
            # (run() or us) sets its event exactly once.
            self._drain_on_stop()
        return p

    def stop(self):
        self._stopping.set()
        self.inbox.put(None)  # wake the collector

    def _drain_on_stop(self):
        """Fail everything still queued so no handler thread hangs on wait()."""
        while True:
            try:
                p = self.inbox.get_nowait()
            except queue.Empty:
                return
            if p is not None:
                p.error = "server shutting down"
                p.event.set()

    def run(self):
        while not self._stopping.is_set():
            first = self.inbox.get()
            if first is None:
                continue
            group = [first]
            deadline = time.monotonic() + self.batch_wait
            bs = self.bundle.batch_size
            while len(group) < bs:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self.inbox.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    continue
                group.append(nxt)
            # One program call per width present in the group.
            by_width = {}
            for p in group:
                by_width.setdefault(p.width, []).append(p)
            for width, ps in by_width.items():
                try:
                    imgs = np.stack([p.image for p in ps])
                    if imgs.shape[0] < bs:
                        pad = np.ones((bs - imgs.shape[0], *imgs.shape[1:]),
                                      imgs.dtype)
                        imgs = np.concatenate([imgs, pad], axis=0)
                    ids, lengths = self.bundle.run(imgs, width)
                    texts = self.bundle.decode(ids, lengths)
                    for p, t in zip(ps, texts):
                        p.text = t
                except Exception as e:  # surface to the waiting request
                    for p in ps:
                        p.error = str(e)
                finally:
                    self.batches += 1
                    self.served += len(ps)
                    for p in ps:
                        p.event.set()
        self._drain_on_stop()


def route_width(bundle: ServingBundle, img: np.ndarray) -> int:
    """The smallest bucket that holds the line's natural width at the
    bundle's height, else the widest."""
    h = bundle.height
    natural = max(1, int(img.shape[1] * h / max(1, img.shape[0])))
    return next((w for w in bundle.widths if natural <= w), bundle.widths[-1])


def make_handler(bundle: ServingBundle, worker: BatchWorker, started: float):
    widths = bundle.widths

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {
                "status": "ok",
                "uptime_s": round(time.monotonic() - started, 1),
                "widths": widths,
                "batch_size": bundle.batch_size,
                "quant": bundle.meta.get("quant"),
                "device": bundle.meta.get("device"),
                "served": worker.served,
                "batches": worker.batches,
            })

        def do_POST(self):
            if self.path != "/transcribe":
                return self._reply(404, {"error": "unknown path"})
            try:
                from PIL import Image
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                img = np.array(Image.open(io.BytesIO(raw)).convert("L"))
            except Exception as e:
                return self._reply(400, {"error": f"bad image: {e}"})
            width = route_width(bundle, img)
            pending = worker.submit(
                prepare_line_image(img, max_w=width, max_h=bundle.height), width)
            if not pending.event.wait(timeout=600.0):
                return self._reply(503, {"error": "request timed out"})
            if pending.error is not None:
                return self._reply(500, {"error": pending.error})
            self._reply(200, {"text": pending.text, "width_bucket": width})

    return Handler


def serve(bundle_dir: str, host: str = "127.0.0.1", port: int = 8000,
          batch_wait_ms: float = 5.0):
    """Build server + worker (started); returns (httpd, worker). The caller
    runs ``httpd.serve_forever()``, then ``httpd.shutdown()``,
    ``httpd.server_close()`` and ``worker.stop()``."""
    bundle = ServingBundle(bundle_dir)
    worker = BatchWorker(bundle, batch_wait_ms)
    worker.start()
    httpd = ThreadingHTTPServer(
        (host, port), make_handler(bundle, worker, time.monotonic()))
    return httpd, worker


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bundle", required=True, help="exported bundle dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-wait-ms", type=float, default=5.0,
                    help="max wait to fill a micro-batch")
    args = ap.parse_args(argv)
    httpd, worker = serve(args.bundle, args.host, args.port, args.batch_wait_ms)
    print(f"serving {args.bundle} on http://{args.host}:{httpd.server_address[1]} "
          f"(bs {worker.bundle.batch_size}, widths {worker.bundle.widths}, "
          f"{worker.bundle.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        worker.stop()


if __name__ == "__main__":
    main()
