"""``htr_vt_torch/cli/server.py``: HTTP serving over an exported bundle,
micro-batched, as ``tests/test_server.py`` drives the JAX server.

Exports a tiny bundle (its own weights, converted from a JAX model), starts
the server in-process and drives it with concurrent POSTs: each response
is the text and bucket the bundle gives for the line the handler prepared,
the micro-batcher groups concurrent requests into fewer program calls than
requests, ``/healthz`` reports the bundle's meta, and bad input is refused.
``BatchWorker.submit`` takes prepared numpy lines from threads, as on a
machine without PIL."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from htr_vt_torch.cli.server import BatchWorker, route_width, serve
from htr_vt_torch.data.image import prepare_line_image
from htr_vt_torch.deploy import ServingBundle
from test_torch_port_deploy import write_bundle
from test_torch_port_model import tiny_jax_weights, tiny_port_model

BATCH = 4
REQUESTS = 4
WIDTHS = (128, 256)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    params, stats = tiny_jax_weights(seed=4)
    out = write_bundle(tmp_path_factory.mktemp("bundle") / "b",
                       tiny_port_model(params, stats), WIDTHS, BATCH)
    httpd, worker = serve(out, port=0, batch_wait_ms=200.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", worker
    httpd.shutdown()
    httpd.server_close()
    worker.stop()
    worker.join(timeout=30)


def _line(rng, h=48, w=200):
    return (rng.random((h, w)) * 255).astype(np.uint8)


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, data):
    req = urllib.request.Request(url + "/transcribe", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _expected(bundle, arr):
    """The text and bucket the bundle gives for one line, prepared as the
    handler prepares it."""
    width = route_width(bundle, arr)
    line = prepare_line_image(arr, max_w=width, max_h=bundle.height)
    batch = np.concatenate([line[None], np.ones((BATCH - 1, *line.shape), np.float32)])
    return bundle.decode(*bundle.run(batch, width))[0], width


def test_healthz(server):
    url, worker = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["status"] == "ok" and meta["device"] == "cpu"
    assert meta["widths"] == list(WIDTHS) and meta["batch_size"] == BATCH
    assert meta["quant"] == "float" and meta["served"] == worker.served


def test_transcribe_and_microbatching(server):
    url, worker = server
    bundle = worker.bundle
    rng = np.random.default_rng(0)
    first = _line(rng)
    reply = _post(url, _png_bytes(first))
    assert set(reply) == {"text", "width_bucket"}
    assert (reply["text"], reply["width_bucket"]) == _expected(bundle, first)

    # natural widths at 64 px: 266, 120, 293, 80 -> buckets 256, 128, 256, 128
    lines = [_line(rng, w=w) for w in (200, 90, 220, 60)]
    batches_before, served_before = worker.batches, worker.served
    results = [None] * REQUESTS

    def go(i):
        results[i] = _post(url, _png_bytes(lines[i]))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for arr, r in zip(lines, results):
        assert (r["text"], r["width_bucket"]) == _expected(bundle, arr)
    assert {r["width_bucket"] for r in results} == set(WIDTHS)
    # 4 concurrent requests over two buckets within one 200 ms window: one
    # program call a bucket, fewer calls than requests
    assert worker.served - served_before == REQUESTS
    assert worker.batches - batches_before < REQUESTS


def test_worker_takes_numpy_lines_from_threads(server):
    _, worker = server
    bundle = worker.bundle
    rng = np.random.default_rng(1)
    lines = [rng.random((64, 128, 1), dtype=np.float32) for _ in range(6)]
    pending = [None] * len(lines)

    def go(i):
        pending[i] = worker.submit(lines[i], 128)
        pending[i].event.wait(60)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(lines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = bundle.transcribe(np.stack(lines))
    assert [p.text for p in pending] == want
    assert all(p.error is None for p in pending)


def test_bad_requests(server):
    url, _ = server
    req = urllib.request.Request(url + "/transcribe", data=b"not an image",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nowhere", timeout=30)
    assert e.value.code == 404


def test_a_stopped_worker_refuses(server):
    bundle = server[1].bundle
    worker = BatchWorker(bundle)
    worker.start()
    worker.stop()
    worker.join(timeout=30)
    p = worker.submit(np.ones((64, 128, 1), np.float32), 128)
    assert p.event.is_set() and p.error == "server shutting down"
    assert isinstance(bundle, ServingBundle)
