"""The port's HTTP server and client (pipeline/server.py, pipeline/client.py).

The cases of the JAX package's server tests (tests/test_service.py), run
on the port on the CPU: the round trip, Bearer auth, the frame stream,
the 500 on a handler exception, /stats and /metrics, the client SDK; then
the port's /identify payloads against the JAX server's on the same PNG
bytes and the same enrollments: face counts and names equal, boxes
within 1 px, sims within 1e-4 (the payload rounds sims to 4 places and
boxes to 2). Weights and configs as tests/test_torch_app.py; images are
128×128, the detector's size, so both services' letterboxes are the
identity. The services batch 2 frames (max_batch=2): a padded batch of 8
costs seconds per request on one CPU thread.
"""

import http.client
import json
import struct
import threading
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from chip_smoke import png_bytes
from facerecognizeonnx_tpu.match.gallery import GalleryBank as JaxBank
from facerecognizeonnx_tpu.pipeline.server import make_server as jax_make_server
from facerecognizeonnx_tpu_torch import IdentifyClient, make_server
from facerecognizeonnx_tpu_torch.errors import ModelLoadError
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.pipeline.client import ServiceError
from facerecognizeonnx_tpu_torch.pipeline.server import _Handler
from tests.test_torch_app import load_both, seeded_weights

TOKEN = "s3cret"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(51)
    images = rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    models = load_both(seeded_weights(tmp_path_factory.mktemp("w"), images))
    # PNG bytes of the BGR images (png_bytes takes RGB)
    return models, [png_bytes(np.ascontiguousarray(im[..., ::-1])) for im in images]


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server.server_address[1]


@pytest.fixture(scope="module")
def port_server(world):
    ((det, rec), _), _ = world
    server = make_server(det, rec, GalleryBank(device="cpu"), port=0, max_batch=2,
                         batch_window_ms=5, auth_token=TOKEN, device="cpu")
    port = _serve(server)
    yield server, port
    server.shutdown()
    server.server_close()
    server.frt_service.close()


def _call(port, method, path, body=None, token=TOKEN):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    if body is not None:
        headers["Content-Length"] = str(len(body))
    conn.request(method, path, body=body, headers=headers)
    r = conn.getresponse()
    data = r.read()
    ctype = r.getheader("Content-Type")
    conn.close()
    return r.status, (json.loads(data) if ctype == "application/json" else data.decode()), ctype


def test_http_roundtrip(world, port_server):
    _, pngs = world
    server, port = port_server
    status, health, _ = _call(port, "GET", "/healthz")
    assert status == 200 and health == {"status": "ok", "gallery_size": 0}
    status, resp, _ = _call(port, "POST", "/enroll?name=alice", pngs[0])
    assert status == 200 and resp["enrolled"] and resp["gallery_size"] == 1
    # an identify sent after the enroll's reply sees the new name
    status, resp, _ = _call(port, "POST", "/identify?top_k=1", pngs[0])
    assert status == 200 and resp["faces"]
    face = resp["faces"][0]
    assert len(face["box"]) == 4 and face["names"] == ["alice"] and face["sims"][0] >= 0.999
    assert _call(port, "POST", "/enroll", pngs[0])[0] == 400  # missing name
    assert _call(port, "POST", "/identify", b"not an image")[0] == 400
    assert _call(port, "POST", "/enroll?name=x", b"not an image")[0] == 400
    blank = png_bytes(np.zeros((128, 128, 3), np.uint8))
    status, resp, _ = _call(port, "POST", "/enroll?name=nobody", blank)
    assert status == 422 and not resp["enrolled"]
    assert _call(port, "GET", "/nowhere")[0] == 404
    status, stats, _ = _call(port, "GET", "/stats")
    assert status == 200 and stats["requests"] >= 2
    lat = stats["latency_ms"]
    assert lat["window"] >= 1 and 0 < lat["p50"] <= lat["p90"] <= lat["p99"]
    status, text, ctype = _call(port, "GET", "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    for line in ("# TYPE frt_requests counter", "frt_gallery_size 1",
                 "# TYPE frt_latency_ms summary", 'frt_latency_ms{quantile="0.99"}',
                 "frt_latency_ms_count"):
        assert line in text
    status, resp, _ = _call(port, "DELETE", "/enroll?name=alice")
    assert status == 200 and resp["removed"] == 1 and resp["gallery_size"] == 0
    status, resp, _ = _call(port, "DELETE", "/enroll?name=alice")  # already gone
    assert status == 404 and resp["removed"] == 0
    assert _call(port, "DELETE", "/enroll")[0] == 400
    assert _call(port, "DELETE", "/elsewhere?name=a")[0] == 404


def test_http_auth_stream_and_client(world, port_server):
    _, pngs = world
    _, port = port_server
    assert _call(port, "GET", "/healthz", token=None)[0] == 401
    assert _call(port, "GET", "/healthz", token="wrong")[0] == 401
    frames = [pngs[1], b"not an image", pngs[2]]
    body = b"".join(struct.pack(">I", len(f)) + f for f in frames) + struct.pack(">I", 0)
    status, text, ctype = _call(port, "POST", "/identify_stream?top_k=1", body)
    assert status == 200 and ctype == "application/x-ndjson"
    lines = [json.loads(x) for x in text.splitlines() if x.strip()]
    assert [x["frame"] for x in lines] == [0, 1, 2]  # frame order kept
    assert "error" in lines[1] and lines[0]["faces"] and lines[2]["faces"]
    assert _call(port, "POST", "/identify_stream", body, token=None)[0] == 401

    client = IdentifyClient("127.0.0.1", port, token=TOKEN, timeout=600)
    assert client.healthz()["status"] == "ok"
    assert client.enroll("bob", pngs[1])["enrolled"]
    faces = client.identify(pngs[1], top_k=1)
    assert faces and faces[0]["names"] == ["bob"]
    got = list(client.identify_stream(iter(frames), top_k=1))
    assert [x["frame"] for x in got] == [0, 1, 2] and "error" in got[1]
    assert got[0]["faces"] == faces  # the stream answers as /identify does
    assert client.stats()["requests"] >= 1
    assert client.remove("bob")["removed"] == 1
    with pytest.raises(ServiceError) as ei:
        client.remove("bob")
    assert ei.value.status == 404
    with pytest.raises(ServiceError) as ei:
        IdentifyClient("127.0.0.1", port, timeout=60).healthz()
    assert ei.value.status == 401
    with pytest.raises(ServiceError):
        list(IdentifyClient("127.0.0.1", port, timeout=60).identify_stream(iter(frames)))


def test_http_500_on_handler_exception():
    class Boom:
        def identify(self, *a, **k):
            raise RuntimeError("boom")

        def stats(self):
            raise RuntimeError("boom")

    handler = type("H", (_Handler,), {"service": Boom(), "bank": [], "auth_token": None})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    port = _serve(server)
    try:
        status, resp, _ = _call(port, "GET", "/stats", token=None)
        assert status == 500 and "boom" in resp["error"]
        status, resp, _ = _call(port, "POST", "/identify",
                                png_bytes(np.zeros((8, 8, 3), np.uint8)), token=None)
        assert status == 500 and "RuntimeError" in resp["error"]
        assert _call(port, "GET", "/healthz", token=None)[0] == 200
    finally:
        server.shutdown()
        server.server_close()


def test_identify_payloads_match_jax(world):
    """Both servers enroll the same two images over HTTP, then answer
    /identify?top_k=2 on all four."""
    ((det, rec), (jdet, jrec)), pngs = world
    ours = make_server(det, rec, GalleryBank(device="cpu"), port=0, max_batch=2, device="cpu")
    with jax.default_matmul_precision("highest"):
        theirs = jax_make_server(jdet, jrec, JaxBank(), port=0, max_batch=2)
    ports = _serve(ours), _serve(theirs)
    try:
        for name, png in (("ann", pngs[0]), ("bob", pngs[1])):
            for p in ports:
                status, resp, _ = _call(p, "POST", f"/enroll?name={name}", png, token=None)
                assert status == 200 and resp["enrolled"], resp
        n_faces = 0
        for png in pngs:
            got = _call(ports[0], "POST", "/identify?top_k=2", png, token=None)[1]["faces"]
            with jax.default_matmul_precision("highest"):
                want = _call(ports[1], "POST", "/identify?top_k=2", png, token=None)[1]["faces"]
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g["names"] == w["names"]
                np.testing.assert_allclose(g["box"], w["box"], atol=1.0)
                np.testing.assert_allclose(g["sims"], w["sims"], atol=1e-4)
                assert abs(g["score"] - w["score"]) <= 1e-3
            n_faces += len(got)
        assert n_faces >= 4
    finally:
        for s in (ours, theirs):
            s.shutdown()
            s.server_close()
            s.frt_service.close()


def test_make_server_defaults_and_unported_options(world, monkeypatch):
    """sharded and mesh are ported: on a one-rank Gloo mesh in process the
    server's service answers as an unsharded one."""
    ((det, rec), _), images = world
    from facerecognizeonnx_tpu_torch.io.imageio import decode_png

    bank = GalleryBank(device="cpu")
    bank.add_batch(["a", "b"], np.eye(2, 512, dtype=np.float32))
    image = decode_png(images[0])
    answers = []
    for kw in (dict(), dict(sharded=True), dict(mesh=2)):
        server = make_server(det, rec, bank, port=0, device="cpu", max_batch=2, **kw)
        try:
            answers.append(server.frt_service.identify(image, top_k=2))
        finally:
            server.server_close()
            server.frt_service.close()
    assert answers[0].valid.any()
    for got in answers[1:]:
        assert got.names == answers[0].names
        np.testing.assert_allclose(got.sims, answers[0].sims, rtol=0, atol=1e-6)
    with pytest.raises(ModelLoadError, match="not found"):  # aot is ported: a path is loaded
        make_server(det, rec, GalleryBank(device="cpu"), port=0, device="cpu", aot="x.frtz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_server(det, rec, GalleryBank(device="cpu"), port=0)
