"""HTTP front-end over the micro-batching IdentifyService.

Port of `facerecognizeonnx_tpu/pipeline/server.py`. Standard library
only (http.server), so concurrent HTTP callers ride the same coalesced
device micro-batches as in-process callers.

Endpoints:
  POST   /identify[?top_k=K]   image bytes (JPEG/PNG/BMP) →
      {"faces": [{"box": [x1,y1,x2,y2], "score": s,
                  "names": [...], "sims": [...]}]}
  POST   /identify_stream      length-prefixed frame stream (see below) →
      chunked NDJSON, one {"frame": i, "faces": [...]} line per frame
  POST   /enroll?name=NAME     image bytes → enrolls the best face
  DELETE /enroll?name=NAME     removes every enrollment under NAME
  GET    /healthz              {"status": "ok", "gallery_size": N}
  GET    /stats                micro-batching counters (JSON)
  GET    /metrics              the same counters in Prometheus text
                               exposition format

Images are decoded by `io.imageio.decode_image` (the native codecs, cv2,
PIL, then a PNG reader of the standard library: a host without the
codecs, cv2 and PIL reads PNG only).

Streaming wire format: the request body is a sequence of [4-byte
big-endian length][image bytes] frames terminated by a zero length;
results stream back as chunked NDJSON in frame order while later frames
are still uploading (each frame rides the shared device micro-batches,
so concurrent streams coalesce).

Auth: pass auth_token to make_server (CLI --auth-token / FRT_AUTH_TOKEN)
to require `Authorization: Bearer <token>` on every request (401
otherwise, constant-time comparison).

Run: python -m facerecognizeonnx_tpu_torch serve --port 8080 [--gallery g.npz]
"""

from __future__ import annotations

import hmac
import json
import struct
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from facerecognizeonnx_tpu_torch.io.imageio import decode_image
from facerecognizeonnx_tpu_torch.match.gallery import GalleryBank
from facerecognizeonnx_tpu_torch.pipeline.service import IdentifyService


def _faces_payload(res, top_k: int) -> list:
    """IdentifyResult → JSON-safe face list (shared by both endpoints)."""
    faces = []
    for i in range(len(res.valid)):
        if not res.valid[i]:
            continue
        faces.append({
            "box": [round(float(v), 2) for v in res.boxes[i]],
            "score": round(float(res.scores[i]), 4),
            "names": list(res.names[i]),
            "sims": [round(float(s), 4) for s in res.sims[i]],
        })
    return faces


class _Handler(BaseHTTPRequestHandler):
    # chunked responses (identify_stream) require HTTP/1.1; every other
    # reply carries an exact Content-Length so keep-alive stays correct
    protocol_version = "HTTP/1.1"

    # injected by make_server()
    service: IdentifyService = None
    bank: GalleryBank = None
    enroll_fn = None
    remove_fn = None
    auth_token: Optional[str] = None
    # per-request future timeout: must cover a first call that builds a
    # kernel, not just steady-state batches
    request_timeout: float = 900.0

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length)

    def _safe(self, body_fn):
        """Turn handler exceptions into a 500 JSON reply. Without this,
        ThreadingHTTPServer silently swallows the exception and drops
        the connection: the client sees RemoteDisconnected and the
        operator sees nothing."""
        try:
            body_fn()
        except Exception as e:  # noqa: BLE001 — boundary of the process
            try:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                self.close_connection = True
            except Exception:
                pass

    def _authorized(self) -> bool:
        if not self.auth_token:
            return True
        supplied = self.headers.get("Authorization", "")
        if hmac.compare_digest(supplied, f"Bearer {self.auth_token}"):
            return True
        self._reply(401, {"error": "unauthorized"})
        # an unread streaming body would poison keep-alive reuse
        self.close_connection = True
        return False

    def do_GET(self):
        if not self._authorized():
            return
        self._safe(self._get)

    def _get(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            self._reply(200, {"status": "ok", "gallery_size": len(self.bank)})
        elif path == "/stats":
            self._reply(200, self.service.stats())
        elif path == "/metrics":
            stats = self.service.stats()
            lat = stats.pop("latency_ms", None)
            body = "".join(
                f"# TYPE frt_{k} {'gauge' if k == 'avg_batch' else 'counter'}\n"
                f"frt_{k} {v}\n"
                for k, v in stats.items()
            )
            if lat:
                body += "# TYPE frt_latency_ms summary\n" + "".join(
                    f'frt_latency_ms{{quantile="{q}"}} {lat[p]}\n'
                    for q, p in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99"))
                ) + f"frt_latency_ms_count {lat['window']}\n"
            body += (
                "# TYPE frt_gallery_size gauge\n"
                f"frt_gallery_size {len(self.bank)}\n"
            )
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._reply(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        if not self._authorized():
            return
        self._safe(self._post)

    def _post(self):
        url = urlparse(self.path)
        qs = parse_qs(url.query)
        if url.path == "/identify_stream":
            self._identify_stream(qs)
            return
        img = decode_image(self._read_body())
        if img is None:
            self._reply(400, {"error": "cannot decode image"})
            return
        if url.path == "/identify":
            top_k = int(qs.get("top_k", ["1"])[0])
            res = self.service.identify(
                img, top_k=top_k, timeout=self.request_timeout
            )
            self._reply(200, {"faces": _faces_payload(res, top_k)})
        elif url.path == "/enroll":
            name = qs.get("name", [""])[0]
            if not name:
                self._reply(400, {"error": "enroll needs ?name="})
                return
            ok = self.enroll_fn(name, img)
            code = 200 if ok else 422
            self._reply(code, {"enrolled": bool(ok), "name": name,
                               "gallery_size": len(self.bank)})
        else:
            self._reply(404, {"error": f"unknown path {url.path}"})

    # ---------------------------------------------------------- streaming

    def _write_chunk(self, data: bytes):
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    def _identify_stream(self, qs):
        """Length-prefixed frame stream → chunked NDJSON results.

        Frames are submitted to the micro-batching service as they
        arrive (identify_async); completed results are flushed in frame
        order while later frames still upload, so a single client's
        stream pipelines host decode, device batches, and the network.
        """
        top_k = int(qs.get("top_k", ["1"])[0])
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.close_connection = True  # raw-framed body: don't reuse

        pending: deque = deque()  # (frame_idx, Future | None-for-bad)
        frame_idx = 0

        def flush(block: bool):
            while pending:
                idx, fut = pending[0]
                if fut is None:
                    line = {"frame": idx, "error": "cannot decode image"}
                elif fut.done() or block:
                    line = {
                        "frame": idx,
                        "faces": _faces_payload(
                            fut.result(self.request_timeout), top_k
                        ),
                    }
                else:
                    return
                pending.popleft()
                self._write_chunk((json.dumps(line) + "\n").encode())

        # headers are already on the wire: errors must terminate the
        # chunk stream in-band (an error NDJSON line + final chunk), not
        # fall out to _safe's 500 reply (a second status line would
        # corrupt the stream)
        try:
            while True:
                header = self.rfile.read(4)
                if len(header) < 4:
                    break
                (n,) = struct.unpack(">I", header)
                if n == 0:  # explicit end-of-stream marker
                    break
                if n > 64 * 1024 * 1024:  # refuse absurd frames
                    break
                data = self.rfile.read(n)
                if len(data) < n:
                    break
                img = decode_image(data)
                pending.append(
                    (frame_idx,
                     None if img is None
                     else self.service.identify_async(img, top_k=top_k))
                )
                frame_idx += 1
                flush(block=False)
            flush(block=True)
        except Exception as e:  # noqa: BLE001 — in-band stream error
            try:
                self._write_chunk(
                    (json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ) + "\n").encode()
                )
            except Exception:
                pass
        self.wfile.write(b"0\r\n\r\n")

    def do_DELETE(self):
        if not self._authorized():
            return
        self._safe(self._delete)

    def _delete(self):
        url = urlparse(self.path)
        if url.path != "/enroll":
            self._reply(404, {"error": f"unknown path {url.path}"})
            return
        name = parse_qs(url.query).get("name", [""])[0]
        if not name:
            self._reply(400, {"error": "delete needs ?name="})
            return
        removed = self.remove_fn(name)
        self._reply(200 if removed else 404, {
            "removed": removed, "name": name,
            "gallery_size": len(self.bank),
        })


def make_server(
    detector,
    recognizer,
    bank: GalleryBank,
    host: str = "127.0.0.1",
    port: int = 8080,
    max_batch: int = 8,
    batch_window_ms: float = 5.0,
    auth_token: Optional[str] = None,
    request_timeout: float = 900.0,
    warmup: bool = True,
    sharded: bool = False,
    aot=None,
    mesh=None,
    fuse_search: bool = False,
    adaptive_embed: bool = False,
    device="cuda",
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; the caller runs serve_forever().

    detector / recognizer: a loaded FaceDetector / FaceRecognizer on
    `device`; their models feed one shared IdentifyService on `device`,
    and enrolls go through detect → align → embed and mutate `bank` in
    place (GalleryBank serializes its mutators, and each micro-batch
    answers against one snapshot of it). auth_token, when set, gates
    every endpoint behind `Authorization: Bearer <token>`. warmup runs
    one synthetic identify before returning, so a first use (kernel
    builds) happens before the first client request. fuse_search: one
    dispatch per micro-batch with the gallery top-k on the device;
    adaptive_embed: the occupancy-adaptive bucketed embed (see
    IdentifyService). aot: a .frtz path or `AotPipeline` — /identify runs
    the loaded bundle (one CUDA-graph replay per micro-batch on the card)
    while enrolls still go through detector / recognizer. sharded spreads
    the gallery rows of the search over the ranks' "model" mesh; mesh (a
    mesh, or an int n for the first min(n, world) ranks) serves each
    micro-batch data-parallel (see IdentifyService).
    """
    service = IdentifyService(
        detector.params, recognizer.params, bank, cfg=detector.cfg,
        max_batch=max_batch, batch_window_ms=batch_window_ms,
        sharded=sharded, aot=aot, mesh=mesh, fuse_search=fuse_search,
        adaptive_embed=adaptive_embed, device=device,
    )
    if warmup:
        service.identify(np.zeros((64, 64, 3), np.uint8), top_k=1, timeout=1800.0)

    def enroll(name: str, image: np.ndarray) -> bool:
        faces = detector.detect(image)
        if not faces:
            return False
        feat = recognizer.extract_feature(image, faces[0])
        if not feat.size:
            return False
        bank.add(name, feat)
        return True

    handler = type("Handler", (_Handler,), {
        "service": service, "bank": bank, "enroll_fn": staticmethod(enroll),
        "remove_fn": staticmethod(bank.remove), "auth_token": auth_token,
        "request_timeout": request_timeout,
    })
    server = ThreadingHTTPServer((host, port), handler)
    server.frt_service = service  # for clean shutdown by the caller
    return server
