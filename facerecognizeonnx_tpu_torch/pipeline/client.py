"""Python client for the HTTP identification service.

Port of `facerecognizeonnx_tpu/pipeline/client.py`, the port's own copy
(standard library only: http.client and sockets, the server's bar). The
server is `pipeline/server.py`; the client runs anywhere.

    client = IdentifyClient("127.0.0.1", 8080, token="s3cret")
    client.enroll("alice", open("alice.png", "rb").read())
    res = client.identify(open("frame.png", "rb").read(), top_k=3)
    for line in client.identify_stream(frame_bytes_iter()):
        print(line["frame"], line.get("faces"))

identify_stream speaks the server's length-prefixed frame protocol over
a raw socket with a writer thread, so frame upload, device micro-batches
and result download overlap (full duplex): results arrive while later
frames are still uploading.
"""

from __future__ import annotations

import http.client
import json
import socket
import struct
import threading
from typing import Dict, Iterable, Iterator, List, Optional


class ServiceError(RuntimeError):
    """Non-2xx reply from the service (carries status + payload)."""

    def __init__(self, status: int, payload):
        super().__init__(f"HTTP {status}: {payload}")
        self.status = status
        self.payload = payload


class IdentifyClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8080,
        token: Optional[str] = None,
        timeout: float = 120.0,
    ):
        self.host = host
        self.port = port
        self.token = token
        self.timeout = timeout

    # ------------------------------------------------------------ plumbing

    def _headers(self, extra: Optional[Dict[str, str]] = None):
        h = dict(extra or {})
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _request(self, method: str, path: str, body: Optional[bytes] = None):
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            headers = self._headers(
                {"Content-Length": str(len(body))} if body is not None else {}
            )
            conn.request(method, path, body=body, headers=headers)
            r = conn.getresponse()
            payload = json.loads(r.read() or b"{}")
            if not 200 <= r.status < 300:
                raise ServiceError(r.status, payload)
            return payload
        finally:
            conn.close()

    # ------------------------------------------------------------ endpoints

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def stats(self) -> dict:
        return self._request("GET", "/stats")

    def identify(self, image_bytes: bytes, top_k: int = 1) -> List[dict]:
        """One encoded image (JPEG/PNG) → list of face dicts
        (box/score/names/sims)."""
        return self._request(
            "POST", f"/identify?top_k={top_k}", image_bytes
        )["faces"]

    def enroll(self, name: str, image_bytes: bytes) -> dict:
        return self._request("POST", f"/enroll?name={name}", image_bytes)

    def remove(self, name: str) -> dict:
        """Delete every enrollment under `name`. Raises ServiceError(404)
        when the name is unknown (mirrors the endpoint contract)."""
        return self._request("DELETE", f"/enroll?name={name}")

    # ------------------------------------------------------------ streaming

    def identify_stream(
        self, frames: Iterable[bytes], top_k: int = 1
    ) -> Iterator[dict]:
        """Stream encoded frames, yield one result dict per frame in
        order ({"frame": i, "faces": [...]} or {"frame": i, "error": ...}).

        A writer thread uploads [len u32-be][bytes] frames + zero
        terminator while this thread parses the chunked NDJSON reply —
        full-duplex over one socket, so device batches run while the
        client is still uploading.
        """
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        try:
            head = (
                f"POST /identify_stream?top_k={top_k} HTTP/1.1\r\n"
                f"Host: {self.host}:{self.port}\r\n"
            )
            for k, v in self._headers().items():
                head += f"{k}: {v}\r\n"
            # raw-framed body (the server reads frames directly; the
            # explicit zero terminator marks the end, not Content-Length)
            head += "Content-Length: 0\r\n\r\n"
            sock.sendall(head.encode())

            writer_err: List[BaseException] = []

            def write_frames():
                try:
                    for f in frames:
                        sock.sendall(struct.pack(">I", len(f)) + f)
                    sock.sendall(struct.pack(">I", 0))
                except BaseException as e:  # surfaced after the read loop
                    writer_err.append(e)

            t = threading.Thread(target=write_frames, daemon=True)
            t.start()

            rfile = sock.makefile("rb")
            status_line = rfile.readline()
            parts = status_line.split()
            status = int(parts[1]) if len(parts) >= 2 else 0
            while True:  # drain headers
                line = rfile.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            if status != 200:
                raise ServiceError(status, {"error": "stream rejected"})
            buf = b""
            while True:  # chunked-body NDJSON
                size_line = rfile.readline().strip()
                if not size_line:
                    break
                size = int(size_line, 16)
                if size == 0:
                    break
                data = rfile.read(size)
                rfile.read(2)  # trailing CRLF
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        yield json.loads(line)
            t.join(timeout=self.timeout)
            if writer_err:
                raise writer_err[0]
        finally:
            sock.close()
