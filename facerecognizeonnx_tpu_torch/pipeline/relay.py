"""Rank 0's request stream, relayed to the follower ranks of `serve`.

A service on a mesh (`IdentifyService(mesh=..., sharded=...)`) needs
every rank to hold the same requests in the same order: its workers
agree on each micro-batch, and a rank with no requests would hold every
batch at zero. `serve` on N ranks runs the HTTP server on rank 0 only.
There `RelayedService` stands in front of the service: every call that
reaches the service or the bank (an identify, a bank update, the close)
goes to the local service and, under one lock so in the same order, to
each follower over a TCP connection. A follower runs the same service
with no HTTP (`follow`) and drops its answers.

The connections are opened once, before the service is built
(`open_relay`, collective over the default process group): rank 0
listens on the coordinator's host, sends the port and a random token to
every rank, and accepts one connection from each follower presenting
the token. An idle relay holds no collective, so an idle server never
meets the group timeout.

Wire format: a 4-byte big-endian length and a JSON header, then an
8-byte length and the raw bytes of the array the header describes
(shape, dtype), if any. Headers: {"op": "identify", "top_k"},
{"op": "bank", "method": "add" | "remove", "name"} and {"op": "close"}.
"""

from __future__ import annotations

import json
import os
import secrets
import socket
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from facerecognizeonnx_tpu_torch.parallel.distributed import GROUP_TIMEOUT


def _send(sock: socket.socket, header: dict, array: Optional[np.ndarray] = None) -> None:
    if array is not None:
        array = np.ascontiguousarray(array)
        header = dict(header, shape=list(array.shape), dtype=str(array.dtype))
    head = json.dumps(header).encode()
    data = b"" if array is None else array.tobytes()
    sock.sendall(struct.pack(">I", len(head)) + head + struct.pack(">Q", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("the relay connection closed mid-message")
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket) -> Tuple[dict, Optional[np.ndarray]]:
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, n))
    (m,) = struct.unpack(">Q", _recv_exact(sock, 8))
    data = _recv_exact(sock, m)
    if "shape" not in header:
        return header, None
    array = np.frombuffer(data, dtype=np.dtype(header["dtype"])).reshape(header["shape"])
    return header, array


class Leader:
    """Rank 0's end: one connection to each follower."""

    def __init__(self, conns: List[socket.socket]):
        self.conns = conns

    def send(self, header: dict, array: Optional[np.ndarray] = None) -> None:
        for conn in self.conns:
            _send(conn, header, array)

    def close(self) -> None:
        for conn in self.conns:
            conn.close()


def open_relay():
    """Connect rank 0 with every other rank of the default process group
    (collective: every rank calls it). Returns a `Leader` on rank 0, the
    connection to rank 0 elsewhere."""
    import torch.distributed as dist

    timeout = GROUP_TIMEOUT.total_seconds()
    rank, world = dist.get_rank(), dist.get_world_size()
    host = os.environ.get("COORDINATOR_ADDRESS", "127.0.0.1:0").rsplit(":", 1)[0]
    if rank == 0:
        listener = socket.create_server((host, 0))
        listener.settimeout(timeout)
        token = secrets.token_hex(16)
        dist.broadcast_object_list([(host, listener.getsockname()[1], token)], src=0)
        conns = []
        try:
            while len(conns) < world - 1:
                conn, _ = listener.accept()
                conn.settimeout(timeout)
                if _recv_exact(conn, len(token)).decode(errors="replace") != token:
                    conn.close()  # not one of our ranks
                    continue
                conn.settimeout(None)
                conns.append(conn)
        except BaseException:
            for conn in conns:
                conn.close()
            raise
        finally:
            listener.close()
        return Leader(conns)
    obj = [None]
    dist.broadcast_object_list(obj, src=0)
    host, port, token = obj[0]
    conn = socket.create_connection((host, port), timeout=timeout)
    conn.sendall(token.encode())
    conn.settimeout(None)
    return conn


class RelayedService:
    """Rank 0's front of an `IdentifyService`: the calls the HTTP server
    makes, each also sent to the followers in the order the local
    service takes them (module docstring)."""

    def __init__(self, service, leader: Leader):
        self.service, self.leader = service, leader
        self._lock = threading.Lock()

    def identify_async(self, image_bgr: np.ndarray, top_k: int = 1):
        with self._lock:
            fut = self.service.identify_async(image_bgr, top_k)
            self.leader.send({"op": "identify", "top_k": int(top_k)}, image_bgr)
        return fut

    def identify(self, image_bgr: np.ndarray, top_k: int = 1, timeout: float = 120.0):
        return self.identify_async(image_bgr, top_k).result(timeout)

    def update_bank(self, method: str, name: str, feature=None):
        with self._lock:
            fut = self.service.update_bank(method, name, *(() if feature is None else (feature,)))
            self.leader.send({"op": "bank", "method": method, "name": name},
                             None if feature is None else np.asarray(feature, np.float32))
        return fut

    def stats(self):
        return self.service.stats()

    def close(self):
        """Close every follower's service, then the local one."""
        with self._lock:
            self.leader.send({"op": "close"})
            self.leader.close()
        self.service.close()


def follow(service, conn: socket.socket) -> None:
    """Feed rank 0's stream (the connection `open_relay` returned) into
    this rank's `service` until rank 0 closes it, then close the service.
    The answers are dropped."""
    try:
        while True:
            header, array = _recv(conn)
            op = header["op"]
            if op == "close":
                break
            if op == "identify":
                service.identify_async(array, int(header["top_k"]))
            elif op == "bank":
                service.update_bank(header["method"], header["name"],
                                    *(() if array is None else (array,)))
            else:
                raise ValueError(f"unknown relay message {header!r}")
    finally:
        conn.close()
        service.close()
