"""Minimal length-prefixed TCP RPC — the zerorpc compatibility layer.

The reference runs the planner and the actuated sim as two OS processes
bridged by zerorpc over ``tcp://*:4242`` (reactive_tamp.py:92-94,
sim.py:29-30).  This design doesn't need a process split (one
device-resident loop, SURVEY.md §5 "Distributed communication backend"), but
the two-terminal workflow is preserved for parity via this dependency-free
server/client: stdlib sockets, frames of ``[u32 length | payload]``, a JSON
header naming the method plus N binary args serialized by
:mod:`m3p2i_aip_tpu.utils.data_transfer`.

Exposed methods mirror the reference RPC surface: ``run_tamp(dof_state,
root_state) -> action``, ``get_suction() -> int``, ``get_trajs() -> array``.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Callable, Dict, List

from m3p2i_aip_tpu.utils.data_transfer import array_to_bytes, bytes_to_numpy

_HDR = struct.Struct("!I")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(n)
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return _recv_exact(sock, n)


def _send_message(sock: socket.socket, header: dict, blobs: List[bytes]) -> None:
    header = dict(header, n_blobs=len(blobs))
    _send_frame(sock, json.dumps(header).encode())
    for b in blobs:
        _send_frame(sock, b)


def _recv_message(sock: socket.socket):
    header = json.loads(_recv_frame(sock).decode())
    blobs = [_recv_frame(sock) for _ in range(header.get("n_blobs", 0))]
    return header, blobs


# Only the reference's RPC surface is dispatchable (reactive_tamp.py:43-87);
# anything else (dunder attributes, internal state) is rejected.
_ALLOWED_METHODS = ("run_tamp", "get_suction", "get_trajs")


class Server:
    """Serve an object's methods. Parity: zerorpc.Server (reactive_tamp.py:92-94).

    Binds localhost by default (the reference binds 0.0.0.0, but its two
    processes always run on one host); pass ``host="0.0.0.0"`` explicitly for
    a remote sim terminal.  Dispatch is restricted to ``_ALLOWED_METHODS``.
    """

    def __init__(
        self,
        obj,
        host: str = "127.0.0.1",
        port: int = 4242,
        allowed_methods=_ALLOWED_METHODS,
    ):
        self._obj = obj
        self._allowed = frozenset(allowed_methods)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)

    def run(self) -> None:
        """Accept clients forever; one request at a time (the reference's RPC
        is synchronous per control tick)."""
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listening socket closed -> clean shutdown
            try:
                self.serve_client(conn)
            except (ConnectionError, OSError):
                pass
            finally:
                conn.close()

    def serve_client(self, conn: socket.socket) -> None:
        while True:
            header, blobs = _recv_message(conn)
            if header.get("method") == "__shutdown__":
                _send_message(conn, {"ok": True}, [])
                return
            name = header["method"]
            if name not in self._allowed:
                _send_message(
                    conn, {"ok": False, "error": f"method not allowed: {name}"}, []
                )
                continue
            method: Callable = getattr(self._obj, name)
            args = [bytes_to_numpy(b) for b in blobs]
            result = method(*args)
            if isinstance(result, (int, float, bool)):
                _send_message(conn, {"ok": True, "scalar": result}, [])
            elif result is None:
                _send_message(conn, {"ok": True, "scalar": None}, [])
            else:
                _send_message(conn, {"ok": True}, [array_to_bytes(result)])

    def close(self) -> None:
        self._sock.close()


class Client:
    """Parity: zerorpc.Client (sim.py:29-30) — ``call(method, *arrays)``."""

    def __init__(self):
        self._sock: socket.socket = None

    def connect(self, host: str = "127.0.0.1", port: int = 4242, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(None)
        return self

    def call(self, method: str, *arrays):
        _send_message(
            self._sock, {"method": method}, [array_to_bytes(a) for a in arrays]
        )
        header, blobs = _recv_message(self._sock)
        if not header.get("ok", True):
            raise RuntimeError(header.get("error", "rpc error"))
        if "scalar" in header:
            return header["scalar"]
        return bytes_to_numpy(blobs[0]) if blobs else None

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *arrays: self.call(name, *arrays)

    def close(self) -> None:
        if self._sock is not None:
            try:
                _send_message(self._sock, {"method": "__shutdown__"}, [])
                _recv_message(self._sock)
            except (ConnectionError, OSError):
                pass
            self._sock.close()
