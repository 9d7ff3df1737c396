"""Length-prefixed socket framing (port of ``utils/wire.py``).

The reference frames every message as a 4-byte big-endian length plus a
payload (reference centralized/network.py:4-28).  Tensors never travel
over sockets here (``torch.distributed`` owns the data plane): this module
serves the supervisor channel (``utils/supervisor.py``) and any external
tool speaking the reference's protocol.  The bytes on the socket equal the
JAX package's.

Framing is Python only: the JAX package sends through its native library
when it loads (``_native_for``), with the same bytes; the port has no
native path.

Payloads are JSON by default.  Pickle decode of incoming data is opt-in
(``allow_pickle=True``) because unpickling untrusted bytes runs code.
"""

from __future__ import annotations

import json
import pickle
import socket
import struct
from typing import Any

_LEN = struct.Struct(">I")  # 4-byte big-endian length


def send_bytes(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_bytes(sock: socket.socket) -> bytes | None:
    header = recvall(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    return recvall(sock, n)


def recvall(sock: socket.socket, n: int) -> bytes | None:
    """Blocking read of exactly n bytes; None on an orderly close."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def send_msg(sock: socket.socket, obj: Any, *, use_pickle: bool = False) -> None:
    data = pickle.dumps(obj, -1) if use_pickle else json.dumps(obj).encode()
    send_bytes(sock, data)


def recv_msg(sock: socket.socket, *, allow_pickle: bool = False) -> Any | None:
    data = recv_bytes(sock)
    if data is None:
        return None
    if allow_pickle:
        try:
            return json.loads(data)
        except (UnicodeDecodeError, json.JSONDecodeError):
            return pickle.loads(data)
    return json.loads(data)
