"""Supervisor / result reporting (port of ``utils/supervisor.py``).

The reference reports run results over an out-of-band TCP channel on port
4000 with three message shapes: ``'start'``, ``('done', elapsed)`` and
``('results', accuracy)`` (reference server.py:121-124, 182-187).  Here
the primary sink is JSON lines (file and/or stdout), plus an optional
socket client that sends the reference's event sequence, and a listener
for tests.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from pathlib import Path
from typing import Any

from distributed_tensorflow_tpu_torch.utils import wire


class ResultSink:
    """JSONL event sink; every event gets a wall timestamp."""

    def __init__(self, path: str | Path | None = None, echo: bool = False,
                 supervisor_address: str | None = None,
                 supervisor_port: int = 4000):
        self.path = Path(path) if path else None
        self.echo = echo
        self._events: list[dict] = []
        self._sock: socket.socket | None = None
        if supervisor_address:
            # 'host' or 'host:port'; a bare host keeps port 4000
            host, _, port = supervisor_address.partition(":")
            self._sock = socket.create_connection(
                (host, int(port) if port else supervisor_port), timeout=10)

    def emit(self, event: str, **fields: Any) -> dict:
        rec = {"event": event, "time": time.time(), **fields}
        self._events.append(rec)
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line)
        return rec

    # reference-protocol event triple ------------------------------------
    def start(self) -> None:
        self.emit("start")
        if self._sock:
            wire.send_msg(self._sock, "start")

    def done(self, elapsed: float) -> None:
        self.emit("done", elapsed=elapsed)
        if self._sock:
            wire.send_msg(self._sock, ["done", elapsed])

    def results(self, accuracy: float, **extra: Any) -> None:
        self.emit("results", accuracy=accuracy, **extra)
        if self._sock:
            wire.send_msg(self._sock, ["results", accuracy])

    def close(self) -> None:
        if self._sock:
            self._sock.close()
            self._sock = None

    @property
    def events(self) -> list[dict]:
        return list(self._events)


class SupervisorListener:
    """Listener accepting one reporter connection: the counterpart the
    reference assumes on port 4000."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self.messages: list[Any] = []
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        try:
            conn, _ = self._srv.accept()
            while True:
                msg = wire.recv_msg(conn)
                if msg is None:
                    break
                self.messages.append(msg)
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        self._srv.close()
        self._thread.join(timeout=2)
