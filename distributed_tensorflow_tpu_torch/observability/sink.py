"""Async JSONL sink: bounded queue + background writer thread (a copy of
the JAX package's stdlib-only ``observability/sink.py``, so the port
imports nothing of that package).

Telemetry's cardinal rule here is *zero downshift*: emitting a record must
never put the host on the device's critical path.  A synchronous
``open(...).write`` per record (the old MetricsLogger) costs a syscall and
— on a network filesystem — an unbounded stall inside the step loop.  This
sink moves the I/O to a daemon thread behind a bounded queue:

* ``write(record)`` is one ``Queue.put_nowait`` — O(µs), never blocks.
* When the queue is full the record is DROPPED and counted
  (``dropped``), never buffered unboundedly and never back-pressured
  into the training loop.  The drop counter is reported in the run
  report, so a lossy capture is visible, not silent.
* The file is opened line-buffered and every record is written as ONE
  ``write`` call of a complete ``json.dumps(...) + "\\n"`` line, flushed
  per line — a SIGKILLed run leaves only whole JSON lines behind
  (crash-durability is tested in tests/test_torch_observability.py).
* ``close()`` drains what was queued, flushes, and closes the file.

Every record carries ``schema_version`` so downstream readers can evolve.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from pathlib import Path
from typing import Any

# bump when a record's field semantics change (readers key on this)
SCHEMA_VERSION = 1

_CLOSE = object()  # queue sentinel: drain-and-exit


class AsyncJsonlSink:
    """Bounded-queue background JSONL writer (see module docstring).

    ``maxsize`` bounds the host memory a stalled filesystem can consume;
    at the default 8192 records (~100 B each) that is under a megabyte.
    ``start=False`` keeps the writer thread unstarted (tests exercise the
    overflow path deterministically this way); ``close()`` then drains
    synchronously.
    """

    def __init__(self, path: str | Path, maxsize: int = 8192,
                 start: bool = True):
        self.path = Path(path)
        self.dropped = 0
        self.written = 0
        self.enqueued = 0
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._f = open(self.path, "a", buffering=1)  # line-buffered
        self._lock = threading.Lock()  # close() vs writer-thread teardown
        self._closed = False
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._drain_forever,
                name=f"jsonl-sink:{self.path.name}", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ producer
    def write(self, record: dict[str, Any]) -> bool:
        """Enqueue one record; returns False (and counts a drop) when the
        queue is full or the sink is closed.  ``schema_version`` is stamped
        here so every durable line carries it regardless of caller."""
        if self._closed:
            self.dropped += 1
            return False
        rec = {"schema_version": SCHEMA_VERSION, **record}
        try:
            self._q.put_nowait(rec)
            self.enqueued += 1
            return True
        except queue.Full:
            self.dropped += 1
            return False

    # ------------------------------------------------------------ consumer
    def _write_line(self, rec: dict) -> None:
        # ONE write call per complete line: with line buffering the flush
        # happens at the newline, so a kill between records never leaves a
        # partial line (the crash-durability contract)
        self._f.write(json.dumps(rec) + "\n")
        self.written += 1

    def _drain_forever(self) -> None:
        while True:
            rec = self._q.get()
            if rec is _CLOSE:
                return
            with self._lock:
                if self._f.closed:
                    return
                self._write_line(rec)

    def _drain_unstarted(self) -> None:
        """No writer thread (``start=False``): drain synchronously."""
        while True:
            try:
                rec = self._q.get_nowait()
            except queue.Empty:
                return
            if rec is not _CLOSE:
                self._write_line(rec)

    def flush(self, timeout: float = 5.0) -> None:
        """Best-effort wait until everything ACCEPTED so far is on disk —
        the wait target is the written count, not queue emptiness (the
        writer dequeues a record before it hits the file, so an empty
        queue does not mean the last record landed)."""
        if self._thread is None:
            self._drain_unstarted()
        target = self.enqueued
        deadline = time.monotonic() + timeout
        while self.written < target and time.monotonic() < deadline:
            time.sleep(0.005)
        if self._lock.acquire(timeout=timeout):
            try:
                if not self._f.closed:
                    self._f.flush()
            finally:
                self._lock.release()

    def close(self, timeout: float = 5.0) -> None:
        """Drain queued records, flush, close the file.  Idempotent, and
        BOUNDED even when the writer thread is wedged mid-write on a hung
        filesystem (lock acquires time out rather than block — the
        harness's watchdog-abort path calls this on its way to
        ``os._exit`` and must never hang on the stall it is escaping)."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            try:
                self._q.put(_CLOSE, timeout=timeout)
            except queue.Full:  # pragma: no cover - writer wedged
                pass
            self._thread.join(timeout=timeout)
        else:
            self._drain_unstarted()
        if self._lock.acquire(timeout=timeout):
            try:
                if not self._f.closed:
                    self._f.flush()
                    self._f.close()
            finally:
                self._lock.release()

    def stats(self) -> dict[str, int]:
        return {"written": self.written, "dropped": self.dropped}

    def __enter__(self) -> "AsyncJsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - GC-timing safety net
        try:
            self.close(timeout=0.5)
        except Exception:
            pass
