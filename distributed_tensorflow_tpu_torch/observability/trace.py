"""Structured trace spans (port of ``observability/trace.py``): a
monotonic-clock JSONL event timeline.

A span is one named region of host-side work — ``compile``,
``chunk_dispatch``, ``materialize``, ``checkpoint``, ``eval`` are the
Trainer's vocabulary — recorded as one JSONL event at span exit:

    {"schema_version": 1, "event": "span", "name": "chunk_dispatch",
     "t": <monotonic start>, "dur_s": 0.0021, "run": "r-1a2b3c",
     "host": "gpu-host-0", "pid": 12345, "process": 0, ...attrs}

plus ``event``/``gauge``/``counter`` instants with the same envelope.
Timestamps are ``time.monotonic()`` — orderable within a run, immune to
wall-clock steps; each record also carries run/host/process ids so the
timelines of many ranks can be merged and disentangled.  The envelope,
the in-memory aggregates, ``overhead_s``, ``stats()`` and
``span_summary()`` are the JAX tracer's, so its offline reader
(``analyze.py``) reads this file.

Two design points keep this zero-downshift:

* Emission is an ``AsyncJsonlSink.write`` (one queue put) — and when no
  ``path`` is configured the tracer still aggregates per-name
  count/total/max in memory (two ``perf_counter`` calls and a dict update
  per span), which is what the end-of-run report reads.  The Trainer's
  spans are per *chunk*, not per step, so even the file-backed cost is
  amortized k×.
* Where the JAX tracer enters a ``jax.profiler.TraceAnnotation``, each
  span here enters ``torch.profiler.record_function`` with the same name
  (so a ``--profile-dir`` trace, ``utils/metrics.profile``, carries the
  span names beside the kernels) and, once CUDA is initialised, an NVTX
  range (``torch.cuda.nvtx.range_start/end``, for an Nsight timeline).
  Both are host calls: a span around a chunk that a CUDA graph captures
  or replays adds nothing to the graph.

``NULL_TRACER`` is the do-nothing default: callers instrument
unconditionally and pay nothing when observability is off.

The tracer also tracks its own cost (``overhead_s``): time spent inside
span bookkeeping and event emission, surfaced by the run report so the
"telemetry within 5% of telemetry-off" budget is measured, not assumed.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Iterator

import torch

from distributed_tensorflow_tpu_torch.observability.sink import AsyncJsonlSink


class _NullTracer:
    """Inert tracer: the default for uninstrumented runs.  Every method is
    a no-op; ``span`` yields immediately."""

    enabled = False
    overhead_s = 0.0

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[None]:
        yield

    def event(self, name: str, **fields: Any) -> None:
        pass

    def gauge(self, name: str, value: float, **fields: Any) -> None:
        pass

    def counter(self, name: str, inc: int = 1, **fields: Any) -> None:
        pass

    def span_summary(self) -> dict:
        return {}

    def stats(self) -> dict:
        return {}

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL_TRACER = _NullTracer()


@contextlib.contextmanager
def _profiler_annotation(name: str) -> Iterator[None]:
    """The span's name as a ``torch.profiler.record_function`` region and,
    once CUDA is initialised, an NVTX range.  The range is a start/end
    pair, not a push/pop: the serving scheduler's request and decode spans
    end in finishing order, not nested.  Never initialises CUDA itself
    (``is_initialized``, not ``is_available``)."""
    rid = (torch.cuda.nvtx.range_start(name)
           if torch.cuda.is_initialized() else None)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if rid is not None:
            torch.cuda.nvtx.range_end(rid)


class Tracer:
    """Span/event recorder (see module docstring).

    ``path=None`` → aggregate-only: spans update the in-memory per-name
    summary (for the run report) but no file is written.  ``annotate``
    mirrors span names into a profiler trace and NVTX.
    """

    enabled = True

    def __init__(self, path: str | Path | None = None,
                 run_id: str | None = None, process_index: int = 0,
                 annotate: bool = True, sink: AsyncJsonlSink | None = None):
        self.run_id = run_id or f"r-{uuid.uuid4().hex[:8]}"
        self.host = socket.gethostname()
        self.pid = os.getpid()
        self.process_index = process_index
        self.overhead_s = 0.0
        self._annotate = annotate
        self._sink = sink if sink is not None else (
            AsyncJsonlSink(path) if path else None)
        # per-name aggregates: name -> [count, total_s, max_s].  The
        # read-modify-write updates are lock-guarded: the checkpoint
        # writer thread records ckpt_write spans while the training
        # thread records its own, and concurrent span exits would
        # otherwise lose counts (the JSONL sink is queue-based and
        # already thread-safe)
        self._agg_lock = threading.Lock()
        self._spans: dict[str, list] = {}
        self._counters: dict[str, int] = {}
        if self._sink is not None:
            self.event("trace_start", wall_time=time.time())

    # ------------------------------------------------------------ emission
    def _emit(self, record: dict[str, Any]) -> None:
        if self._sink is not None:
            self._sink.write({
                **record,
                "run": self.run_id, "host": self.host, "pid": self.pid,
                "process": self.process_index,
            })

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[dict]:
        """Time a named region; one JSONL event at exit, plus the in-memory
        aggregate the run report reads.  Yields the span's attr dict —
        keys added to it BEFORE exit ride the emitted record, which is how
        the serving scheduler attaches per-request phase attribution
        (queue_wait_s/prefill_s/decode_s) computed only at finish."""
        t_mono = time.monotonic()
        t0 = time.perf_counter()
        ctx = _profiler_annotation(name) if self._annotate \
            else contextlib.nullcontext()
        with ctx:
            try:
                yield attrs
            finally:
                dur = time.perf_counter() - t0
                t_book = time.perf_counter()
                with self._agg_lock:
                    agg = self._spans.setdefault(name, [0, 0.0, 0.0])
                    agg[0] += 1
                    agg[1] += dur
                    agg[2] = max(agg[2], dur)
                self._emit({"event": "span", "name": name, "t": t_mono,
                            "dur_s": dur, **attrs})
                self.overhead_s += time.perf_counter() - t_book

    def event(self, name: str, **fields: Any) -> None:
        t0 = time.perf_counter()
        self._emit({"event": "event", "name": name, "t": time.monotonic(),
                    **fields})
        self.overhead_s += time.perf_counter() - t0

    def gauge(self, name: str, value: float, **fields: Any) -> None:
        t0 = time.perf_counter()
        self._emit({"event": "gauge", "name": name, "t": time.monotonic(),
                    "value": value, **fields})
        self.overhead_s += time.perf_counter() - t0

    def counter(self, name: str, inc: int = 1, **fields: Any) -> None:
        t0 = time.perf_counter()
        with self._agg_lock:
            self._counters[name] = total = \
                self._counters.get(name, 0) + inc
        self._emit({"event": "counter", "name": name, "t": time.monotonic(),
                    "inc": inc, "total": total, **fields})
        self.overhead_s += time.perf_counter() - t0

    # ------------------------------------------------------------- summary
    def span_summary(self) -> dict[str, dict[str, float]]:
        """Per-name {count, total_s, max_s} — the run report's span table."""
        return {name: {"count": c, "total_s": tot, "max_s": mx}
                for name, (c, tot, mx) in sorted(self._spans.items())}

    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = {"overhead_s": self.overhead_s,
                               "counters": dict(self._counters)}
        if self._sink is not None:
            out.update(self._sink.stats())
        return out

    def flush(self) -> None:
        """Drain the queued records to disk without closing the sink —
        the Trainer's failure-path cleanup calls this so no buffered span
        outlives a raising fit."""
        if self._sink is not None:
            self._sink.flush()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
