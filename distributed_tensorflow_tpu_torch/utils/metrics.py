"""Metrics, step timing, and profiling (port of ``utils/metrics.py``).

``StepTimer`` and ``MetricsLogger`` are the JAX module's stdlib-only
classes, copied so the port imports nothing of that package: step-time
percentiles with the first-call costs split out, and per-step metric
records behind the async crash-durable JSONL sink
(``observability/sink.py``).  ``profile`` is a ``torch.profiler`` window
over CPU and CUDA activities, its Chrome trace written into a directory,
where JAX's opens ``jax.profiler.trace``; the window is an ``xprof`` span
on the tracer (JAX's name, one vocabulary for both tools) and the
tracer's spans inside it appear in the trace as ``record_function``
regions.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path
from typing import Any, Iterator

from distributed_tensorflow_tpu_torch.observability.sink import (
    SCHEMA_VERSION, AsyncJsonlSink)


class StepTimer:
    """Wall-clock per-step timing with percentile summary.

    ``compile_steps`` is how many leading entries carry first-call costs
    (in the port: the first step's cuBLAS/allocator warm-up and kernel
    library load); the steady percentiles skip them.
    """

    def __init__(self):
        self.times: list[float] = []
        self.compile_steps = 1
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None
        return False

    def summary(self) -> dict[str, float | None]:
        if not self.times:
            return {}
        xs = sorted(self.times)
        n = len(xs)
        pick = lambda q, s: s[min(len(s) - 1, int(q * len(s)))]  # noqa: E731
        c = min(max(self.compile_steps, 1), n)
        # a run that never left the first-call prefix has no steady state
        steady = self.times[c:]
        steady_sorted = sorted(steady)
        return {
            "steps": n,
            "total_s": sum(self.times),
            "first_step_s": self.times[0],
            "compile_s": sum(self.times[:c]),
            "steady_mean_s": (sum(steady) / len(steady)) if steady else None,
            "steady_p50_s": pick(0.50, steady_sorted) if steady else None,
            "steady_p95_s": pick(0.95, steady_sorted) if steady else None,
            "p50_s": pick(0.50, xs),
            "p90_s": pick(0.90, xs),
            "p95_s": pick(0.95, xs),
            "p99_s": pick(0.99, xs),
        }


class MetricsLogger:
    """Per-step metrics sink (compose with utils.supervisor.ResultSink for
    run-level events).

    Records are kept in memory (``records``) and — when ``path`` is given —
    written as JSONL through an :class:`AsyncJsonlSink`: one bounded-queue
    put per record on the caller's thread, a background thread doing the
    line-buffered I/O.  Because emission never blocks, the Trainer keeps
    its ``steps_per_call`` chunking with a metrics logger attached (no
    downshift): per-step records ride the chunk's stacked trajectory and
    are logged at chunk flush, step-exact and bitwise identical to k=1
    (tests/test_torch_observability.py).

    Crash durability: every line is complete-or-absent (the sink writes
    one flushed line per record), every record carries ``schema_version``,
    and ``close()`` drains and flushes.  ``overhead_s`` accumulates this
    logger's own host cost for the run report's telemetry budget.
    """

    def __init__(self, path: str | Path | None = None, log_every: int = 1,
                 queue_size: int = 8192):
        self.path = Path(path) if path else None
        self.log_every = log_every
        self.records: list[dict] = []
        self.overhead_s = 0.0
        self._sink = (AsyncJsonlSink(self.path, maxsize=queue_size)
                      if self.path else None)

    def should_log(self, step: int) -> bool:
        """Single home of the throttle policy — callers that must avoid even
        *computing* metric values (host-device sync) check this first."""
        return not self.log_every or step % self.log_every == 0

    def log(self, step: int, **metrics: Any) -> None:
        """Record one step's metrics.  ``time`` is the wall clock AT LOG
        TIME: under a chunked drain (``steps_per_call=k``) a chunk's k
        records are logged in one burst at chunk flush, so ``time`` marks
        the flush, not the step — derive per-step timing from the run
        report's step_time percentiles (or the trace spans), never from
        gaps between metric records.  The metric VALUES are step-exact
        and k-invariant (tests/test_torch_observability.py)."""
        if not self.should_log(step):
            return
        t0 = time.perf_counter()
        rec = {"schema_version": SCHEMA_VERSION, "step": step,
               "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self.records.append(rec)
        if self._sink is not None:
            self._sink.write(rec)
        self.overhead_s += time.perf_counter() - t0

    @property
    def dropped(self) -> int:
        """Records the bounded queue had to drop (0 without a file sink)."""
        return self._sink.dropped if self._sink is not None else 0

    def stats(self) -> dict[str, int]:
        out = {"records": len(self.records), "dropped": self.dropped}
        if self._sink is not None:
            out["written"] = self._sink.written
        return out

    def flush(self) -> None:
        if self._sink is not None:
            self._sink.flush()

    def close(self) -> None:
        """Drain + flush the async sink (flush-on-close contract)."""
        if self._sink is not None:
            self._sink.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@contextlib.contextmanager
def profile(trace_dir: str | Path | None, tracer=None) -> Iterator[None]:
    """A ``torch.profiler`` window over CPU activity (and CUDA activity
    where a card is present), its Chrome trace written on exit as
    ``<trace_dir>/<host>_<pid>.pt.trace.json`` (Perfetto or
    ``chrome://tracing`` open it).  No-op when trace_dir is None.
    ``tracer``, when given, records the window as an ``xprof`` span, so
    the span timeline and the profile cover the same region under the
    same name; the tracer's spans inside the window are
    ``record_function`` regions of the trace, beside the kernels."""
    if trace_dir is None:
        yield
        return
    import torch

    from distributed_tensorflow_tpu_torch.observability.trace import (
        NULL_TRACER)

    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t = tracer if tracer is not None else NULL_TRACER
    with t.span("xprof", trace_dir=str(trace_dir)):
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(
            str(out / f"{socket.gethostname()}_{os.getpid()}.pt.trace.json"))
