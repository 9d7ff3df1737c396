"""Observability (port of ``distributed_tensorflow_tpu.observability``).

  sink     — AsyncJsonlSink: background writer thread over a bounded
             queue (drop counter on overflow), line-buffered JSONL so a
             killed run leaves only whole lines (a copy of the JAX
             module).
  trace    — Tracer: the structured span/event timeline (monotonic clock,
             run/host/process ids, in-memory span aggregates), each span
             also a ``torch.profiler.record_function`` region and an NVTX
             range; ``NULL_TRACER`` the inert default.
  report   — ``build_run_report``, the end-of-run summary with the JAX
             report's keys, ``runtime_environment`` (torch, CUDA, NCCL,
             the card and its power limit) and ``serve_section``.
  timeline — GaugeSeries / Timeline / sparkline: bounded-ring gauge series
             sampled at existing loop boundaries (a copy of the JAX
             module).
  metrics  — LogHistogram / MetricsRegistry (a copy of the JAX module).
  slo      — SLOMonitor, goodput under the SLO (a copy of the JAX module).

The per-step health stats (ROADMAP Queue 1 item 9b, health) and the
roofline, the compile/memory ledger and the offline analyzer (item 9c)
are not ported yet.
"""

from distributed_tensorflow_tpu_torch.observability.metrics import (  # noqa: F401
    LogHistogram, MetricsRegistry, exact_percentile)
from distributed_tensorflow_tpu_torch.observability.report import (  # noqa: F401
    build_run_report, runtime_environment, serve_section)
from distributed_tensorflow_tpu_torch.observability.sink import (  # noqa: F401
    SCHEMA_VERSION, AsyncJsonlSink)
from distributed_tensorflow_tpu_torch.observability.slo import (  # noqa: F401
    SLOMonitor)
from distributed_tensorflow_tpu_torch.observability.timeline import (  # noqa: F401
    GaugeSeries, Timeline, sparkline)
from distributed_tensorflow_tpu_torch.observability.trace import (  # noqa: F401
    NULL_TRACER, Tracer)
