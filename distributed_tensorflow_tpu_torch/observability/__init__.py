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
  health   — HealthConfig and the on-device capture of the per-step health
             stats (grad, param and update norms, their ratio, the
             non-finite count, the loss spike) and ``detect_anomalies``.
  roofline — GPTCostModel, the H100's peak table (``device_peaks``) and
             ``Roofline``: MFU/MBU of training and serving.
  xla_stats — ProgramLedger: the CUDA-graph captures, kernel builds and
             first KV-table calls of a run, with their seconds and memory.
  analyze  — the offline CLI over the files a run writes (a copy of the
             JAX module): ``python -m
             distributed_tensorflow_tpu_torch.observability.analyze``.
"""

from distributed_tensorflow_tpu_torch.observability.health import (  # noqa: F401
    HealthConfig)
from distributed_tensorflow_tpu_torch.observability.metrics import (  # noqa: F401
    LogHistogram, MetricsRegistry, exact_percentile)
from distributed_tensorflow_tpu_torch.observability.report import (  # noqa: F401
    build_run_report, runtime_environment, serve_section)
from distributed_tensorflow_tpu_torch.observability.roofline import (  # noqa: F401
    PEAK_TABLE_REVISION, DevicePeaks, GPTCostModel, Roofline, device_peaks,
    program_attribution)
from distributed_tensorflow_tpu_torch.observability.sink import (  # noqa: F401
    SCHEMA_VERSION, AsyncJsonlSink)
from distributed_tensorflow_tpu_torch.observability.slo import (  # noqa: F401
    SLOMonitor)
from distributed_tensorflow_tpu_torch.observability.timeline import (  # noqa: F401
    GaugeSeries, Timeline, sparkline)
from distributed_tensorflow_tpu_torch.observability.trace import (  # noqa: F401
    NULL_TRACER, Tracer)
from distributed_tensorflow_tpu_torch.observability.xla_stats import (  # noqa: F401
    ProgramLedger, diff_manifests)

__all__ = [
    "AsyncJsonlSink",
    "DevicePeaks",
    "GPTCostModel",
    "GaugeSeries",
    "HealthConfig",
    "LogHistogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "PEAK_TABLE_REVISION",
    "ProgramLedger",
    "Roofline",
    "SCHEMA_VERSION",
    "SLOMonitor",
    "Timeline",
    "Tracer",
    "build_run_report",
    "device_peaks",
    "diff_manifests",
    "program_attribution",
    "runtime_environment",
    "serve_section",
    "sparkline",
    "exact_percentile",
]
