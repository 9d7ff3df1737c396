"""End-of-run report (port of ``observability/report.py``): the serve
section only.

``serve_section`` is the JAX package's stdlib-only function, copied
unchanged so the port imports nothing of that package.  The rest of the
module (``build_run_report``, ``runtime_environment``) is later work
(ROADMAP Queue 1: rest of observability).
"""

from __future__ import annotations

from typing import Any


def serve_section(summary: dict[str, Any] | None,
                  n_devices: int = 1, tracer=None) -> dict[str, Any] | None:
    """Normalize a ContinuousBatcher summary into the run-report/bench
    ``serve`` section: the per-request result objects are dropped (the
    section must stay JSON), and the per-chip rates — requests/sec (the
    round-7 headline) and goodput-under-SLO (the round-13 one, mirroring
    examples_per_sec_per_device) — are derived here so every surface
    divides by the same device count.  ``tracer`` (when enabled) adds the
    serve window's telemetry self-accounting — sink drop counter + span
    bookkeeping overhead, previously train-report-only — gated
    lower-is-better by `analyze diff`."""
    if summary is None:
        return None
    sec = {k: v for k, v in summary.items() if k != "results"}
    for key in ("serve_requests_per_sec", "serve_goodput_under_slo"):
        v = sec.get(key)
        sec[f"{key}_per_chip"] = (
            v / n_devices if isinstance(v, (int, float)) and n_devices
            else None)
    if tracer is not None and getattr(tracer, "enabled", False):
        tstats = tracer.stats()
        sec["serve_sink_dropped"] = tstats.get("dropped")
        sec["serve_sink_written"] = tstats.get("written")
        sec["serve_trace_overhead_s"] = tstats.get("overhead_s", 0.0)
    return sec
