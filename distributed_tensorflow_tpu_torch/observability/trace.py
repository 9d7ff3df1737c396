"""Trace spans (port of ``observability/trace.py``): the inert tracer only.

``NULL_TRACER`` has the JAX package's tracer interface and records
nothing, so callers instrument unconditionally and pay nothing.  The
JSONL span tracer, with NVTX ranges in place of the profiler annotations,
is later work (ROADMAP Queue 1).
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator


class _NullTracer:
    """Inert tracer: every method is a no-op; ``span`` yields at once."""

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
