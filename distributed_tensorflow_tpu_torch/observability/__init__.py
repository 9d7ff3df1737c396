"""Observability (port of ``distributed_tensorflow_tpu.observability``).

``metrics`` and ``slo`` are the JAX package's stdlib-only histogram and
goodput modules, and ``report`` holds its ``serve_section``, copied
unchanged so the port imports nothing of that package.  ``trace`` holds
only the inert ``NULL_TRACER`` so far; the span tracer with NVTX ranges is
later work (ROADMAP Queue 1).
"""

from distributed_tensorflow_tpu_torch.observability.metrics import (  # noqa: F401
    LogHistogram, MetricsRegistry, exact_percentile)
from distributed_tensorflow_tpu_torch.observability.report import (  # noqa: F401
    serve_section)
from distributed_tensorflow_tpu_torch.observability.slo import (  # noqa: F401
    SLOMonitor)
from distributed_tensorflow_tpu_torch.observability.trace import (  # noqa: F401
    NULL_TRACER)
