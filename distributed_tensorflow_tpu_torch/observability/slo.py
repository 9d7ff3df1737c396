"""SLO-aware goodput accounting for the serving engine (port of
``observability/slo.py``, copied unchanged but for the import of
``metrics``).

The headline serving number is NOT median latency at one arrival rate —
MLPerf's measurement discipline (Mattson et al., arXiv:1910.01500) and
Sarathi-Serve's goodput framing (Agrawal et al., arXiv:2403.02310) both
define it as **requests/sec that meet the latency target**: a request
counts only when its TTFT *and* its inter-token latency are inside the
SLO, and a shed (429'd) request never counts, however fast the rejection
was.  :class:`SLOMonitor` is that definition as an online accumulator —
one ``observe`` per completed request, one ``shed`` per rejected one, a
``summary`` per window — so ``bench.py --serve --sweep`` can walk the
arrival-rate ladder and report ``serve_max_goodput_under_slo`` as the
number a capacity plan can actually be written against.

Per-request ITL is judged at a percentile of that request's own gaps
(p99 by default): a stream that stalls once near the end failed its
reader even if the mean gap was fine.  BASELINE.md "Goodput accounting"
carries the comparison rules (state the SLO with the number; shed ≠
goodput; p99 claims need the sample count).

Stdlib-only, like the rest of the offline-readable observability layer.
"""

from __future__ import annotations

from typing import Any, Iterable

from distributed_tensorflow_tpu_torch.observability.metrics import (
    exact_percentile)


class SLOMonitor:
    """Online goodput-under-SLO accumulator (module docstring).

    ``ttft_s``/``itl_s`` are the latency targets in clock units;
    ``quantile`` is the per-request ITL percentile judged against
    ``itl_s`` (0.99 = the p99-ITL convention).  One monitor measures one
    window; ``reset()`` rearms it for the next."""

    def __init__(self, ttft_s: float, itl_s: float,
                 quantile: float = 0.99):
        if ttft_s <= 0 or itl_s <= 0:
            raise ValueError(
                f"SLO targets must be positive, got ttft_s={ttft_s}, "
                f"itl_s={itl_s}")
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {quantile}")
        self.ttft_s = float(ttft_s)
        self.itl_s = float(itl_s)
        self.quantile = float(quantile)
        self.reset()

    def reset(self) -> None:
        self.requests = 0
        self.good_requests = 0
        self.shed_requests = 0
        self.ttft_misses = 0
        self.itl_misses = 0

    # ------------------------------------------------------------ observe
    def observe(self, ttft_s: float, itl_gaps: Iterable[float]) -> bool:
        """Account one COMPLETED request; returns whether it met the SLO
        (TTFT within target AND the request's own ITL ``quantile`` within
        target — a single-token request has no gaps and passes ITL
        trivially)."""
        self.requests += 1
        itl_stat = exact_percentile(itl_gaps, self.quantile)
        ttft_ok = ttft_s <= self.ttft_s
        itl_ok = itl_stat is None or itl_stat <= self.itl_s
        if not ttft_ok:
            self.ttft_misses += 1
        if not itl_ok:
            self.itl_misses += 1
        good = ttft_ok and itl_ok
        self.good_requests += good
        return good

    def shed(self, n: int = 1) -> None:
        """Account ``n`` shed (429'd) requests: offered load that is by
        definition NOT goodput."""
        self.shed_requests += int(n)

    # ------------------------------------------------------------ summary
    def summary(self, elapsed_s: float | None = None) -> dict[str, Any]:
        """The window's SLO section.  ``goodput_requests_per_sec`` needs
        the window's elapsed time; with zero completed requests the
        attainment is None (no claim, not a perfect score) and goodput is
        0.0 when time passed, None when it did not."""
        attainment = (self.good_requests / self.requests
                      if self.requests else None)
        goodput = None
        if elapsed_s is not None and elapsed_s > 0:
            goodput = self.good_requests / elapsed_s
        return {
            "slo_ttft_s": self.ttft_s,
            "slo_itl_s": self.itl_s,
            "quantile": self.quantile,
            "requests": self.requests,
            "good_requests": self.good_requests,
            "shed_requests": self.shed_requests,
            "ttft_misses": self.ttft_misses,
            "itl_misses": self.itl_misses,
            "slo_attainment": attainment,
            "goodput_requests_per_sec": goodput,
        }
