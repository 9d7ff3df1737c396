"""Streaming log-bucketed histograms: online percentiles without samples.

The serving engine needs p50/p95/**p99** of TTFT/ITL/queue-wait computed
*online* — "millions of users" means millions of latency observations, and
storing every sample to sort at the end is exactly the accounting that
stops scaling first.  :class:`LogHistogram` is the standard fix (HDR-
histogram / Prometheus-style): a **fixed geometric bucket ladder** —
bucket ``i`` covers ``(min · g^i, min · g^(i+1)]`` — so

* ``record`` is O(1): one ``log``, one dict increment, no allocation
  proportional to the data;
* any quantile is exact to within ONE bucket's relative width
  (``growth − 1``, 5% by default) — the error bound is a *configuration
  constant*, not a property of the data;
* two histograms with the same ladder **merge by adding counts** —
  windows merge into runs, and per-replica histograms will merge into
  fleet totals (ROADMAP item 2) without resampling.

The bucket EDGES are a pure function of ``(min_value, growth,
max_value)``, so merge compatibility is checkable and serialization
(``to_dict``/``from_dict``) carries only the sparse nonzero counts.
Global min/max are tracked exactly and quantiles clamp into ``[min, max]``
— a point-mass distribution reports its exact value, and the extreme
quantiles of small samples cannot overshoot the data.

:class:`MetricsRegistry` is the named-histogram front the scheduler
records into (``registry.record("ttft", 0.042)``); its ``snapshot()`` is
the JSON-ready summary table and ``merge`` composes registries window by
window.  Deliberately stdlib-only (math) — the offline ``analyze`` CLI
and pure-host tests import this without jax.
"""

from __future__ import annotations

import math
from typing import Any, Iterable


def exact_percentile(vals: Iterable[float], q: float) -> float | None:
    """Linear-interpolated percentile over stored samples — the stdlib
    reference path every histogram quantile is tested against, and the
    one summary surfaces keep using for per-window stored samples."""
    vals = list(vals)
    if not vals:
        return None
    s = sorted(vals)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


class LogHistogram:
    """Fixed-geometric-bucket streaming histogram (module docstring).

    ``min_value``/``max_value`` bound the resolved range: values at or
    below ``min_value`` count in an underflow bucket, values above
    ``max_value`` in an overflow bucket — both still exact in ``count``/
    ``sum``/``min``/``max``, and quantiles landing there report the
    tracked exact extremes, never a fabricated in-range value."""

    def __init__(self, min_value: float = 1e-6, growth: float = 1.05,
                 max_value: float = 3600.0):
        if not (min_value > 0 and max_value > min_value):
            raise ValueError(
                f"need 0 < min_value < max_value, got "
                f"({min_value}, {max_value})")
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.min_value = float(min_value)
        self.growth = float(growth)
        self.max_value = float(max_value)
        self._log_g = math.log(self.growth)
        # fixed ladder: bucket count derives from the config alone, so two
        # same-config histograms are index-aligned by construction
        self.n_buckets = int(math.ceil(
            math.log(self.max_value / self.min_value) / self._log_g))
        self.counts: dict[int, int] = {}   # sparse: bucket index -> count
        self.underflow = 0
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None

    # ------------------------------------------------------------- record
    def record(self, value: float) -> None:
        """O(1): one log + one dict increment."""
        v = float(value)
        self.count += 1
        self.sum += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        if v <= self.min_value:
            self.underflow += 1
        elif v > self.max_value:
            self.overflow += 1
        else:
            i = int(math.log(v / self.min_value) / self._log_g)
            # float rounding can land exactly-on-edge values one bucket
            # high/low; clamp into the ladder and nudge down when v sits
            # at or below the bucket's lower edge
            i = min(max(i, 0), self.n_buckets - 1)
            if v <= self.min_value * self.growth ** i:
                i = max(i - 1, 0)
            self.counts[i] = self.counts.get(i, 0) + 1

    # ---------------------------------------------------------- quantiles
    @property
    def relative_width(self) -> float:
        """One bucket's relative width — THE quantile error bound."""
        return self.growth - 1.0

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile: the upper edge of the bucket holding the
        ``ceil(q·count)``-th observation, clamped into the exact observed
        [min, max].  Within ``relative_width`` of the true sample
        quantile by construction."""
        if not self.count:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        rank = max(1, math.ceil(q * self.count))
        seen = self.underflow
        if rank <= seen:
            return self.vmin  # everything down here is <= min_value
        for i in sorted(self.counts):
            seen += self.counts[i]
            if rank <= seen:
                edge = self.min_value * self.growth ** (i + 1)
                return min(max(edge, self.vmin), self.vmax)
        return self.vmax  # overflow bucket: the tracked exact maximum

    def summary(self) -> dict[str, Any]:
        """JSON-ready digest — the snapshot row the serve section carries."""
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": (self.sum / self.count) if self.count else None,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "relative_width": self.relative_width,
        }

    # ------------------------------------------------------------- merge
    def _config(self) -> tuple[float, float, float]:
        return (self.min_value, self.growth, self.max_value)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Add ``other``'s counts into this histogram.  Ladders must be
        identical — merged quantiles are then EXACTLY what record-all
        would have produced (the merge-equivalence test pins this)."""
        if self._config() != other._config():
            raise ValueError(
                f"cannot merge histograms with different bucket ladders: "
                f"{self._config()} vs {other._config()}")
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c
        self.underflow += other.underflow
        self.overflow += other.overflow
        self.count += other.count
        self.sum += other.sum
        for v in (other.vmin, other.vmax):
            if v is not None:
                self.vmin = v if self.vmin is None else min(self.vmin, v)
                self.vmax = v if self.vmax is None else max(self.vmax, v)
        return self

    # ----------------------------------------------------------- serialize
    def to_dict(self) -> dict[str, Any]:
        return {
            "min_value": self.min_value,
            "growth": self.growth,
            "max_value": self.max_value,
            "counts": {str(i): c for i, c in sorted(self.counts.items())},
            "underflow": self.underflow,
            "overflow": self.overflow,
            "count": self.count,
            "sum": self.sum,
            "vmin": self.vmin,
            "vmax": self.vmax,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LogHistogram":
        h = cls(min_value=d["min_value"], growth=d["growth"],
                max_value=d["max_value"])
        h.counts = {int(i): int(c) for i, c in d.get("counts", {}).items()}
        h.underflow = int(d.get("underflow", 0))
        h.overflow = int(d.get("overflow", 0))
        h.count = int(d.get("count", 0))
        h.sum = float(d.get("sum", 0.0))
        h.vmin = d.get("vmin")
        h.vmax = d.get("vmax")
        return h


class MetricsRegistry:
    """Named LogHistograms sharing one default ladder.

    The scheduler records phase observations by name (``ttft``, ``itl``,
    ``queue_wait``, ``prefill``, ``queue_depth``); ``snapshot()`` is the
    summary table and ``merge`` folds one registry into another — the
    per-window → per-run → per-fleet aggregation path."""

    def __init__(self, min_value: float = 1e-6, growth: float = 1.05,
                 max_value: float = 3600.0):
        self._default = (min_value, growth, max_value)
        self._hists: dict[str, LogHistogram] = {}

    def histogram(self, name: str, **kwargs: float) -> LogHistogram:
        """Get-or-create; per-histogram ladder overrides apply only at
        creation (a later conflicting override is ignored — the ladder is
        fixed for the histogram's lifetime by design)."""
        h = self._hists.get(name)
        if h is None:
            mn, g, mx = self._default
            h = LogHistogram(min_value=kwargs.get("min_value", mn),
                             growth=kwargs.get("growth", g),
                             max_value=kwargs.get("max_value", mx))
            self._hists[name] = h
        return h

    def record(self, name: str, value: float) -> None:
        self.histogram(name).record(value)

    def names(self) -> list[str]:
        return sorted(self._hists)

    def snapshot(self) -> dict[str, dict[str, Any]]:
        return {name: h.summary() for name, h in sorted(self._hists.items())}

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for name, h in other._hists.items():
            if name in self._hists:
                self._hists[name].merge(h)
            else:
                self._hists[name] = LogHistogram.from_dict(h.to_dict())
        return self

    def to_dict(self) -> dict[str, Any]:
        return {name: h.to_dict() for name, h in sorted(self._hists.items())}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MetricsRegistry":
        reg = cls()
        for name, hd in d.items():
            reg._hists[name] = LogHistogram.from_dict(hd)
        return reg
