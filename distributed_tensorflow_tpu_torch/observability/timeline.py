"""Time-series telemetry: bounded gauge ring buffers + a throttled sampler
(a copy of the JAX package's stdlib-only ``observability/timeline.py``,
its percentile from the port's copy of ``observability/metrics.py``).

ROADMAP item 2 (queue-driven autoscaling) needs the signals the serving
stack already computes — queue depth, active slots, KV blocks in use,
per-replica load — as *time series*, not end-of-window scalars.
:class:`GaugeSeries` is the storage: a **bounded ring buffer** of
``(t_mono, wall, value)`` samples —

* ``record`` is O(1): one list write at a rotating index, no allocation
  after warm-up and no growth proportional to run length;
* exact totals ride alongside (count/sum/min/max over EVERY sample ever
  recorded, like ``LogHistogram``), so the retained window never lies
  about the extremes;
* two series **merge by time order** — ``merge`` produces exactly what
  one series recording both sample streams would hold (the
  merge≡record-all law the tests pin), so per-replica series fold into
  fleet series without resampling;
* ``to_dict``/``from_dict`` round-trip the full state.

:class:`Timeline` is the named-series front callers sample into at
existing chunk/iteration boundaries (``tl.sample_many({...})``), with a
**per-series minimum interval** (the ``--timeline-interval`` cadence) so
a tight decode loop costs one ``monotonic()`` call per skipped sample,
and a self-measured ``overhead_s`` so the "< 1% of run wall time" budget
is measured, not assumed.  Flag-off is ``timeline=None`` at every call
site — no wrapper, no branch cost beyond one ``is not None``.

``emit(tracer)`` writes each series as ONE ``timeline_series`` JSONL
event (bulk samples, not a record per sample), which is how
``analyze timeline`` and the Perfetto counter-track export work from the
trace file alone.  Deliberately stdlib-only (math/time) — the offline
``analyze`` CLI and pure-host tests import this without torch.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Iterable, Mapping

from distributed_tensorflow_tpu_torch.observability.metrics import exact_percentile


class GaugeSeries:
    """Bounded ring buffer of ``(t_mono, wall, value)`` gauge samples
    (module docstring).  ``capacity`` bounds retained samples; exact
    count/sum/min/max cover every sample ever recorded."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._buf: list[tuple[float, float, float] | None] = \
            [None] * self.capacity
        self._head = 0          # next write index
        self._n = 0             # retained samples (<= capacity)
        self.count = 0          # every sample ever recorded
        self.sum = 0.0
        self.vmin: float | None = None
        self.vmax: float | None = None

    # ------------------------------------------------------------- record
    def record(self, value: float, t_mono: float | None = None,
               wall: float | None = None) -> None:
        """O(1): one ring write + four scalar updates.  ``t_mono``/``wall``
        default to now — passing them lets a sampler batch one clock read
        across many series."""
        t = time.monotonic() if t_mono is None else float(t_mono)
        w = time.time() if wall is None else float(wall)
        v = float(value)
        self._buf[self._head] = (t, w, v)
        self._head = (self._head + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)
        self.count += 1
        self.sum += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    @property
    def dropped(self) -> int:
        """Samples overwritten by the ring bound (count − retained)."""
        return self.count - self._n

    def samples(self) -> list[tuple[float, float, float]]:
        """Retained samples in recording order (oldest first)."""
        if self._n < self.capacity:
            return [s for s in self._buf[:self._n]]
        return [s for s in (self._buf[self._head:] + self._buf[:self._head])]

    def values(self) -> list[float]:
        return [s[2] for s in self.samples()]

    # ------------------------------------------------------------- merge
    def merge(self, other: "GaugeSeries") -> "GaugeSeries":
        """Fold ``other`` into this series: retained samples interleave by
        monotonic time and the most recent ``capacity`` survive — EXACTLY
        what one series recording both streams in time order would hold
        (the merge≡record-all test pins this).  Exact totals add."""
        merged = sorted(self.samples() + other.samples(), key=lambda s: s[0])
        keep = merged[-self.capacity:]
        self._buf = keep + [None] * (self.capacity - len(keep))
        self._head = len(keep) % self.capacity
        self._n = len(keep)
        self.count += other.count
        self.sum += other.sum
        for v in (other.vmin, other.vmax):
            if v is not None:
                self.vmin = v if self.vmin is None else min(self.vmin, v)
                self.vmax = v if self.vmax is None else max(self.vmax, v)
        return self

    # ----------------------------------------------------------- analysis
    def auc(self) -> float | None:
        """Trapezoidal value·seconds over the retained window — the
        ``queue_depth_auc`` integral (requests·s of queueing the
        autoscaler minimizes).  None until two samples exist."""
        s = self.samples()
        if len(s) < 2:
            return None
        return sum((s[i + 1][0] - s[i][0]) * (s[i][2] + s[i + 1][2]) / 2.0
                   for i in range(len(s) - 1))

    def summary(self) -> dict[str, Any]:
        """JSON-ready digest: exact totals + retained-window stats."""
        vals = self.values()
        s = self.samples()
        return {
            "count": self.count,
            "retained": self._n,
            "dropped": self.dropped,
            "mean": (self.sum / self.count) if self.count else None,
            "min": self.vmin,
            "max": self.vmax,
            "last": vals[-1] if vals else None,
            "p50": exact_percentile(vals, 0.50),
            "p95": exact_percentile(vals, 0.95),
            "auc": self.auc(),
            "duration_s": (s[-1][0] - s[0][0]) if len(s) > 1 else 0.0,
        }

    # ----------------------------------------------------------- serialize
    def to_dict(self) -> dict[str, Any]:
        return {
            "capacity": self.capacity,
            "samples": [list(s) for s in self.samples()],
            "count": self.count,
            "sum": self.sum,
            "vmin": self.vmin,
            "vmax": self.vmax,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "GaugeSeries":
        g = cls(capacity=int(d["capacity"]))
        for t, w, v in d.get("samples", []):
            g._buf[g._head] = (float(t), float(w), float(v))
            g._head = (g._head + 1) % g.capacity
            g._n = min(g._n + 1, g.capacity)
        g.count = int(d.get("count", g._n))
        g.sum = float(d.get("sum", 0.0))
        g.vmin = d.get("vmin")
        g.vmax = d.get("vmax")
        return g


def _series_key(name: str, replica: int | None) -> str:
    return name if replica is None else f"{name}@r{replica}"


def split_series_key(key: str) -> tuple[str, int | None]:
    """Inverse of the ``name@rN`` per-replica key convention (the analyze
    CLI groups per-replica lanes with this)."""
    if "@r" in key:
        name, _, rid = key.rpartition("@r")
        if rid.isdigit():
            return name, int(rid)
    return key, None


class Timeline:
    """Named gauge series + the throttled sampling front (module
    docstring).  One Timeline instance spans a run; providers from many
    components (scheduler, fleet, kv, trainer) sample into it, with
    per-replica series keyed ``name@rN``."""

    def __init__(self, interval_s: float = 0.05, capacity: int = 512,
                 clock: Callable[[], float] | None = None):
        if interval_s < 0:
            raise ValueError(
                f"interval_s must be >= 0, got {interval_s}")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.overhead_s = 0.0   # self-measured sampler bookkeeping cost
        self._mono = clock if clock is not None else time.monotonic
        self._series: dict[str, GaugeSeries] = {}
        self._last_t: dict[str, float] = {}   # per throttle group

    # ------------------------------------------------------------ sampling
    def series(self, name: str, replica: int | None = None) -> GaugeSeries:
        key = _series_key(name, replica)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = GaugeSeries(capacity=self.capacity)
        return s

    def sample(self, name: str, value: float,
               replica: int | None = None) -> bool:
        """Throttled single-gauge sample; returns whether it recorded."""
        return self.sample_many({name: value}, replica=replica,
                                group=_series_key(name, replica))

    def sample_many(self, values: Mapping[str, float],
                    replica: int | None = None,
                    group: str = "") -> bool:
        """Record a batch of gauges sharing ONE clock read and ONE
        throttle decision (``group`` names the throttle bucket — each
        call site is its own bucket by default).  The skip path is the
        hot path: one ``monotonic()`` call and a dict lookup."""
        t = self._mono()
        gkey = group or (f"@r{replica}" if replica is not None else "")
        last = self._last_t.get(gkey)
        if last is not None and (t - last) < self.interval_s:
            return False
        t0 = time.perf_counter()
        self._last_t[gkey] = t
        wall = time.time()
        for name, value in values.items():
            if value is None:
                continue
            self.series(name, replica).record(value, t_mono=t, wall=wall)
        self.overhead_s += time.perf_counter() - t0
        return True

    # ------------------------------------------------------------ analysis
    def names(self) -> list[str]:
        return sorted(self._series)

    def summary(self) -> dict[str, dict[str, Any]]:
        return {k: s.summary() for k, s in sorted(self._series.items())}

    def stat(self, name: str, field: str,
             replica: int | None = None) -> Any:
        """One summary field of one series, None when the series does not
        exist — the run-report/bench key accessor."""
        s = self._series.get(_series_key(name, replica))
        return s.summary().get(field) if s is not None else None

    def merge(self, other: "Timeline") -> "Timeline":
        for key, s in other._series.items():
            mine = self._series.get(key)
            if mine is None:
                self._series[key] = GaugeSeries.from_dict(s.to_dict())
            else:
                mine.merge(s)
        self.overhead_s += other.overhead_s
        return self

    # ------------------------------------------------------------ emission
    def emit(self, tracer) -> None:
        """Write every series as one bulk ``timeline_series`` trace event
        (+ one ``timeline_overhead`` event), so ``analyze timeline`` and
        the Perfetto counter-track export work from the trace file alone.
        Emission happens ONCE at window end — the sampling hot path never
        touches the sink."""
        for key, s in sorted(self._series.items()):
            name, replica = split_series_key(key)
            # the exact totals ride along so the offline reconstruction
            # (analyze timeline → GaugeSeries.from_dict) is lossless even
            # when the ring dropped samples
            tracer.event("timeline_series", series=name, replica=replica,
                         capacity=s.capacity, dropped=s.dropped,
                         count=s.count, sum=s.sum, vmin=s.vmin,
                         vmax=s.vmax,
                         samples=[list(x) for x in s.samples()])
        tracer.event("timeline_overhead", overhead_s=self.overhead_s,
                     series=len(self._series))

    # ----------------------------------------------------------- serialize
    def to_dict(self) -> dict[str, Any]:
        return {
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "overhead_s": self.overhead_s,
            "series": {k: s.to_dict()
                       for k, s in sorted(self._series.items())},
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Timeline":
        tl = cls(interval_s=float(d.get("interval_s", 0.05)),
                 capacity=int(d.get("capacity", 512)))
        tl.overhead_s = float(d.get("overhead_s", 0.0))
        tl._series = {k: GaugeSeries.from_dict(sd)
                      for k, sd in d.get("series", {}).items()}
        return tl


# ---------------------------------------------------------------- rendering
_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: Iterable[float], width: int = 60) -> str:
    """Stdlib text sparkline: values bucketed to ``width`` columns, each
    column the mean of its bucket, scaled into 8 glyph levels.  The
    ``analyze timeline`` renderer — no plotting dependency."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        # bucket-mean downsample so spikes within a bucket still move it
        out = []
        for i in range(width):
            lo = i * len(vals) // width
            hi = max((i + 1) * len(vals) // width, lo + 1)
            out.append(sum(vals[lo:hi]) / (hi - lo))
        vals = out
    vmin, vmax = min(vals), max(vals)
    span = vmax - vmin
    if span <= 0 or not math.isfinite(span):
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[min(int((v - vmin) / span * (len(_SPARK) - 1) + 0.5),
                   len(_SPARK) - 1)]
        for v in vals)
