"""Straggler/stall detection: step-time outliers as structured events (a
copy of the JAX package's stdlib-only ``elastic/stragglers.py``).

The watchdog (utils/failure.py) catches the binary failure — no progress
at all within a timeout.  Stragglers are the gray zone underneath it: a
chunk that completed but took several times the typical step time (a
contended host, a thermally throttled chip, a slow NFS checkpoint volume
bleeding into the dispatch path).  On a lock-step SPMD program ONE slow
participant sets the pace for everyone, so sustained outliers are the
first observable symptom of a degrading lease — worth surfacing before
the watchdog's hard timeout ever fires.

:class:`StragglerDetector` rides the measurements the Trainer already
makes (the per-chunk step-time averages feeding ``StepTimer``, the same
cadence as the Watchdog's beats): each observation is compared against
the running median of a bounded window, and an outlier beyond
``factor``× the median emits a structured ``straggler`` event on the
trace timeline (the same stream the anomaly/stall events use —
``analyze spans`` and the Perfetto export pick it up unchanged).  The
outlier still enters the window, so a NEW sustained pace stops flagging
once the median catches up — a permanently slower mesh is the new
normal, not an endless alarm.
"""

from __future__ import annotations

import collections
import statistics
from typing import Any


class StragglerDetector:
    """Running-median outlier detector over per-step wall times.

    ``observe(step, step_time_s)`` returns True (and emits a
    ``straggler`` trace event when a tracer is wired) iff at least
    ``min_samples`` observations preceded this one and it exceeds
    ``factor`` × their median.  Pure host-side arithmetic on numbers the
    Trainer already holds — zero device syncs, zero downshift.
    """

    def __init__(self, tracer=None, factor: float = 3.0,
                 min_samples: int = 5, window: int = 64):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        if min_samples < 2:
            raise ValueError(f"min_samples must be >= 2, got {min_samples}")
        self.tracer = tracer
        self.factor = float(factor)
        self.min_samples = int(min_samples)
        self._times: collections.deque = collections.deque(maxlen=window)
        self.observed = 0
        self.events = 0
        self.max_ratio = 0.0
        self.last_straggler_step: int | None = None

    def observe(self, step: int, step_time_s: float) -> bool:
        flagged = False
        if len(self._times) >= self.min_samples:
            median = statistics.median(self._times)
            if median > 0.0 and step_time_s > self.factor * median:
                flagged = True
                self.events += 1
                self.max_ratio = max(self.max_ratio, step_time_s / median)
                self.last_straggler_step = step
                if self.tracer is not None:
                    self.tracer.event(
                        "straggler", step=step,
                        step_time_s=step_time_s, median_s=median,
                        ratio=step_time_s / median, factor=self.factor)
        self._times.append(step_time_s)
        self.observed += 1
        return flagged

    def report(self) -> dict[str, Any]:
        """The ``stragglers`` section of the fit result / run report."""
        return {
            "events": self.events,
            "observed": self.observed,
            "max_ratio": round(self.max_ratio, 4) if self.events else None,
            "last_straggler_step": self.last_straggler_step,
            "factor": self.factor,
        }
