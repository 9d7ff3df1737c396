"""Step timing (port of ``StepTimer`` from ``utils/metrics.py``, which is
stdlib-only; copied so the port imports nothing of the JAX package).

``MetricsLogger`` and the profiler hook are later work (ROADMAP Queue 1,
rest of observability).
"""

from __future__ import annotations

import time


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
