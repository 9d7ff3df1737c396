"""Failure detection and crash recovery (port of ``utils/failure.py``,
stdlib only: the JAX module imports no JAX, and the port keeps its own
copy of it).

The reference has NO failure handling — a dead worker deadlocks the rest at
the fixed-size barrier and the server thread spins forever on a closed
connection (reference server.py:132-134, 151; SURVEY.md §5 "Failure
detection: NO (and buggy)").  The only resilience is the client's
connect-retry loop (reference client.py:56-62).

Here the failure modes are (a) the numeric kind, a diverged/NaN loss;
(b) the stall kind, a step that never completes (hung collective, wedged
runtime); and (c) the crash kind, the process dying.  This module covers all three:

  check_finite   — divergence detection on materialized metrics
  Watchdog       — wall-clock stall detector around the step loop
  run_with_recovery — restart-from-latest-checkpoint crash recovery loop
                   (pairs with utils/checkpoint.py, the durable-state story
                   the reference lacks entirely)
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable


class TrainingDiverged(RuntimeError):
    """Loss/metric became NaN or infinite."""


class AnomalyDetected(TrainingDiverged):
    """The health layer's ``--on-anomaly halt`` policy fired: a per-step
    health stat (observability/health.py) crossed its threshold or went
    non-finite.  Subclasses TrainingDiverged so ``run_with_recovery``
    refuses to restart into the same divergence."""


class StallDetected(RuntimeError):
    """No step completed within the watchdog timeout."""


def check_finite(metrics: dict[str, float], step: int | None = None) -> None:
    """Raise TrainingDiverged if any materialized metric is NaN/inf.

    Call sites pass metrics that are already host floats (the Trainer only
    materializes on its logging cadence), so this adds no device sync.
    """
    for k, v in metrics.items():
        if not math.isfinite(v):
            at = f" at step {step}" if step is not None else ""
            raise TrainingDiverged(f"metric '{k}' is {v}{at}")


class Watchdog:
    """Detects a stalled training loop: ``beat()`` as the loop makes
    progress; if no beat arrives within ``timeout`` seconds the
    ``on_stall`` callback fires from the monitor thread (once per stall
    episode — it re-arms when beats resume, so a transient pause that
    recovers does not poison the rest of the run).

    ``check()`` raises StallDetected from the calling thread only while a
    stall is CURRENTLY in progress (beat age > timeout at call time); a
    recovered episode never raises.  A training thread wedged inside a hung
    collective can't raise for itself — for that case the on_stall callback
    (e.g. the harness's 'stall' event emission) is the detection signal.

    Contrast: the reference cannot detect a stall at all — a single dead
    worker leaves every other thread waiting in Barrier.wait forever
    (reference server.py:151, 90-96).
    """

    def __init__(self, timeout: float = 120.0,
                 on_stall: Callable[[float], Any] | None = None,
                 poll_interval: float | None = None,
                 arm_on_first_beat: bool = True):
        self.timeout = timeout
        self.base_timeout = timeout   # per-step budget (rescale() reference)
        self.on_stall = on_stall
        self.stalled = False          # live view: currently in a stall?
        self.stall_episodes = 0
        self.stall_elapsed = 0.0      # beat age when the episode fired
        self.beats = 0                # heartbeat count (run-report gauge)
        # arm_on_first_beat: don't count the window before the first beat —
        # the first chunk's kernel builds, warm-up and CUDA-graph capture
        # can exceed any sane stall timeout and would fire a false
        # episode.  Tradeoff: a hang during that first chunk goes
        # undetected.
        self._last = None if arm_on_first_beat else time.monotonic()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poll = poll_interval if poll_interval is not None \
            else max(0.05, timeout / 10.0)
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self.beats += 1

    def rescale(self, steps_per_beat: int) -> None:
        """Adapt the stall budget to a chunked step loop: with
        ``steps_per_call = k`` the Trainer beats once per CHUNK dispatch
        and once per chunk flush (the host sync), so the per-step
        ``base_timeout`` becomes a per-beat budget of ``k × base_timeout``
        (dispatches are bounded by the in-flight window, so a hung device
        still stops the beats within it).  This is what lets the
        watchdog ride the multi-step scan drain instead of forcing
        ``steps_per_call`` down to 1 — stall detection resolution coarsens
        k×, which is the honest price of k× fewer host syncs."""
        if steps_per_beat < 1:
            raise ValueError(
                f"steps_per_beat must be >= 1, got {steps_per_beat}")
        with self._lock:
            self.timeout = self.base_timeout * steps_per_beat

    def _beat_age(self) -> float:
        with self._lock:
            if self._last is None:  # not armed yet (no first beat)
                return 0.0
            return time.monotonic() - self._last

    def check(self) -> None:
        """Raise StallDetected if a stall is in progress right now."""
        age = self._beat_age()
        if age > self.timeout:
            raise StallDetected(
                f"no progress beat for {age:.1f}s (timeout {self.timeout}s)")

    def _monitor(self) -> None:
        while not self._stop.wait(self._poll):
            elapsed = self._beat_age()
            if elapsed > self.timeout:
                if not self.stalled:  # fire once per episode
                    self.stalled = True
                    self.stall_episodes += 1
                    self.stall_elapsed = elapsed
                    if self.on_stall is not None:
                        self.on_stall(elapsed)
            else:
                self.stalled = False  # beats resumed: re-arm

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_with_recovery(config, max_restarts: int = 2,
                      run_fn: Callable | None = None,
                      on_restart: Callable[[int, BaseException], Any] | None = None,
                      ) -> dict[str, Any]:
    """Run an experiment, restarting from the latest checkpoint on crash.

    Requires ``config.checkpoint_dir`` (with ``checkpoint_every`` for
    intra-run durability).  After a failure the config is re-run with
    ``resume=True`` AND ``elastic_restore=True``: the restart goes through
    the elastic restore (``elastic/reshard.py``) rather than a cold
    ``restore()`` — onto any rank count for the engines whose ranks hold
    one state, continuing the exact batch sequence from the
    checkpoint's data state (exactly-once over the dataset), with the
    crash's cost reported as ``preemption_lost_s``/``resume_replay_steps``
    in the resumed run's report.  Up to ``max_restarts`` retries, then the
    last exception propagates.  Divergence (TrainingDiverged) is NOT
    retried — restarting into the same NaN is not recovery.

    ``run_fn`` is injectable for tests; defaults to harness.run.  Under
    ``cli -n N`` with N > 1 the CLI passes a ``run_fn`` that spawns the N
    ranks: a crashed rank leaves its peers inside a collective, and a
    process group cannot be re-created inside a rank after a peer died,
    so the whole spawn is relaunched (cli.py ``_spawn``).
    """
    import dataclasses

    if run_fn is None:
        from distributed_tensorflow_tpu_torch.utils.harness import (
            run as run_fn)
    if max_restarts > 0 and not config.checkpoint_dir:
        raise ValueError("run_with_recovery needs config.checkpoint_dir to "
                         "have anything to recover from")
    attempt = 0
    while True:
        try:
            summary = run_fn(config)
            if attempt:
                summary = dict(summary)
                summary["restarts"] = attempt
            return summary
        except TrainingDiverged:
            raise
        except Exception as e:  # noqa: BLE001 — any crash is restartable
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            config = dataclasses.replace(config, resume=True,
                                         elastic_restore=True)
