"""Graceful lease drain: preemption as a planned exit, not a corpse (a copy
of the JAX package's stdlib-only ``elastic/lease.py``).

Production leases of accelerators end two ways — a preemption notice
(SIGTERM from the scheduler, typically ~30 s before the kill) or a budget
("this reservation is ours for N steps' worth of wall time").  Both map
to the same drain: finish the in-flight chunk, write a final async
checkpoint (with its data state), drain the writer, and return a result
whose ``preempted`` field names why — the harness then emits a
structured ``preempted`` run-report section and exits cleanly, so the
relaunch (``--elastic-restore``) continues the run exactly where the
lease ended.

:class:`LeaseManager` packages both triggers behind the ONE hook
``Trainer.fit`` checks at chunk boundaries (``should_stop``): a signal
handler that flips a flag (signal-safe: the handler does nothing but
assign) and a per-lease step budget (``--max-steps-per-lease``).  The
drain composes with ``steps_per_call > 1`` by construction — the hook is
only consulted where boundary state exists, so a preemption notice
mid-chunk lets the chunk finish (seconds) rather than abandoning it.
"""

from __future__ import annotations

import signal
import threading
from typing import Any


def _signal_name(signum: int | None) -> str | None:
    """Human name of a signal number ('SIGTERM'); the raw number as a
    string for values the platform's Signals enum does not know."""
    if signum is None:
        return None
    try:
        return signal.Signals(signum).name
    except ValueError:
        return str(signum)


class LeaseManager:
    """SIGTERM/step-budget preemption trigger for ``Trainer.fit``'s
    ``should_stop`` hook.

    ``install()`` arms the signal handlers (main thread only — Python
    restricts ``signal.signal`` to it; elsewhere the manager degrades to
    the step budget alone and says so in ``report()``), saving the
    previous dispositions for ``uninstall()``.  The handler only sets a
    flag: the actual drain happens on the training thread at the next
    chunk boundary, where a consistent boundary state exists to
    checkpoint.
    """

    def __init__(self, max_steps_per_lease: int = 0,
                 signals: tuple[int, ...] = (signal.SIGTERM,)):
        if max_steps_per_lease < 0:
            raise ValueError(
                f"max_steps_per_lease must be >= 0 (0 disables the step "
                f"budget), got {max_steps_per_lease}")
        self.max_steps_per_lease = int(max_steps_per_lease)
        self._signals = tuple(signals)
        self._prev: dict[int, Any] = {}
        self.installed = False
        self.was_installed = False  # sticky: survives uninstall(), so a
        # report() taken after the run's teardown still records that the
        # handler WAS armed while training ran
        self.preempt_signal: int | None = None
        # programmatic trigger (serving/fleet.py replica drain, tests):
        # same contract as the signal flag — one assignment under a lock,
        # read at the consumer's next boundary.  The lock matters for
        # trigger/reset pairs racing across threads (a fleet coordinator
        # triggering while a replica worker resets after its drain), not
        # for the flag read itself.
        self._trigger_lock = threading.Lock()
        self.trigger_reason: str | None = None

    # ----------------------------------------------------------- signals
    def _on_signal(self, signum, frame) -> None:  # noqa: ARG002
        # async-signal-safe by doing nothing but an assignment; the
        # training thread reads the flag at its next boundary
        self.preempt_signal = signum

    def install(self) -> "LeaseManager":
        if threading.current_thread() is not threading.main_thread():
            return self  # step budget still works; report() records it
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self.installed = True
            self.was_installed = True
        except (ValueError, OSError):  # embedded interpreters etc.
            self.installed = False
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self.installed = False

    def __enter__(self) -> "LeaseManager":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -------------------------------------------------------------- hook
    def trigger(self, reason: str) -> None:
        """Programmatic preemption: flip the drain flag as if a notice
        arrived, without a real signal — the fleet supervisor's
        replica-drain path (serving/fleet.py weight hot-swap) and tests
        use this instead of delivering SIGTERM to the whole process.
        Thread-safe; the first reason wins until ``reset_trigger``."""
        if not reason:
            raise ValueError("trigger needs a non-empty reason string")
        with self._trigger_lock:
            if self.trigger_reason is None:
                self.trigger_reason = str(reason)

    def reset_trigger(self) -> None:
        """Re-arm after a programmatic drain completed (a swapped replica
        resumes serving on the same lease).  Only clears the programmatic
        flag — a real preemption signal stays sticky: the process is
        still going away, and un-noticing it would serve requests into
        the kill."""
        with self._trigger_lock:
            self.trigger_reason = None

    def should_stop(self, steps_done: int) -> str | None:
        """The ``Trainer.fit(should_stop=)`` hook: a reason string when
        the lease is over (preemption notice received, programmatic
        ``trigger``, or ``steps_done`` this fit reached the per-lease
        budget), else None."""
        if self.preempt_signal is not None:
            return f"signal:{_signal_name(self.preempt_signal)}"
        if self.trigger_reason is not None:
            return self.trigger_reason
        if (self.max_steps_per_lease
                and steps_done >= self.max_steps_per_lease):
            return f"max_steps_per_lease:{self.max_steps_per_lease}"
        return None

    def report(self) -> dict[str, Any]:
        """Run-report fodder: what the lease was armed with and whether a
        preemption notice arrived."""
        return {
            "max_steps_per_lease": self.max_steps_per_lease or None,
            "signal_handler_installed": self.was_installed,
            "preempt_signal": _signal_name(self.preempt_signal),
            "triggered": self.trigger_reason,
        }
