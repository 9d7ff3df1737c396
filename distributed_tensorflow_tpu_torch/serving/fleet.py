"""Fault-tolerant serving fleet (port of ``serving/fleet.py``, its replica
layer): supervised replicas with no-loss failover.

* :class:`ReplicaSet` runs N ``ContinuousBatcher`` replicas, each with its
  own ``SlotKVCache``, behind a least-loaded front-end router.  With a
  ``WallClock`` every replica serves on its own thread; with a
  ``VirtualClock`` the supervisor drives the replicas in id order, so a
  chaos schedule is exact and repeatable.
* The :class:`RequestJournal` records every request's replica assignment
  and every token delivered.  When a replica fails (an exception out of
  its run loop, a watchdog stall, an injected fault) its queued and
  in-flight requests are requeued to the survivors with bounded retry and
  backoff, and the journal's assignment fence makes delivery exactly
  once: an emission is accepted only from the request's current replica.
  A retried request resumes by re-prefilling its prompt and the prefix it
  had delivered (greedy decode makes the continuation exact); its TTFT
  stays charged from the original arrival.
* :class:`FaultInjector` is the seeded test substrate: a crash at the
  k-th decode iteration, prefill program or verify (before its commit), a
  stall, and nonfinite logits modelled as an out-of-range token id, which
  the fleet's per-token host check rejects before the journal sees it.
* Graceful drain and weight hot swap: each replica carries a
  ``LeaseManager`` whose ``trigger`` drains it (stop admitting, finish in
  flight), after which ``SlotKVCache.swap_params`` installs the new
  weights.  Replicas swap one at a time, so the fleet never drops below
  N−1 admitting replicas; ``swap_generations`` counts whole-fleet swaps.
* The summary carries a ``serve_fleet`` section (replicas, failovers,
  retries, requeued requests, duplicate emissions, swap generations,
  per-replica and merged goodput) and the two gated keys
  ``serve_failover_recovery_p95_s`` and ``serve_duplicate_emissions``;
  the per-replica histograms merge by ``MetricsRegistry.merge``.

Differences from the JAX fleet, all about the card:

* A swap writes the new weights into the table's own model in place (a
  captured decode round replays the addresses it captured, so it never
  recaptures), where JAX rebinds one table's params.  So each replica
  owns its own copy of the model (``build_replica_kvs`` deep-copies it):
  with shared parameters, replica 0's swap would reach replica 1 in the
  middle of its decode, under KV written with the old weights.
* On the card each replica serves on its own ``torch.cuda.Stream``,
  entered by whichever thread drives it, so one replica's host syncs
  (stream or event syncs, never a device-wide one) do not wait on
  another's kernels.  A swap copies on the replica's stream, after an
  event that ``schedule_swap`` records on its caller's stream, so new
  weights still being computed there are read only once written.
* With ``multi_step`` every replica's fused rounds (and its draft's, at
  every width a verify round can ask of it) are run and captured at
  construction, in replica order (``SlotKVCache.prepare_round``): no
  capture happens once the replicas serve, so no thread captures while
  another launches (a capture synchronizes the device, empties the
  allocator's cache and uses the one capture stream every capture shares),
  and the launch counters a capture sets back stay exact.

Disaggregated prefill and decode (``roles``, the KV handoff, the
journal's per-role phase and transfers), affinity routing, autoscale and
``parallel_lanes`` are not ported yet and raise ``NotImplementedError``
(ROADMAP Queue 1, item 10b).  As in JAX, ``arm``
does not wrap ``dispatch_multi``: a fused round is no fault site.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import not_ported
from distributed_tensorflow_tpu_torch.elastic.lease import LeaseManager
from distributed_tensorflow_tpu_torch.observability.metrics import (
    MetricsRegistry, exact_percentile)
from distributed_tensorflow_tpu_torch.observability.trace import NULL_TRACER
from distributed_tensorflow_tpu_torch.serving.kv_cache import SlotKVCache
from distributed_tensorflow_tpu_torch.serving.scheduler import (
    DISAGG_ITEM, ContinuousBatcher, Request, RequestQueue, RequestResult,
    VirtualClock, WallClock)


class InjectedFault(RuntimeError):
    """A FaultInjector fired: the replica's run loop dies here exactly the
    way an un-injected bug would — the supervisor must not special-case
    it (the whole point of injection is exercising the real path)."""


class CorruptionDetected(RuntimeError):
    """The fleet's cheap per-token host check rejected an emission (token
    id out of [0, vocab) — what nonfinite logits degrade sampling into).
    Raised BEFORE the journal records anything, so a corrupt token is
    never delivered; the replica fails over like any other death."""


# ------------------------------------------------------------ fault specs

_FAULT_KINDS = ("crash", "stall", "nanlogits")
_FAULT_SITES = ("decode", "prefill", "verify", "handoff")


@dataclasses.dataclass
class FaultSpec:
    """One seeded fault: ``kind`` at the ``at``-th ``site`` event on
    ``replica`` (1-based count of decode iterations / prefill programs /
    verify steps on that replica), or Bernoulli per event with ``prob``
    under the injector's seed.  ``stall_s`` is the stall duration."""

    kind: str
    replica: int
    site: str = "decode"
    at: int = 0
    prob: float = 0.0
    stall_s: float = 0.0

    def __post_init__(self):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {_FAULT_KINDS}, "
                             f"got '{self.kind}'")
        if self.site not in _FAULT_SITES:
            raise ValueError(f"fault site must be one of {_FAULT_SITES}, "
                             f"got '{self.site}'")
        if self.replica < 0:
            raise ValueError(f"fault replica must be >= 0, "
                             f"got {self.replica}")
        if (self.at <= 0) == (self.prob <= 0.0):
            raise ValueError(
                "a fault needs exactly one trigger: at=K (the K-th site "
                "event) or prob=P (seeded Bernoulli per event); got "
                f"at={self.at}, prob={self.prob}")
        if self.kind == "stall" and self.stall_s <= 0:
            raise ValueError("stall faults need stall_s > 0")
        if self.site != "decode" and self.kind != "crash":
            raise ValueError(
                f"site '{self.site}' supports crash only (stall/nanlogits "
                f"model decode-path failures)")


class FaultInjector:
    """Seeded fault injection over a replica's SlotKVCache entry points.

    ``spec`` is a list of :class:`FaultSpec` or the CLI string grammar
    (``--serve-fault-spec``)::

        kind:key=val,key=val[;kind:...]

    e.g. ``crash:replica=0,iter=3`` (crash replica 0's 3rd decode
    iteration — a speculative verify round counts as one iteration),
    ``crash:replica=1,prefill=2`` (during its 2nd prefill program),
    ``crash:replica=0,verify=1`` (after the verify computed, before any
    commit), ``crash:replica=0,handoff=1`` (inside a disaggregated
    prefill replica's KV extract; the port's tables have none yet),
    ``stall:replica=1,iter=2,stall_s=0.5``, ``nanlogits:replica=0,iter=4``,
    ``crash:replica=0,prob=0.05`` (seeded Bernoulli per iteration).

    ``arm(replica_id, kv)`` wraps the instance's ``advance`` /
    ``insert``+``prefill_chunk`` / ``verify_block`` methods (and
    ``extract_handoff`` where the table has it); every firing is recorded
    in ``fired`` with its site count.  One-shot per spec.
    """

    def __init__(self, spec: str | Iterable[FaultSpec], seed: int = 0):
        self.specs = (self.parse(spec) if isinstance(spec, str)
                      else list(spec))
        self._rng = np.random.default_rng(seed)
        self.seed = int(seed)
        self.fired: list[dict[str, Any]] = []
        self._done: set[int] = set()   # indices of one-shot specs fired

    @staticmethod
    def parse(spec: str) -> list[FaultSpec]:
        """CLI grammar → FaultSpec list (raises ValueError on any typo —
        the harness validates this pre-train, like every other serve
        flag)."""
        out: list[FaultSpec] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            kind, colon, body = part.partition(":")
            kind = kind.strip()
            if not colon or kind not in _FAULT_KINDS:
                raise ValueError(
                    f"--serve-fault-spec entries are 'kind:key=val,...' "
                    f"with kind in {_FAULT_KINDS}; got '{part}'")
            kw: dict[str, Any] = {"kind": kind, "replica": -1}
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue
                key, eq, val = item.partition("=")
                key = key.strip()
                val = val.strip()
                if not eq:
                    raise ValueError(
                        f"--serve-fault-spec items must be key=val, got "
                        f"'{item}'")
                try:
                    if key == "replica":
                        kw["replica"] = int(val)
                    elif key in ("iter", "prefill", "verify", "handoff"):
                        site = "decode" if key == "iter" else key
                        kw["site"], kw["at"] = site, int(val)
                    elif key == "prob":
                        kw["prob"] = float(val)
                    elif key == "stall_s":
                        kw["stall_s"] = float(val)
                    else:
                        raise ValueError(
                            f"unknown --serve-fault-spec key '{key}' "
                            f"(replica/iter/prefill/verify/handoff/prob/"
                            f"stall_s)")
                except ValueError as e:
                    if "fault-spec" in str(e):
                        raise
                    raise ValueError(
                        f"--serve-fault-spec value for '{key}' must be "
                        f"numeric, got '{val}'") from None
            if kw["replica"] < 0:
                raise ValueError(
                    f"--serve-fault-spec entry '{part}' needs replica=N")
            out.append(FaultSpec(**kw))
        if not out:
            raise ValueError("--serve-fault-spec parsed to no faults")
        return out

    # ------------------------------------------------------------- arming
    def _check(self, replica: int, site: str, count: int) -> FaultSpec | None:
        """The fault (if any) firing at this site event; one-shot specs
        fire at most once, prob specs draw from the injector's seeded rng
        (one draw per matching event — deterministic given the seed and
        the event schedule)."""
        for i, s in enumerate(self.specs):
            if s.replica != replica or s.site != site or i in self._done:
                continue
            hit = (count == s.at) if s.at else \
                (float(self._rng.random()) < s.prob)
            if hit:
                self._done.add(i)
                self.fired.append({"kind": s.kind, "replica": replica,
                                   "site": site, "count": count,
                                   "stall_s": s.stall_s or None})
                return s
        return None

    def _decode_event(self, replica_id: int, counts: dict,
                      what: str) -> FaultSpec | None:
        """One decode iteration on ``replica_id``: a crash raises here, a
        stall sleeps; returns the spec that fired (nanlogits corrupts the
        caller's result)."""
        counts["decode"] += 1
        s = self._check(replica_id, "decode", counts["decode"])
        if s is not None:
            if s.kind == "crash":
                raise InjectedFault(
                    f"injected crash: replica {replica_id} decode "
                    f"iteration {counts['decode']}{what}")
            if s.kind == "stall":
                time.sleep(s.stall_s)
        return s

    def arm(self, replica_id: int, kv: SlotKVCache) -> None:
        """Wrap this table's entry points.  Instance-level wrappers: the
        class and every other table stay untouched."""
        if not any(s.replica == replica_id for s in self.specs):
            return
        counts = {"decode": 0, "prefill": 0, "verify": 0, "handoff": 0}
        injector = self

        orig_advance = kv.advance
        orig_insert = kv.insert
        orig_chunk = kv.prefill_chunk
        orig_verify = kv.verify_block

        def advance(only=None):
            if only is None:   # draft catch-up steps are not iterations
                s = injector._decode_event(replica_id, counts, "")
                if s is not None and s.kind == "nanlogits":
                    # what NaN logits degrade argmax sampling into: an id
                    # no vocabulary contains — the fleet's host check
                    # rejects it before delivery
                    bad = np.asarray(orig_advance(only)).copy()
                    bad[:] = -1
                    return bad
            return orig_advance(only)

        def _prefill_gate():
            counts["prefill"] += 1
            s = injector._check(replica_id, "prefill", counts["prefill"])
            if s is not None:
                raise InjectedFault(
                    f"injected crash: replica {replica_id} prefill "
                    f"program {counts['prefill']}")

        def insert(prompt, slot=None):
            _prefill_gate()
            return orig_insert(prompt, slot)

        def prefill_chunk(slot, max_tokens=None):
            _prefill_gate()
            return orig_chunk(slot, max_tokens)

        def verify_block(block):
            # a speculative round's verify IS the target decode iteration:
            # decode-site faults count and fire here too, or a
            # spec-decoding replica would be unkillable by `iter=K`
            s = injector._decode_event(replica_id, counts, " (verify round)")
            g = orig_verify(block)
            counts["verify"] += 1
            if injector._check(replica_id, "verify",
                               counts["verify"]) is not None:
                # after the verify ran, before any commit_block: nothing
                # of this round may survive into the emitted stream
                raise InjectedFault(
                    f"injected crash: replica {replica_id} between verify "
                    f"{counts['verify']} and commit")
            if s is not None and s.kind == "nanlogits":
                g = np.asarray(g).copy()
                g[:] = -1
            return g

        kv.advance = advance
        kv.insert = insert
        kv.prefill_chunk = prefill_chunk
        kv.verify_block = verify_block
        orig_extract = getattr(kv, "extract_handoff", None)
        if orig_extract is None:
            return

        def extract_handoff(slot):
            # before the KV leaves the replica: prefill complete, decode
            # admission not yet
            counts["handoff"] += 1
            if injector._check(replica_id, "handoff",
                               counts["handoff"]) is not None:
                raise InjectedFault(
                    f"injected crash: replica {replica_id} handoff "
                    f"{counts['handoff']} (between prefill completion and "
                    f"decode admission)")
            return orig_extract(slot)

        kv.extract_handoff = extract_handoff


# --------------------------------------------------------------- journal

@dataclasses.dataclass
class _Entry:
    """One offered request's journal record (journal lock held for every
    mutation)."""

    req: Request
    status: str = "pending"   # pending | done | shed | lost | unserved
    replica: int | None = None
    attempts: int = 0
    emitted: list[int] = dataclasses.field(default_factory=list)
    emit_t: list[float] = dataclasses.field(default_factory=list)
    assigned_t: float = 0.0
    first_assigned_t: float | None = None
    failed_at: float | None = None   # set at its replica's failure, until
    #                                  the first post-requeue emission
    completed_by: int | None = None
    finish_t: float | None = None


class RequestJournal:
    """Assignment + emission ledger: the exactly-once substrate.

    Every token delivery flows through :meth:`emit`, which accepts an
    emission only from the request's CURRENT replica assignment (the
    fence): after failover, a zombie replica's late emissions are counted
    (``fenced_emissions``) and dropped, never delivered.  A request
    completes when its emitted stream reaches ``max_new_tokens`` (or its
    EOS) — the same rule the batchers apply — so journal state and
    replica state cannot disagree about doneness.

    ``duplicate_emissions`` counts deliveries that would repeat an
    already-delivered position; the fence makes this structurally zero,
    and the counter measures it instead of assuming it.
    """

    def __init__(self, requests: Iterable[Request]):
        self._lock = threading.RLock()
        self.entries: dict[int, _Entry] = {}
        self.load: dict[int, int] = {}    # replica -> live assigned count
        self.fenced_emissions = 0
        self.duplicate_emissions = 0
        self.done_count = 0               # O(1) completion counter (the
        #                                   swap threshold reads it on
        #                                   every completion)
        self.requeues = 0                 # re-assignments (retries)
        self.requeued_rids: set[int] = set()
        self.recovery_s: list[float] = []
        for req in requests:
            if req.rid in self.entries:
                raise ValueError(f"duplicate rid {req.rid} in workload")
            self.entries[req.rid] = _Entry(req=req)

    # ------------------------------------------------------------ routing
    def assign(self, rid: int, replica: int, t: float,
               retry: bool = False) -> None:
        """Assign ``rid`` to ``replica`` at ``t``: one more attempt, and
        with ``retry`` one more requeue."""
        with self._lock:
            e = self.entries[rid]
            if e.replica is not None:
                self.load[e.replica] = self.load.get(e.replica, 1) - 1
            e.replica = replica
            e.attempts += 1
            e.assigned_t = t
            if e.first_assigned_t is None:
                e.first_assigned_t = t
            self.load[replica] = self.load.get(replica, 0) + 1
            if retry:
                self.requeues += 1
                self.requeued_rids.add(rid)

    def least_loaded(self, replicas: Iterable[int]) -> int:
        """Front-end routing: the serving replica with the fewest live
        assignments (ties → lowest id, so routing is deterministic)."""
        with self._lock:
            return min(replicas,
                       key=lambda r: (self.load.get(r, 0), r))

    # ----------------------------------------------------------- emission
    def emit(self, rid: int, replica: int, token: int,
             t: float) -> tuple[bool, bool, float | None]:
        """Record one token delivery; returns ``(accepted, completed_now,
        recovery_s)``.  ``accepted`` False = fenced (stale assignment or
        already-terminal request) — the caller must NOT deliver."""
        with self._lock:
            e = self.entries.get(rid)
            if e is None or e.status != "pending" or e.replica != replica:
                self.fenced_emissions += 1
                return False, False, None
            if len(e.emitted) >= e.req.max_new_tokens:
                # structurally unreachable (completion flips status); a
                # hit here is a real double-delivery — measured, not
                # assumed away
                self.duplicate_emissions += 1
                return False, False, None
            e.emitted.append(int(token))
            e.emit_t.append(float(t))
            recovery = None
            if e.failed_at is not None:
                recovery = float(t) - e.failed_at
                self.recovery_s.append(recovery)
                e.failed_at = None
            done = (len(e.emitted) >= e.req.max_new_tokens
                    or (e.req.eos_id is not None
                        and int(token) == e.req.eos_id))
            if done:
                e.status = "done"
                e.completed_by = replica
                e.finish_t = float(t)
                self.done_count += 1
                self.load[replica] = self.load.get(replica, 1) - 1
            return True, done, recovery

    # ----------------------------------------------------------- failover
    def pending_for(self, replica: int) -> list[int]:
        with self._lock:
            return sorted(rid for rid, e in self.entries.items()
                          if e.status == "pending" and e.replica == replica)

    def mark_failed(self, rids: Iterable[int], t: float) -> None:
        """Atomically fence a dead replica's requests: the assignment is
        CLEARED here (under the journal lock), so a zombie emission
        racing the failover — after the supervisor decided to fail over
        but before the requeue lands — is already stale."""
        with self._lock:
            for rid in rids:
                e = self.entries[rid]
                if e.status != "pending":
                    continue
                if e.failed_at is None:
                    e.failed_at = float(t)
                if e.replica is not None:
                    self.load[e.replica] = self.load.get(e.replica, 1) - 1
                    e.replica = None

    def retry_request(self, rid: int) -> Request | None:
        """The resume request for a failed-over rid: original prompt +
        already-emitted prefix re-prefilled, remaining budget only —
        greedy decode makes the continuation exactly what the dead
        replica would have produced.  None when the stream is already
        complete (crash after the last emission: nothing to resume)."""
        with self._lock:
            e = self.entries[rid]
            if e.status != "pending":
                return None   # completed/terminal while failing over
            remaining = e.req.max_new_tokens - len(e.emitted)
            if remaining <= 0:
                # crash landed after the last delivery: the stream is
                # complete, attributed to the replica that finished it
                e.status = "done"
                e.completed_by = e.replica
                e.finish_t = e.emit_t[-1] if e.emit_t else None
                self.done_count += 1
                if e.replica is not None:
                    self.load[e.replica] = self.load.get(e.replica, 1) - 1
                return None
            prompt = np.concatenate([
                np.asarray(e.req.prompt, np.int32).reshape(-1),
                np.asarray(e.emitted, np.int32)])
            return Request(rid=rid, prompt=prompt,
                           max_new_tokens=remaining,
                           arrival_s=e.req.arrival_s,
                           eos_id=e.req.eos_id)

    def finalize(self, rid: int, status: str) -> None:
        """Terminal non-completion states: shed / lost / unserved."""
        with self._lock:
            e = self.entries[rid]
            if e.status == "pending":
                e.status = status
                if e.replica is not None:
                    self.load[e.replica] = self.load.get(e.replica, 1) - 1

    def finalize_if_assigned(self, rid: int, replica: int,
                             status: str) -> None:
        """Fenced finalize: only the request's CURRENT replica may
        terminal-ize it (a zombie's shed report must not kill a request
        a survivor now owns — same fence as emission)."""
        with self._lock:
            e = self.entries.get(rid)
            if e is not None and e.status == "pending" \
                    and e.replica == replica:
                e.status = status
                self.load[replica] = self.load.get(replica, 1) - 1

    # ----------------------------------------------------------- summary
    def all_terminal(self) -> bool:
        with self._lock:
            return all(e.status != "pending"
                       for e in self.entries.values())

    def counts(self) -> dict[str, int]:
        with self._lock:
            c = {"done": 0, "shed": 0, "lost": 0, "unserved": 0,
                 "pending": 0}
            for e in self.entries.values():
                c[e.status] += 1
            return c

    def results(self) -> list[RequestResult]:
        """Fleet-level per-request results from the journal's emission
        timeline: TTFT from the ORIGINAL arrival (retries do not reset
        the clock), ITL gaps from consecutive delivery times (a
        failover's recovery gap lands in the retried request's own ITL
        tail, where its reader felt it)."""
        with self._lock:
            out = []
            for rid in sorted(self.entries):
                e = self.entries[rid]
                if e.status != "done" or not e.emit_t:
                    continue
                lp = int(np.asarray(e.req.prompt).reshape(-1).shape[0])
                admitted = (e.first_assigned_t
                            if e.first_assigned_t is not None
                            else e.req.arrival_s)
                out.append(RequestResult(
                    rid=rid, prompt_len=lp, tokens=list(e.emitted),
                    arrival_s=e.req.arrival_s, admitted_s=admitted,
                    first_token_s=e.emit_t[0], finished_s=e.emit_t[-1],
                    itl_s=[b - a for a, b in zip(e.emit_t, e.emit_t[1:])],
                    queue_wait_s=max(
                        (e.first_assigned_t or e.req.arrival_s)
                        - e.req.arrival_s, 0.0),
                    prefill_s=max(e.emit_t[0]
                                  - (e.first_assigned_t
                                     or e.req.arrival_s), 0.0)))
            return out


# ---------------------------------------------------------- shared clock

class _SharedClock:
    """One fleet-wide clock behind every replica's batcher: ``start`` is
    idempotent (each ``ContinuousBatcher.run`` calls it; only the first
    may zero the timeline) and virtual mutations are serialized — the
    fleet timeline is shared state, per-replica restarts must not rewind
    it."""

    def __init__(self, base):
        self._base = base
        self._lock = threading.Lock()
        self._started = False
        self.poll_slice_s = getattr(base, "poll_slice_s", float("inf"))

    def start(self) -> None:
        with self._lock:
            if not self._started:
                self._base.start()
                self._started = True

    def now(self) -> float:
        return self._base.now()

    def on_decode_iteration(self) -> None:
        with self._lock:
            self._base.on_decode_iteration()

    def on_prefill(self, tokens: int) -> None:
        with self._lock:
            self._base.on_prefill(tokens)

    def wait_until(self, t: float) -> None:
        self._base.wait_until(t)


class _FleetQueue(RequestQueue):
    """RequestQueue whose mutations are lock-guarded, so the supervisor
    can requeue a failed replica's requests INTO a survivor's live run —
    the retry re-enters the continuous-batching loop between decode
    iterations instead of waiting for the survivor's batch to drain."""

    def __init__(self, requests=()):
        super().__init__(requests)
        self._qlock = threading.RLock()

    def push(self, request):
        with self._qlock:
            super().push(request)

    def __len__(self):
        with self._qlock:
            return super().__len__()

    def next_arrival(self):
        with self._qlock:
            return super().next_arrival()

    def pop_ready(self, now):
        with self._qlock:
            return super().pop_ready(now)

    def depth(self, now=None):
        with self._qlock:
            return super().depth(now)

    def shed_ready(self, now, keep):
        with self._qlock:
            return super().shed_ready(now, keep)

    def drain(self) -> list[Request]:
        with self._qlock:
            items, self._items = list(self._items), []
            return items


def _ready_event(*state_dicts):
    """An event recorded on the calling thread's current stream when any
    tensor of ``state_dicts`` lies on the card (None otherwise): a swap
    performed later on a replica's stream waits on it, so the copies
    read the weights as the caller's stream leaves them."""
    for sd in state_dicts:
        for v in (sd or {}).values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(v.device))
                return event
    return None


# ---------------------------------------------------------------- replica

class _Replica:
    """Supervisor-side record of one batcher replica.  ``stream``: the
    CUDA stream its table serves on (None on the CPU)."""

    def __init__(self, rid: int, kv: SlotKVCache,
                 registry: MetricsRegistry):
        self.id = rid
        self.kv = kv
        self.batcher: ContinuousBatcher | None = None  # set by ReplicaSet
        self.registry = registry
        self.lease = LeaseManager(signals=())   # trigger()-driven only
        self.queue = _FleetQueue()
        self.state = "serving"                  # serving | failed
        self.generation = 0                     # weight-swap count
        self.busy = False
        self.completed = 0
        self.failure: str | None = None
        self.last_progress = time.monotonic()
        self.work = threading.Event()
        self.stop = threading.Event()
        self.thread: threading.Thread | None = None
        self.stream = (torch.cuda.Stream(kv.device)
                       if kv.device.type == "cuda" else None)

    @contextlib.contextmanager
    def on_stream(self):
        """The replica's device and stream current in the calling thread
        (a null context on the CPU)."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.kv.device), torch.cuda.stream(
                self.stream):
            yield


class ReplicaSet:
    """N-replica serving fleet supervisor (module docstring).

    ``kvs`` is one ``SlotKVCache`` per replica, each over its own model
    (``build_replica_kvs``).  ``clock`` is fleet-wide: ``WallClock``
    (default) serves every replica on its own thread; ``VirtualClock``
    drives replicas sequentially in id order — deterministic chaos
    schedules (``threaded`` overrides the default).

    ``fault_injector`` arms seeded faults on the matching replicas'
    tables before serving.  ``watchdog_timeout_s`` (threaded mode) fails
    over a replica whose scheduler loop made no heartbeat for that long
    while busy — the heartbeat ticks at every loop iteration and idle
    poll slice (``_replica_should_stop``), so a replica idling toward a
    future arrival is NOT a stall; one wedged inside a device call is.
    The zombie is fenced, not killed: its late emissions are rejected by
    the journal.  The watchdog cannot tell a stall from a first call's
    kernel build (the host blocks inside the same call), so set the
    timeout above the worst build time or warm the tables first.

    ``retry_limit`` bounds per-request failover attempts (assignments
    beyond the first), with ``retry_backoff_s`` exponential arrival
    backoff; an exhausted request is terminal ``lost`` and counts into
    ``unserved_requests`` (conservation stays exact).

    ``roles``, ``routing="affinity"``, ``autoscale`` and
    ``parallel_lanes`` (JAX's disaggregated, affinity-routed and
    autoscaled fleet) raise ``NotImplementedError``.
    """

    def __init__(self, kvs: list[SlotKVCache], *, tracer=NULL_TRACER,
                 clock=None, threaded: bool | None = None,
                 prefill_chunk: int = 0, queue_cap: int = 0, slo=None,
                 draft_kvs: list[SlotKVCache] | None = None,
                 draft_k: int = 4, retry_limit: int = 2,
                 retry_backoff_s: float = 0.0,
                 watchdog_timeout_s: float = 0.0,
                 fault_injector: FaultInjector | None = None,
                 timeline=None,
                 roles: list[str] | None = None,
                 routing: str = "least-loaded",
                 autoscale=None,
                 parallel_lanes: bool = False,
                 roofline=None, multi_step: int | None = None):
        if not kvs:
            raise ValueError("ReplicaSet needs at least one SlotKVCache")
        if draft_kvs is not None and len(draft_kvs) != len(kvs):
            raise ValueError(
                f"draft_kvs must pair replicas 1:1 ({len(draft_kvs)} "
                f"drafts vs {len(kvs)} replicas)")
        if retry_limit < 0:
            raise ValueError(f"retry_limit must be >= 0, got {retry_limit}")
        if routing not in ("least-loaded", "affinity"):
            raise ValueError(
                f"routing must be 'least-loaded' or 'affinity', "
                f"got '{routing}'")
        if roles is not None:
            not_ported("a disaggregated fleet (roles)", DISAGG_ITEM)
        if routing != "least-loaded":
            not_ported("affinity routing", DISAGG_ITEM)
        if autoscale is not None:
            not_ported("fleet autoscale", DISAGG_ITEM)
        if parallel_lanes:
            not_ported("parallel_lanes", DISAGG_ITEM)
        if multi_step is not None and int(multi_step) < 1:
            raise ValueError(
                f"multi_step must be >= 1, got {multi_step}")
        self.tracer = tracer
        base_clock = clock if clock is not None else WallClock()
        self.clock = _SharedClock(base_clock)
        if threaded is None:
            threaded = not isinstance(base_clock, VirtualClock)
        self.threaded = bool(threaded)
        self.multi_step = None if multi_step is None else int(multi_step)
        self.slo = slo
        self.retry_limit = int(retry_limit)
        self.retry_backoff_s = float(retry_backoff_s)
        self.watchdog_timeout_s = float(watchdog_timeout_s)
        self.fault_injector = fault_injector
        # --timeline: ONE shared sampler; per-replica series are keyed by
        # replica id, so concurrent replica threads write distinct series
        self.timeline = timeline
        # --roofline: ONE Roofline handed to every batcher; each tallies
        # its own counters, and _summary sums them across replicas
        self.roofline = roofline
        self.vocab = int(kvs[0].model.vocab_size)
        self.draft_kvs = draft_kvs
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.replicas: list[_Replica] = []
        for i, kv in enumerate(kvs):
            registry = MetricsRegistry()
            replica = _Replica(i, kv, registry)
            replica.batcher = ContinuousBatcher(
                kv, tracer=tracer, clock=self.clock, mode="continuous",
                prefill_chunk=prefill_chunk, metrics=registry,
                queue_cap=queue_cap,
                should_stop=(lambda iters, r=replica:
                             self._replica_should_stop(r, iters)),
                draft_kv=(draft_kvs[i] if draft_kvs is not None else None),
                draft_k=draft_k, timeline=timeline, timeline_tag=i,
                roofline=roofline, multi_step=multi_step)
            self.replicas.append(replica)
            if fault_injector is not None:
                fault_injector.arm(i, kv)
        if self.multi_step is not None:
            # every fused round the replicas will run, captured now, in
            # replica order (module docstring): the target's at k, the
            # draft's at each proposal width a verify round can take
            for replica in self.replicas:
                with replica.on_stream():
                    replica.kv.prepare_round(self.multi_step)
                    if draft_kvs is not None:
                        for k in range(2, int(draft_k) + 1):
                            draft_kvs[replica.id].prepare_round(k)
        # swap state survives _reset_run_state: schedule_swap may be
        # called BEFORE run(), and generations accumulate across windows
        self.swap_generations = 0
        self._swap: dict[str, Any] | None = None
        self._draining = 0
        # fleet-level ledgers, reset per run()
        self._reset_run_state()

    # ------------------------------------------------------------- state
    def _reset_run_state(self) -> None:
        self.journal: RequestJournal | None = None
        self.min_admitting_replicas: int | None = None
        self._failovers: list[dict[str, Any]] = []
        self._watchdog_stalls = 0
        self._preempted: str | None = None
        self._on_token: Callable[[int, int], None] | None = None
        self._sums: dict[str, float] = {}
        self._spec_sums: dict[str, int] = {}
        self._prefix_sums: dict[str, int] = {}
        self._paged_sums: dict[str, int] = {}   # zero-copy/CoW across replicas
        self._phase_sums: dict[str, float] = {}
        # --roofline ledgers (empty without one): fleet totals of the
        # batchers' analytic counters + the same split per replica id
        self._rf_sums: dict[str, float] = {}
        self._rf_replica: dict[int, dict[str, float]] = {}
        self._shed_count = 0
        self._run_summaries = 0

    def _serving(self) -> list[_Replica]:
        return [r for r in self.replicas if r.state == "serving"]

    def _note_admitting(self) -> None:
        """Track the fleet's minimum admitting-replica count (serving and
        not draining) — the zero-downtime claim is measured, not assumed."""
        admitting = len(self._serving()) - self._draining
        if (self.min_admitting_replicas is None
                or admitting < self.min_admitting_replicas):
            self.min_admitting_replicas = admitting

    def _sample_timeline(self) -> None:
        """Fleet-level --timeline gauges at the coordinator's poll
        boundary: per-replica live load (a killed replica's lane drops
        to zero), the admitting-replica count and the journal's retry
        backlog.  Host reads only; None = off."""
        tl = self.timeline
        if tl is None or self.journal is None:
            return
        for r in self.replicas:
            load = (self.journal.load.get(r.id, 0)
                    if r.state == "serving" else 0)
            tl.sample("replica_load", load, replica=r.id)
        counts = self.journal.counts()
        tl.sample_many({
            "admitting_replicas": len(self._serving()) - self._draining,
            "journal_pending": counts.get("pending", 0),
            "journal_retries": self.journal.requeues,
        }, group="fleet")

    def _replica_should_stop(self, replica: _Replica,
                             iters: int) -> str | None:
        """The per-replica drain hook — and the watchdog's heartbeat:
        the batcher consults it at every scheduler-loop iteration AND
        every idle poll slice, so a replica legitimately idling toward a
        future arrival keeps ticking while one wedged inside a device
        call (or an injected stall) freezes."""
        replica.last_progress = time.monotonic()
        return replica.lease.should_stop(iters)

    # ------------------------------------------------------------ routing
    def _route(self, req: Request, retry: bool = False,
               from_replica: int | None = None,
               reason: str | None = None,
               at: float | None = None) -> bool:
        """Assign ``req`` to the least-loaded serving replica; False when
        none can take it (the caller marks it lost)."""
        candidates = self._serving()
        if not candidates:
            return False
        target = self.replicas[self.journal.least_loaded(
            [r.id for r in candidates])]
        now = self.clock.now() if at is None else float(at)
        self.journal.assign(req.rid, target.id, now, retry=retry)
        if retry:
            entry = self.journal.entries[req.rid]
            backoff = (self.retry_backoff_s
                       * (2 ** max(entry.attempts - 2, 0)))
            req = dataclasses.replace(
                req, arrival_s=max(req.arrival_s, now + backoff))
            self.tracer.event(
                "requeue", rid=req.rid, from_replica=from_replica,
                to_replica=target.id, attempt=entry.attempts,
                arrival_s=entry.req.arrival_s, reason=reason,
                emitted=len(entry.emitted))
            self.tracer.counter("requeued_requests")
        target.queue.push(req)
        target.work.set()
        return True

    # ----------------------------------------------------------- emission
    def _emit_hook(self, replica: _Replica):
        def hook(rid: int, token: int) -> None:
            tok = int(token)
            if tok < 0 or tok >= self.vocab:
                # the cheap host check: two comparisons per token.  An id
                # outside the vocabulary is what nonfinite logits degrade
                # sampling into — fail the replica BEFORE delivery.
                raise CorruptionDetected(
                    f"replica {replica.id} emitted token id {tok} outside "
                    f"[0, {self.vocab}) for rid {rid} — nonfinite-logits "
                    f"corruption")
            accepted, done, _recovery = self.journal.emit(
                rid, replica.id, tok, self.clock.now())
            replica.last_progress = time.monotonic()
            if not accepted:
                return   # fenced: counted by the journal, never delivered
            if self._on_token is not None:
                self._on_token(rid, tok)
            if done:
                replica.completed += 1
                with self._cond:
                    self._maybe_start_swap()
                    self._cond.notify_all()
        return hook

    # ----------------------------------------------------------- failover
    def _on_replica_failure(self, replica: _Replica, exc: BaseException,
                            kind: str | None = None) -> None:
        with self._lock:
            if replica.state == "failed":
                return   # watchdog + exception can race; first wins
            replica.state = "failed"
            replica.failure = f"{type(exc).__name__}: {exc}"
            self._note_admitting()
            now = self.clock.now()
            kind = kind or (
                "injected" if isinstance(exc, InjectedFault) else
                "corruption" if isinstance(exc, CorruptionDetected) else
                "crash")
            pending = self.journal.pending_for(replica.id)
            # fence first (a zombie's next emission must already be
            # stale), then requeue
            self.journal.mark_failed(pending, now)
            self.tracer.event("replica_failure", replica=replica.id,
                              kind=kind, error=replica.failure,
                              requests=len(pending))
            self.tracer.counter("replica_failures")
            self._failovers.append({
                "replica": replica.id, "kind": kind,
                "error": replica.failure, "t": now,
                "requeued": len(pending)})
            # a failed replica scheduled for a swap must not wedge the
            # rotation
            if self._swap is not None and self._swap.get("active") \
                    == replica.id:
                self._advance_swap()
            # queued-but-unadmitted requests still sit in its queue; the
            # journal assignment is the routing truth either way
            replica.queue.drain()
            for rid in pending:
                self._requeue(rid, replica.id,
                              reason=f"replica_failure:{kind}", at=now)
            self._cond.notify_all()

    def _requeue(self, rid: int, from_replica: int, reason: str,
                 at: float | None = None) -> None:
        entry = self.journal.entries[rid]
        retries_used = max(entry.attempts - 1, 0)
        if retries_used >= self.retry_limit:
            self.journal.finalize(rid, "lost")
            self.tracer.event("retry_exhausted", rid=rid,
                              attempts=entry.attempts,
                              limit=self.retry_limit)
            return
        req = self.journal.retry_request(rid)
        if req is None:
            return   # stream already complete — nothing to resume
        if not self._route(req, retry=True, from_replica=from_replica,
                           reason=reason, at=at):
            self.journal.finalize(rid, "lost")
            self.tracer.event("retry_exhausted", rid=rid,
                              attempts=entry.attempts,
                              limit=self.retry_limit,
                              error="no surviving replica")

    # ---------------------------------------------------------- hot swap
    def schedule_swap(self, params, draft_params=None, *,
                      after_completions: int = 0) -> None:
        """Schedule a zero-downtime weight hot-swap: once
        ``after_completions`` requests have completed fleet-wide (0 =
        immediately), replicas drain and swap one at a time — the fleet
        never drops below N−1 admitting replicas.  ``params`` (and
        ``draft_params``) is a state_dict of the served model.  Call
        before or during ``run``; ``swap_generations`` increments when
        every serving replica carries the new weights."""
        with self._lock:
            if self._swap is not None:
                raise RuntimeError("a weight swap is already in flight")
            self._swap = {"params": params, "draft_params": draft_params,
                          "after": int(after_completions),
                          "queue": None, "active": None,
                          "ready": _ready_event(params, draft_params)}
            self._maybe_start_swap()

    def _maybe_start_swap(self) -> None:
        sw = self._swap
        if sw is None or sw["queue"] is not None or self.journal is None:
            return
        if self.journal.done_count < sw["after"]:
            return
        sw["queue"] = [r.id for r in self._serving()]
        self._advance_swap()

    def _advance_swap(self) -> None:
        sw = self._swap
        if sw is None:
            return
        if sw["active"] is not None:
            self._draining -= 1
            sw["active"] = None
        while sw["queue"]:
            rid = sw["queue"].pop(0)
            replica = self.replicas[rid]
            if replica.state != "serving":
                continue
            sw["active"] = rid
            self._draining += 1
            self._note_admitting()
            replica.lease.trigger("weight_swap")
            replica.work.set()
            return
        # rotation complete: one whole fleet generation
        self.swap_generations += 1
        self.tracer.event("weight_swap_generation",
                          generation=self.swap_generations)
        self._swap = None
        self._cond.notify_all()

    def _finish_pending_swap(self) -> None:
        """Complete a STARTED swap rotation once serving work is done:
        every remaining replica is idle, so each turn installs the new
        weights with nothing in flight.  A trigger can land exactly as
        the active replica's run loop empties — the run then exits
        without the drain marker, and without this sweep the rotation
        would stall one replica short of a generation."""
        for _ in range(len(self.replicas) + 1):
            with self._lock:
                sw = self._swap
                if sw is None or sw.get("queue") is None \
                        or sw.get("active") is None:
                    return
                active = self.replicas[sw["active"]]
            self._perform_swap(active)

    def _perform_swap(self, replica: _Replica) -> None:
        """The drained replica installs the new weights in place (on its
        stream, between rounds) and resumes serving on the same lease."""
        with self._lock:
            sw = self._swap
            if sw is None or sw["active"] != replica.id:
                return
            with replica.on_stream():
                if sw["ready"] is not None:
                    # the new weights may still be in flight on the
                    # caller's stream
                    torch.cuda.current_stream().wait_event(sw["ready"])
                replica.kv.swap_params(sw["params"])
                if self.draft_kvs is not None \
                        and sw["draft_params"] is not None:
                    self.draft_kvs[replica.id].swap_params(
                        sw["draft_params"])
            replica.lease.reset_trigger()
            replica.generation += 1
            self.tracer.event("weight_swap", replica=replica.id,
                              generation=replica.generation)
            self._advance_swap()
            replica.work.set()

    # --------------------------------------------------------- the loop
    def _serve_once(self, replica: _Replica) -> None:
        """One batcher run over the replica's queue on its stream;
        failures fail over, a weight_swap drain performs the swap and
        leaves the leftover queue for the next run."""
        replica.busy = True
        replica.last_progress = time.monotonic()
        try:
            with replica.on_stream():
                summary = replica.batcher.run(
                    replica.queue, on_token=self._emit_hook(replica))
        except BaseException as e:  # noqa: BLE001 — any death fails over
            replica.busy = False
            self._on_replica_failure(replica, e)
            return
        replica.busy = False
        if replica.state == "failed":
            # a fenced zombie's late summary is not fleet truth: the
            # watchdog already failed this replica over mid-run, its
            # requests were requeued, and absorbing would double-count
            # the ledgers — its shed_rids would finalize requests a
            # survivor now owns
            return
        self._absorb(replica, summary)
        if summary.get("preempted") == "weight_swap":
            self._perform_swap(replica)
        with self._cond:
            self._cond.notify_all()

    def _absorb(self, replica: _Replica, s: dict[str, Any]) -> None:
        """Fold one successful run summary into the fleet ledgers (a run
        that died contributes nothing here; the journal still has every
        delivered token)."""
        with self._lock:
            self._run_summaries += 1
            for k in ("decode_iterations", "prefills", "prefill_chunks",
                      "prefill_tokens", "decode_tokens", "idle_polls"):
                self._sums[k] = self._sums.get(k, 0) + (s.get(k) or 0)
            spec = s.get("speculative")
            if spec:
                for k in ("proposed_tokens", "accepted_tokens",
                          "rejected_tokens", "draft_iterations",
                          "draft_catchup_steps"):
                    self._spec_sums[k] = (self._spec_sums.get(k, 0)
                                          + spec.get(k, 0))
            pc = s.get("prefix_cache")
            if pc:
                for k, v in pc.items():
                    if isinstance(v, int):
                        self._prefix_sums[k] = (self._prefix_sums.get(k, 0)
                                                + v)
            pg = s.get("paged")
            if pg:
                # counter deltas sum across replicas; pool-state keys are
                # read live at summary time from the replica tables
                for k in ("zero_copy_hits", "zero_copy_blocks",
                          "zero_copy_tokens", "cow_copies",
                          "block_deferrals"):
                    self._paged_sums[k] = (self._paged_sums.get(k, 0)
                                           + pg.get(k, 0))
            for k, v in (s.get("device_phase_s") or {}).items():
                self._phase_sums[k] = self._phase_sums.get(k, 0.0) + v
            if "serve_dispatches" in s:
                self._sums["serve_dispatches"] = (
                    self._sums.get("serve_dispatches", 0)
                    + (s.get("serve_dispatches") or 0))
                self._sums["serve_host_gap_s"] = (
                    self._sums.get("serve_host_gap_s", 0.0)
                    + (s.get("serve_host_gap_s") or 0.0))
            rf = s.get("roofline")
            if rf:
                per = self._rf_replica.setdefault(replica.id, {})
                for k in ("prefill_model_flops", "decode_model_flops",
                          "decode_must_read_bytes", "prefill_s",
                          "decode_s"):
                    v = float(rf.get(k) or 0.0)
                    self._rf_sums[k] = self._rf_sums.get(k, 0.0) + v
                    per[k] = per.get(k, 0.0) + v
            self._shed_count += s.get("shed_requests") or 0
            for rid in s.get("shed_rids") or ():
                self.journal.finalize_if_assigned(rid, replica.id, "shed")

    # sequential (deterministic) driver -------------------------------
    def _run_sequential(self, should_stop) -> None:
        while True:
            if should_stop is not None and self._preempted is None:
                reason = should_stop(0)
                if reason:
                    self._preempted = reason
                    break
            progressed = False
            self._sample_timeline()
            for replica in self.replicas:
                if replica.state != "serving":
                    continue
                if self._swap is not None \
                        and self._swap.get("active") == replica.id \
                        and not len(replica.queue):
                    # idle replica's swap turn: nothing in flight to drain
                    self._perform_swap(replica)
                if len(replica.queue):
                    progressed = True
                    self._serve_once(replica)
            if self.journal.all_terminal():
                break
            if not progressed:
                # no serving replica holds work but entries are pending —
                # every assignment points at a corpse (requeue already
                # exhausted or raced); terminal-ize so conservation holds
                for rid, e in self.journal.entries.items():
                    if e.status == "pending":
                        self.journal.finalize(rid, "lost")
                break

    # threaded driver --------------------------------------------------
    def _worker(self, replica: _Replica) -> None:
        with replica.on_stream():
            while True:
                if replica.state != "serving":
                    return
                if self._preempted is not None:
                    # fleet drain: the current run already finished
                    # in-flight (its lease was triggered); do not restart
                    # over the leftover queue — those are the drain's
                    # unserved
                    return
                with self._lock:
                    pass_swap = (self._swap is not None
                                 and self._swap.get("active") == replica.id
                                 and not len(replica.queue)
                                 and not replica.busy)
                if pass_swap:
                    self._perform_swap(replica)
                    continue
                if replica.stop.is_set():
                    return
                if not len(replica.queue):
                    replica.work.wait(0.02)
                    replica.work.clear()
                    continue
                self._serve_once(replica)

    def _watchdog(self) -> None:
        timeout = self.watchdog_timeout_s
        while not self._wd_stop.wait(timeout / 4):
            for replica in self._serving():
                if replica.busy and (time.monotonic()
                                     - replica.last_progress) > timeout:
                    self._watchdog_stalls += 1
                    # fence + requeue; the zombie thread keeps running
                    # until it wakes, at which point its lease drains it
                    # and its emissions are already stale
                    replica.lease.trigger("watchdog_stall")
                    self._on_replica_failure(
                        replica,
                        TimeoutError(f"no progress for >{timeout}s"),
                        kind="watchdog_stall")

    # ----------------------------------------------------------- run
    def run(self, requests: Iterable[Request],
            on_token: Callable[[int, int], None] | None = None,
            should_stop: Callable[[int], str | None] | None = None,
            ) -> dict[str, Any]:
        """Serve every offered request to terminal state across the
        fleet; returns the fleet summary (serve-section compatible, plus
        ``serve_fleet``)."""
        requests = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        self._reset_run_state()
        for replica in self.replicas:
            # a previous run's shutdown left stop set; surviving replicas
            # serve again (failed ones stay dead — state is the gate)
            replica.stop.clear()
            replica.work.clear()
            # fresh per-run histograms: this run's summary describes THIS
            # window (the batcher merges its records into its registry)
            replica.registry = MetricsRegistry()
            replica.batcher.metrics = replica.registry
        self.journal = RequestJournal(requests)
        self._on_token = on_token
        offered = len(requests)
        self.min_admitting_replicas = len(self._serving())
        if self.slo is not None:
            self.slo.reset()
        self.clock.start()
        t_start = self.clock.now()
        for req in requests:
            if not self._route(req):
                self.journal.finalize(req.rid, "lost")
        with self._lock:
            self._maybe_start_swap()   # after_completions == 0 case
        if self.threaded:
            self._wd_stop = threading.Event()
            wd = None
            if self.watchdog_timeout_s > 0:
                wd = threading.Thread(target=self._watchdog, daemon=True)
                wd.start()
            for replica in self._serving():
                self._start_worker(replica)
            try:
                with self._cond:
                    while not self.journal.all_terminal():
                        if should_stop is not None \
                                and self._preempted is None:
                            reason = should_stop(0)
                            if reason:
                                self._preempted = reason
                                for replica in self._serving():
                                    replica.lease.trigger(reason)
                                    replica.work.set()
                        if self._preempted is not None and not any(
                                r.busy for r in self.replicas):
                            break
                        if not self._serving():
                            break
                        self._sample_timeline()
                        self._cond.wait(0.05)
            finally:
                self._wd_stop.set()
                for replica in self.replicas:
                    replica.stop.set()
                    replica.work.set()
                for replica in self.replicas:
                    if replica.thread is not None:
                        # a stalled zombie may be asleep inside an
                        # injected fault; it is fenced and daemonized —
                        # do not hang the fleet on it
                        replica.thread.join(timeout=1.0)
                if wd is not None:
                    wd.join(timeout=1.0)
        else:
            self._run_sequential(should_stop)
        if self._preempted is None:
            self._finish_pending_swap()
        # terminal sweep: anything still pending (fleet drain, stop with
        # no survivors) is unserved — conservation stays exact
        for rid, e in list(self.journal.entries.items()):
            if e.status == "pending":
                self.journal.finalize(rid, "unserved")
        if self._preempted:
            self.tracer.event("serve_preempted", reason=self._preempted,
                              completed=self.journal.counts()["done"],
                              unserved=self.journal.counts()["unserved"])
        self._sample_timeline()   # final state (post-failover cliffs)
        elapsed = self.clock.now() - t_start
        return self._summary(offered, elapsed)

    def _start_worker(self, replica: _Replica) -> None:
        replica.thread = threading.Thread(
            target=self._worker, args=(replica,), daemon=True)
        replica.thread.start()

    def close(self, timeout_s: float = 10.0) -> None:
        """Join worker threads left behind by ``run`` (a fenced zombie —
        e.g. a stalled replica sleeping through its watchdog failover —
        keeps running until it wakes; its emissions are already rejected,
        but a clean shutdown waits it out rather than let the interpreter
        tear down under a live kernel launch)."""
        deadline = time.monotonic() + timeout_s
        for replica in self.replicas:
            replica.stop.set()
            replica.work.set()
        for replica in self.replicas:
            t = replica.thread
            if t is not None and t.is_alive():
                t.join(timeout=max(deadline - time.monotonic(), 0.0))

    # ----------------------------------------------------------- summary
    def _summary(self, offered: int, elapsed: float) -> dict[str, Any]:
        journal = self.journal
        results = journal.results()
        counts = journal.counts()
        tracer_stats = self.tracer.stats() or {}
        ttfts = [r.ttft_s for r in results]
        itls = [g for r in results for g in r.itl_s]
        tokens = sum(len(e.emitted) for e in journal.entries.values()
                     if e.emitted)
        # merged per-replica histograms, by bucket-count addition
        merged = MetricsRegistry()
        for replica in self.replicas:
            merged.merge(replica.registry)
        # fleet-level goodput: every completed request judged on its
        # journal timeline (TTFT from original arrival), per replica and
        # merged — a retried request counts ONCE, for the replica that
        # finished it
        per_replica = []
        slo = self.slo
        fleet_good = 0
        for replica in self.replicas:
            done = [r for r in results
                    if journal.entries[r.rid].completed_by == replica.id]
            good = None
            if slo is not None:
                good = sum(
                    1 for r in done
                    if r.ttft_s <= slo.ttft_s
                    and ((exact_percentile(r.itl_s, slo.quantile)
                          or 0.0) <= slo.itl_s))
                fleet_good += good
            per_replica.append({
                "replica": replica.id,
                "state": replica.state,
                "failure": replica.failure,
                "completed": len(done),
                "tokens": sum(len(r.tokens) for r in done),
                "generation": replica.generation,
                "goodput_requests_per_sec": (
                    good / elapsed
                    if good is not None and elapsed > 0 else None),
            })
        slo_sec = None
        if slo is not None:
            slo.reset()
            for r in results:
                slo.observe(r.ttft_s, r.itl_s)
            slo.shed(counts["shed"])
            slo_sec = slo.summary(elapsed)
        recovery = list(journal.recovery_s)
        unserved = counts["lost"] + counts["unserved"]
        depth_hwm = max((r.queue.depth_high_watermark
                         for r in self.replicas), default=0)
        prefix_sec = None
        hit_rate = None
        if self._prefix_sums:
            prefix_sec = dict(self._prefix_sums)
            asked = prefix_sec.get("hits", 0) + prefix_sec.get("misses", 0)
            hit_rate = prefix_sec["hits"] / asked if asked else 0.0
        spec_sec = None
        accept_rate = None
        if self.draft_kvs is not None:
            spec_sec = dict(self._spec_sums)
            proposed = spec_sec.get("proposed_tokens", 0)
            accept_rate = (spec_sec.get("accepted_tokens", 0) / proposed
                           if proposed else None)
        # fleet paged accounting: counters summed across replica windows,
        # pool state summed/averaged over the CURRENT replica pools
        paged_sec = zero_copy_rate = None
        paged_kvs = [r.kv for r in self.replicas
                     if hasattr(r.kv, "paged_stats")]
        if paged_kvs:
            states = [kv.paged_stats() for kv in paged_kvs]
            paged_sec = dict(self._paged_sums)
            paged_sec["num_blocks"] = sum(s["num_blocks"] for s in states)
            paged_sec["block"] = states[0]["block"]
            paged_sec["blocks_in_use"] = sum(s["blocks_in_use"]
                                             for s in states)
            paged_sec["utilization"] = (paged_sec["blocks_in_use"]
                                        / paged_sec["num_blocks"])
            asked = (self._prefix_sums.get("hits", 0)
                     + self._prefix_sums.get("misses", 0))
            if self._prefix_sums:
                zero_copy_rate = (
                    paged_sec.get("zero_copy_blocks", 0) / asked
                    if asked else 0.0)
        qw = merged.histogram("queue_wait")
        qd = merged.histogram("queue_depth")
        prefill_tokens = int(self._sums.get("prefill_tokens", 0))
        decode_tokens = int(self._sums.get("decode_tokens", 0))

        def rate(n):
            return n / elapsed if elapsed > 0 else None

        kv0 = self.replicas[0].kv
        summary = {
            "mode": "fleet",
            "replicas": len(self.replicas),
            "requests": len(results),
            "completed": counts["done"],
            "serve_kv_dtype": kv0.kv_dtype,
            "serve_kv_bytes_per_slot": kv0.kv_bytes_per_slot(),
            "serve_kv_layout": kv0.kv_layout,
            "serve_kv_blocks_in_use": (paged_sec["blocks_in_use"]
                                       if paged_sec else None),
            "serve_kv_block_utilization": (paged_sec["utilization"]
                                           if paged_sec else None),
            "serve_prefix_zero_copy_hit_rate": zero_copy_rate,
            "serve_kv_block_deferrals": int(self._paged_sums.get(
                "block_deferrals", 0)),
            "paged": paged_sec,
            "serve_accept_rate": accept_rate,
            "speculative": spec_sec,
            "decode_iterations": int(self._sums.get(
                "decode_iterations", 0)),
            "prefills": int(self._sums.get("prefills", 0)),
            "prefill_chunk": max(r.batcher.prefill_chunk
                                 for r in self.replicas),
            "prefill_chunks": int(self._sums.get("prefill_chunks", 0)),
            "prefill_tokens": prefill_tokens,
            "decode_tokens": decode_tokens,
            "idle_polls": int(self._sums.get("idle_polls", 0)),
            "tokens_generated": tokens,
            "elapsed_s": elapsed,
            "serve_requests_per_sec": rate(counts["done"]),
            "serve_tokens_per_sec": rate(tokens),
            "serve_prefill_tokens_per_sec": rate(prefill_tokens),
            "serve_decode_tokens_per_sec": rate(decode_tokens),
            "serve_prefix_cache_hit_rate": hit_rate,
            "prefix_cache": prefix_sec,
            "serve_ttft_p50_s": exact_percentile(ttfts, 0.50),
            "serve_ttft_p95_s": exact_percentile(ttfts, 0.95),
            "serve_ttft_p99_s": exact_percentile(ttfts, 0.99),
            "serve_itl_p50_s": exact_percentile(itls, 0.50),
            "serve_itl_p95_s": exact_percentile(itls, 0.95),
            "serve_itl_p99_s": exact_percentile(itls, 0.99),
            # attempt-level queue waits from the merged replica histograms
            # (each admission's claim wait on ITS replica's clock — the
            # fleet-level TTFT above is the original-arrival number)
            "serve_queue_wait_p50_s": qw.quantile(0.50),
            "serve_queue_wait_p95_s": qw.quantile(0.95),
            "serve_queue_wait_p99_s": qw.quantile(0.99),
            "queue_depth_p95": qd.quantile(0.95),
            "queue_depth_high_watermark": depth_hwm,
            "queue_cap": max(r.batcher.queue_cap for r in self.replicas),
            "offered": offered,
            "admitted": counts["done"],
            "shed_requests": counts["shed"],
            "unserved_requests": unserved,
            "serve_shed_rate": (counts["shed"] / offered
                                if offered else 0.0),
            "preempted": self._preempted,
            "serve_goodput_under_slo": (
                (slo_sec or {}).get("goodput_requests_per_sec")
                if slo_sec else None),
            "slo": slo_sec,
            "histograms": merged.snapshot(),
            "device_phase_s": dict(self._phase_sums),
            # the gated headline keys: recovery time = replica-failure
            # detection → the failed-over request's first post-requeue
            # delivery; duplicates == 0 is the measured exactly-once claim
            "serve_failover_recovery_p95_s": exact_percentile(
                recovery, 0.95),
            "serve_duplicate_emissions": journal.duplicate_emissions,
            "serve_fleet": {
                "replicas": len(self.replicas),
                "serving_replicas": len(self._serving()),
                "failed_replicas": [r.id for r in self.replicas
                                    if r.state == "failed"],
                "failovers": len(self._failovers),
                "failover_events": self._failovers[:32],
                "retries": journal.requeues,
                "requeued_requests": len(journal.requeued_rids),
                "lost_requests": counts["lost"],
                "duplicate_emissions": journal.duplicate_emissions,
                "fenced_emissions": journal.fenced_emissions,
                "watchdog_stalls": self._watchdog_stalls,
                "faults_injected": (list(self.fault_injector.fired)
                                    if self.fault_injector is not None
                                    else []),
                "swap_generations": self.swap_generations,
                "min_admitting_replicas": self.min_admitting_replicas,
                "failover_recovery_s": recovery[:128],
                "failover_recovery_p95_s": exact_percentile(
                    recovery, 0.95),
                "per_replica": per_replica,
                "merged_goodput_under_slo": (
                    fleet_good / elapsed
                    if slo is not None and elapsed > 0 else None),
                # telemetry self-accounting (one tracer shared by every
                # replica worker)
                "sink_dropped": tracer_stats.get("dropped", 0),
                "sink_written": tracer_stats.get("written", 0),
                "trace_overhead_s": tracer_stats.get("overhead_s", 0.0),
            },
            "results": results,
        }
        if self.timeline is not None:
            # timeline-derived keys only when sampling is on
            summary["queue_depth_auc"] = sum(
                filter(None, (self.timeline.stat("queue_depth", "auc",
                                                 replica=r.id)
                              for r in self.replicas))) or None
            summary["kv_blocks_in_use_p95"] = max(
                filter(lambda v: v is not None,
                       (self.timeline.stat("kv_blocks_in_use", "p95",
                                           replica=r.id)
                        for r in self.replicas)), default=None)
            summary["timeline_overhead_s"] = self.timeline.overhead_s
        if self.roofline is not None:
            # --roofline keys only when attached: the replicas' analytic
            # counters summed over their summed device seconds, so the
            # MFU/MBU headline is the MEAN utilization of a replica
            rf = self.roofline
            pre_s = self._rf_sums.get("prefill_s", 0.0)
            dec_s = self._rf_sums.get("decode_s", 0.0)
            pre_fps = (self._rf_sums.get("prefill_model_flops", 0.0)
                       / pre_s if pre_s > 0 else None)
            dec_fps = (self._rf_sums.get("decode_model_flops", 0.0)
                       / dec_s if dec_s > 0 else None)
            dec_bps = (self._rf_sums.get("decode_must_read_bytes", 0.0)
                       / dec_s if dec_s > 0 else None)
            summary["serve_prefill_mfu"] = rf.mfu(pre_fps)
            summary["serve_decode_mbu"] = rf.mbu(dec_bps)
            summary["roofline"] = {
                "prefill_model_flops": self._rf_sums.get(
                    "prefill_model_flops", 0.0),
                "decode_model_flops": self._rf_sums.get(
                    "decode_model_flops", 0.0),
                "decode_must_read_bytes": self._rf_sums.get(
                    "decode_must_read_bytes", 0.0),
                "prefill_s": pre_s,
                "decode_s": dec_s,
                "prefill_achieved_flops_per_sec": pre_fps,
                "decode_achieved_flops_per_sec": dec_fps,
                "decode_achieved_bytes_per_sec": dec_bps,
                "prefill_mfu": rf.mfu(pre_fps),
                "decode_mfu": rf.mfu(dec_fps),
                "decode_mbu": rf.mbu(dec_bps),
                "per_replica": [
                    {"replica": rid, **counters}
                    for rid, counters in sorted(
                        self._rf_replica.items())],
                "device": rf.describe(),
            }
        if self.multi_step is not None:
            # multi-step keys only with the option set: total forwards
            # issued and host-gap seconds across every replica window
            summary["serve_multi_step"] = self.multi_step
            summary["serve_dispatches"] = int(
                self._sums.get("serve_dispatches", 0))
            summary["serve_host_gap_s"] = float(
                self._sums.get("serve_host_gap_s", 0.0))
            if self.roofline is not None:
                summary["roofline"]["dispatches"] = \
                    summary["serve_dispatches"]
                summary["roofline"]["host_gap_s"] = \
                    summary["serve_host_gap_s"]
        return summary


def build_replica_kvs(model, params, n_replicas: int, slots: int,
                      **kv_kwargs) -> list[SlotKVCache]:
    """N independent slot tables, each over its OWN deep copy of
    ``model`` (``params``, a state_dict or None, loaded into each copy):
    a weight swap writes in place (module docstring).  n == 0 is legal
    and returns [] — callers extending an already-built first table pass
    n_replicas - 1."""
    if n_replicas < 0:
        raise ValueError(f"n_replicas must be >= 0, got {n_replicas}")
    return [SlotKVCache(copy.deepcopy(model), params, slots, **kv_kwargs)
            for _ in range(n_replicas)]


__all__ = [
    "CorruptionDetected",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "ReplicaSet",
    "RequestJournal",
    "build_replica_kvs",
]
