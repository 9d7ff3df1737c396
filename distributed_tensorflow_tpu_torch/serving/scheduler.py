"""Continuous batcher (port of ``serving/scheduler.py``).

The Orca/vLLM iteration-level loop: between decode iterations it (a)
admits arrived requests into free KV slots, (b) runs ONE decode iteration
over the whole slot table, and (c) evicts finished slots so the next
arrivals claim them mid-flight.  ``mode='static'`` admits only into an
empty table (the restart-per-batch baseline).  ``prefill_chunk > 0`` is
Sarathi-Serve chunked prefill (arXiv:2403.02310): admission claims the
slot and the prompt fills in ≤ budget-token chunks, at most one chunk per
loop iteration; the final chunk samples the first token.

Latency accounting follows the MLPerf convention: TTFT is arrival →
first token (queue wait included), ITL the gap between consecutive token
deliveries, both as p50/p95/p99.  Clocks are injectable: ``WallClock``
(real time) or ``VirtualClock`` (time = decode iterations, deterministic).

All host-side: this module is the JAX package's scheduler over either
table layout (the paged pool's admission gate and ledger are used when the
table has them).  The summary carries the prefix pool's hit rate and
ledger, and under the paged layout the zero-copy hit rate.

* ``draft_kv`` / ``draft_k``: greedy speculative decoding (draft-k →
  verify-1).  A draft table in slot lockstep proposes ``k`` tokens per
  live slot, the target scores all ``k + 1`` positions in one verify
  forward, and each slot accepts the longest draft prefix matching the
  target's argmaxes plus the target's own next token: the stream is
  bitwise the non-speculative one.  Rejected positions roll back by
  length bookkeeping alone (``rewind``).
* ``multi_step=K``: decode runs as fused K-step rounds
  (``SlotKVCache.dispatch_multi``; on the card one CUDA graph replay
  each), pipelined one round ahead: round i+1 is dispatched before round
  i is drained, so admissions wait at most one round.  The stack is
  delivered level by level, as K single iterations would deliver it.
  With a draft attached the outer loop stays per verify round, and the
  draft's proposal loop is one fused round.

* ``slo`` (``observability.SLOMonitor``): every completed request is
  judged against the TTFT and ITL targets, every shed one counts as shed,
  the monitor is reset per window, and the summary carries
  ``serve_goodput_under_slo`` and the monitor's ``slo`` section (both
  None without a monitor).

Over a TP table (``SlotKVCache(mesh=...)``) every rank of the mesh runs
its own batcher on the same requests, and each forward is a collective,
so every rank must make the same host decisions: arrivals at 0 or a
``VirtualClock`` keep them equal (the table's seeded generator draws the
same sampled tokens on every rank).  Wall-clock arrivals after 0 could
admit differently on different ranks, so ``run`` refuses them where the
table's model is cut over more than one 'model' rank.

* ``timeline`` (``observability.Timeline``, ``timeline_tag`` its
  replica key): each iteration samples the queue depth, active slots,
  pending prefills and the table's host gauges (``timeline_gauges``) in
  the pass that records the queue-depth histogram, throttled by the
  timeline's interval, with no device read; the summary then gains
  ``queue_depth_auc``, ``kv_blocks_in_use_p95`` and
  ``timeline_overhead_s`` (only then).

* ``roofline`` (``observability.roofline.Roofline`` built for this
  table, ``Roofline.for_kv``): the batcher tallies the analytic model
  FLOPs of every prefill (the positions actually computed, plus one LM
  head a completed prefill) and decode or verify, and the bytes a decode
  must read, in host counters at boundaries that already exist (no
  device read); the summary then gains ``serve_prefill_mfu``,
  ``serve_decode_mbu`` and a ``roofline`` section (only then), their
  rates over the table's own prefill and decode seconds.  The draft's
  work is not counted.

Disaggregated roles/handoff are not ported yet and raise
``NotImplementedError`` (``DISAGG_ITEM``).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np

from distributed_tensorflow_tpu_torch import not_ported
from distributed_tensorflow_tpu_torch.observability.metrics import (
    MetricsRegistry, exact_percentile)
from distributed_tensorflow_tpu_torch.observability.trace import NULL_TRACER
from distributed_tensorflow_tpu_torch.parallel.mesh import MODEL_AXIS
from distributed_tensorflow_tpu_torch.serving.kv_cache import (
    SlotKVCache, SlotOverflow)


# the ROADMAP Queue 1 item that brings the disaggregated fleet (roles and
# the KV handoff), affinity routing and autoscale
DISAGG_ITEM = "10b. Disaggregated prefill and decode, routing and autoscale"


# ------------------------------------------------------------------ clocks

class WallClock:
    """Real time: arrivals are seconds since ``start()``; idle waits sleep
    in slices of at most ``poll_slice_s``."""

    def __init__(self, poll_slice_s: float = 0.05):
        self._t0 = None
        self.poll_slice_s = float(poll_slice_s)

    def start(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def on_decode_iteration(self) -> None:
        pass  # real time advances itself

    def on_prefill(self, tokens: int) -> None:
        pass  # real time advances itself

    def wait_until(self, t: float) -> None:
        delta = t - self.now()
        if delta > 0:
            time.sleep(delta)


class VirtualClock:
    """Deterministic time: one decode iteration = ``tick`` time units, and
    each prefilled prompt token ``prefill_token_tick`` (default 0)."""

    poll_slice_s = float("inf")   # virtual idle waits jump, never slice

    def __init__(self, tick: float = 1.0, prefill_token_tick: float = 0.0):
        self.t = 0.0
        self.tick = float(tick)
        self.prefill_token_tick = float(prefill_token_tick)

    def start(self) -> None:
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def on_decode_iteration(self) -> None:
        self.t += self.tick

    def on_prefill(self, tokens: int) -> None:
        self.t += tokens * self.prefill_token_tick

    def wait_until(self, t: float) -> None:
        self.t = max(self.t, t)


# ----------------------------------------------------------------- request

@dataclasses.dataclass
class Request:
    """One serving request of the open-loop arrival process."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    eos_id: int | None = None


class RequestQueue:
    """Arrival-ordered queue with a single-consumer claim: ``claim()``
    retries a busy queue a bounded number of times with short doubling
    sleeps, then raises instead of interleaving two schedulers."""

    def __init__(self, requests: Iterable[Request] = ()):
        self._items: list[Request] = sorted(
            requests, key=lambda r: (r.arrival_s, r.rid))
        self.busy = False
        self.claim_attempts = 0   # attempts of the LAST claim() call
        self.depth_high_watermark = 0

    def push(self, request: Request) -> None:
        self._items.append(request)
        self._items.sort(key=lambda r: (r.arrival_s, r.rid))

    def __len__(self) -> int:
        return len(self._items)

    def next_arrival(self) -> float | None:
        return self._items[0].arrival_s if self._items else None

    def pop_ready(self, now: float) -> Request | None:
        if self._items and self._items[0].arrival_s <= now:
            return self._items.pop(0)
        return None

    def depth(self, now: float | None = None) -> int:
        """All queued requests when ``now`` is None, else only those
        already ARRIVED (updates ``depth_high_watermark``)."""
        if now is None:
            return len(self._items)
        d = bisect.bisect_right(self._items, now,
                                key=lambda r: r.arrival_s)
        if d > self.depth_high_watermark:
            self.depth_high_watermark = d
        return d

    def shed_ready(self, now: float, keep: int) -> list[Request]:
        """Remove and return every ARRIVED request beyond the oldest
        ``keep`` (the 429 path: newest arrivals shed first)."""
        ready = self.depth(now)
        n_shed = ready - max(int(keep), 0)
        if n_shed <= 0:
            return []
        shed = self._items[ready - n_shed:ready]
        del self._items[ready - n_shed:ready]
        return shed

    @contextlib.contextmanager
    def claim(self, max_attempts: int = 8, backoff_s: float = 0.005):
        """Claim the queue for one scheduler run (bounded busy-claim)."""
        delay = float(backoff_s)
        self.claim_attempts = 0
        while True:
            self.claim_attempts += 1
            if not self.busy:
                break
            if self.claim_attempts >= max_attempts:
                raise RuntimeError(
                    "RequestQueue is busy: another scheduler run owns it "
                    f"(gave up after {self.claim_attempts} bounded claim "
                    f"attempts)")
            time.sleep(delay)
            delay = min(delay * 2, 0.1)
        self.busy = True
        try:
            yield self
        finally:
            self.busy = False


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome + latency timeline (clock units): queue wait
    (arrival → claim), prefill (claim → first token), then the decode
    gaps ``itl_s``."""

    rid: int
    prompt_len: int
    tokens: list[int]
    arrival_s: float
    admitted_s: float
    first_token_s: float
    finished_s: float = 0.0
    itl_s: list[float] = dataclasses.field(default_factory=list)
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    slo_met: bool | None = None   # None: no SLOMonitor attached
    # speculative decoding (zeros without a draft): draft tokens proposed
    # for this request and accepted by the target's verify
    proposed_tokens: int = 0
    accepted_tokens: int = 0

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def decode_s(self) -> float:
        return self.finished_s - self.first_token_s


class _Live:
    """Host bookkeeping for one in-flight slot."""

    def __init__(self, req: Request, result: RequestResult,
                 req_span, dec_span, last_t: float, req_attrs=None):
        self.req = req
        self.result = result
        self.req_span = req_span     # entered context managers, exited on
        self.dec_span = dec_span     # finish
        self.req_attrs = req_attrs if req_attrs is not None else {}
        self.last_t = last_t


_percentile = exact_percentile


# --------------------------------------------------------------- batcher

class ContinuousBatcher:
    """In-flight request scheduler over a SlotKVCache (module docstring)."""

    def __init__(self, kv: SlotKVCache, *, tracer=NULL_TRACER,
                 clock=None, mode: str = "continuous",
                 prefill_chunk: int = 0, metrics=None, slo=None,
                 queue_cap: int = 0, should_stop=None,
                 draft_kv: SlotKVCache | None = None, draft_k: int = 4,
                 timeline=None, timeline_tag: int | None = None,
                 role: str | None = None, handoff_out=None,
                 roofline=None, multi_step: int | None = None):
        if mode not in ("continuous", "static"):
            raise ValueError(f"mode must be continuous|static, got {mode}")
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 (0 = monolithic prefill), "
                f"got {prefill_chunk}")
        if queue_cap < 0:
            raise ValueError(
                f"queue_cap must be >= 0 (0 = unbounded admission), got "
                f"{queue_cap}")
        if draft_kv is not None:
            if draft_k < 1:
                raise ValueError(
                    f"draft_k must be >= 1 (draft tokens proposed per "
                    f"verify round), got {draft_k}")
            if not (kv.greedy and draft_kv.greedy):
                raise ValueError(
                    "speculative decoding requires greedy sampling on "
                    "both the target and the draft: the exact acceptance "
                    "rule only exists for greedy decode")
            if draft_kv.slots != kv.slots:
                raise ValueError(
                    f"draft slot table ({draft_kv.slots}) must match the "
                    f"target's ({kv.slots}): slots run in lockstep")
            if draft_kv.max_len < kv.max_len:
                raise ValueError(
                    f"draft max_len ({draft_kv.max_len}) must cover the "
                    f"target's ({kv.max_len}): the draft mirrors every "
                    f"slot position")
        if multi_step is not None and int(multi_step) < 1:
            raise ValueError(
                f"multi_step must be >= 1 fused decode iterations per "
                f"dispatch, got {multi_step}")
        if role is not None or handoff_out is not None:
            not_ported("disaggregated roles / KV handoff", DISAGG_ITEM)
        self.kv = kv
        self.draft_kv = draft_kv
        self.draft_k = int(draft_k)
        self.multi_step = None if multi_step is None else int(multi_step)
        # --roofline: the analytic cost model of this table's model (the
        # target's work only: a draft's is never credited)
        self.roofline = roofline
        self._rf_cost = roofline.cost if roofline is not None else None
        self.tracer = tracer
        self.clock = clock if clock is not None else WallClock()
        self.mode = mode
        self.prefill_chunk = int(prefill_chunk)
        self.metrics = metrics
        self.slo = slo
        self.queue_cap = int(queue_cap)
        self.should_stop = should_stop
        self.timeline = timeline
        self.timeline_tag = timeline_tag
        self.idle_polls = 0

    # ------------------------------------------------------------ admission
    def _check_lockstep(self, queue: RequestQueue) -> None:
        """Over a table cut across 'model' ranks, refuse what could make
        the ranks admit apart (module docstring): a wall clock with an
        arrival after 0."""
        mesh = self.kv.model.tp_mesh
        if (mesh is None or mesh.axis_size(MODEL_AXIS) == 1
                or isinstance(self.clock, VirtualClock)):
            return
        late = [r.rid for r in queue._items if r.arrival_s > 0]
        if late:
            raise ValueError(
                f"the table's model is cut over {mesh.axis_size(MODEL_AXIS)}"
                f" 'model' ranks, each with its own batcher: requests "
                f"{late} arrive after 0 on a wall clock, which could admit "
                f"them apart; serve them with a VirtualClock or arrivals "
                f"at 0")

    def _check_capacity(self, req: Request) -> int:
        lp = int(np.asarray(req.prompt).reshape(-1).shape[0])
        if lp + req.max_new_tokens > self.kv.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({lp}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the slot capacity "
                f"max_len={self.kv.max_len}")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be positive")
        return lp

    def _admit(self, req: Request, live: dict[int, _Live]) -> int:
        kv, tracer = self.kv, self.tracer
        lp = self._check_capacity(req)
        t_claim = self.clock.now()
        req_span = tracer.span("request", rid=req.rid, prompt_len=lp,
                               max_new_tokens=req.max_new_tokens)
        req_attrs = req_span.__enter__() or {}
        before = kv.prefill_tokens_computed
        with tracer.span("prefill", rid=req.rid, prompt_len=lp):
            slot, first = kv.insert(req.prompt)
        self.clock.on_prefill(kv.prefill_tokens_computed - before)
        if self._rf_cost is not None:
            # the positions computed (a prefix hit of r tokens leaves
            # r..lp, attending over the cached ones) and one LM head
            done = kv.prefill_tokens_computed - before
            self._rf_prefill_flops += (
                self._rf_cost.prefill_chunk_flops(done, lp - done)
                + self._rf_cost.lm_head_flops)
        if hasattr(kv, "note_admission"):
            # the paged block budget (prompt + decode growth) for can_admit
            kv.note_admission(slot, lp + req.max_new_tokens)
        now = self.clock.now()
        result = RequestResult(
            rid=req.rid, prompt_len=lp, tokens=[first],
            arrival_s=req.arrival_s, admitted_s=now, first_token_s=now,
            queue_wait_s=t_claim - req.arrival_s,
            prefill_s=now - t_claim)
        dec_span = tracer.span("decode", rid=req.rid, slot=slot)
        dec_span.__enter__()
        live[slot] = _Live(req, result, req_span, dec_span, now, req_attrs)
        self._arm_multi(slot, live[slot])
        self._draft_admit(req.prompt, slot, first)
        if self._finished(live[slot]):
            # the prefill's token was the whole continuation
            self._finish(slot, live)
        return first

    def _begin_admit(self, req: Request, pending: dict[int, dict]) -> None:
        """Chunked admission: claim the slot and queue the prompt for
        chunk-by-chunk prefill; the FINAL chunk samples the first token."""
        kv, tracer = self.kv, self.tracer
        lp = self._check_capacity(req)
        t_claim = self.clock.now()
        req_span = tracer.span("request", rid=req.rid, prompt_len=lp,
                               max_new_tokens=req.max_new_tokens)
        req_attrs = req_span.__enter__() or {}
        slot, reused = kv.begin_insert(req.prompt)
        if hasattr(kv, "note_admission"):
            kv.note_admission(slot, lp + req.max_new_tokens)
        pending[slot] = {"req": req, "span": req_span, "lp": lp,
                         "admitted_s": t_claim, "reused": reused,
                         "attrs": req_attrs,
                         "queue_wait_s": t_claim - req.arrival_s}

    def _promote(self, slot: int, pend: dict, first: int,
                 live: dict[int, _Live]) -> None:
        """Final chunk done: the slot joins the decode table."""
        req = pend["req"]
        now = self.clock.now()
        result = RequestResult(
            rid=req.rid, prompt_len=pend["lp"], tokens=[first],
            arrival_s=req.arrival_s, admitted_s=pend["admitted_s"],
            first_token_s=now, queue_wait_s=pend["queue_wait_s"],
            prefill_s=now - pend["admitted_s"])
        dec_span = self.tracer.span("decode", rid=req.rid, slot=slot)
        dec_span.__enter__()
        live[slot] = _Live(req, result, pend["span"], dec_span, now,
                           pend["attrs"])
        self._arm_multi(slot, live[slot])
        self._draft_admit(req.prompt, slot, first)
        if self._finished(live[slot]):
            self._finish(slot, live)

    def _arm_multi(self, slot: int, lv: _Live) -> None:
        """Arm the table's in-device deactivation for a newly live slot
        (``multi_step`` only): the fused rounds stop it once it emits its
        EOS or the tokens it still owes after the prefill's first."""
        if self.multi_step is None:
            return
        remaining = lv.req.max_new_tokens - len(lv.result.tokens)
        self.kv.set_decode_limits(slot, lv.req.eos_id, max(remaining, 0))

    def _draft_admit(self, prompt, slot: int, first: int) -> None:
        """Admit the same prompt into the draft table's same slot (slot
        lockstep).  The draft's own first token is dropped: the pending
        token is the target's."""
        if self.draft_kv is None:
            return
        self.draft_kv.insert(prompt, slot=slot)
        self.draft_kv.tokens[slot] = int(first)

    def _finished(self, lv: _Live) -> bool:
        if len(lv.result.tokens) >= lv.req.max_new_tokens:
            return True
        eos = lv.req.eos_id
        return eos is not None and lv.result.tokens[-1] == eos

    def _finish(self, slot: int, live: dict[int, _Live]) -> None:
        lv = live.pop(slot)
        r = lv.result
        r.finished_s = self.clock.now()
        reg = self._registry
        reg.record("ttft", r.ttft_s)
        reg.record("queue_wait", r.queue_wait_s)
        reg.record("prefill", r.prefill_s)
        for gap in r.itl_s:
            reg.record("itl", gap)
        if self.slo is not None:
            r.slo_met = self.slo.observe(r.ttft_s, r.itl_s)
        lv.req_attrs.update(
            queue_wait_s=r.queue_wait_s, prefill_s=r.prefill_s,
            decode_s=r.decode_s, ttft_s=r.ttft_s, tokens=len(r.tokens),
            **({} if r.slo_met is None else {"slo_met": r.slo_met}))
        lv.dec_span.__exit__(None, None, None)
        lv.req_span.__exit__(None, None, None)
        self.kv.evict(slot)
        if self.draft_kv is not None and self.draft_kv.active[slot]:
            self.draft_kv.evict(slot)
        self._results.append(lv.result)

    def _shed(self, req: Request, depth: int) -> None:
        """Bounded-admission rejection (the 429 path), exactly counted."""
        self._shed_count += 1
        if len(self._shed_rids) < 128:   # bounded: accounting, not a log
            self._shed_rids.append(req.rid)
        self.tracer.event("overload", rid=req.rid, queue_depth=depth,
                          queue_cap=self.queue_cap,
                          arrival_s=req.arrival_s)
        self.tracer.counter("shed_requests")
        if self.slo is not None:
            self.slo.shed()

    def _check_preempt(self, iters: int, queue: RequestQueue) -> bool:
        """Consult the lease-drain hook once (sticky)."""
        if self.should_stop is not None and self._preempted is None:
            reason = self.should_stop(iters)
            if reason:
                self._preempted = reason
                self.tracer.event("serve_preempted", reason=reason,
                                  completed=len(self._results),
                                  unserved=len(queue))
        return self._preempted is not None

    def _idle_wait(self, queue: RequestQueue, iters: int) -> None:
        """Wait for the next arrival in bounded poll slices, consulting
        the lease-drain hook each slice."""
        clock = self.clock
        slice_s = clock.poll_slice_s
        while True:
            now = clock.now()
            nxt = queue.next_arrival()
            if nxt is None or now >= nxt:
                return
            if self._check_preempt(iters, queue):
                return
            self.idle_polls += 1
            clock.wait_until(min(nxt, now + slice_s))

    # ------------------------------------------------------------- the loop
    def _serve(self, queue: RequestQueue, live: dict[int, _Live],
               pending: dict[int, dict],
               on_token: Callable[[int, int], None] | None,
               ) -> tuple[int, int, int]:
        """The iteration loop; returns (decode_iterations, prefills,
        prefill_chunks).  With ``multi_step`` and no draft, the pipelined
        ``_serve_multi`` instead."""
        if self.multi_step is not None and self.draft_kv is None:
            return self._serve_multi(queue, live, pending, on_token)
        clock = self.clock
        decode_iterations = 0
        prefills = 0
        chunks = 0
        while len(queue) or live or pending:
            self._check_preempt(decode_iterations, queue)
            if self._preempted is not None and not (live or pending):
                break
            prefills += self._admission_pass(queue, live, pending, on_token)
            self._shed_pass(queue)
            self._observe_pass(queue, live, pending)
            dc, dp = self._chunk_pass(live, pending, on_token)
            chunks += dc
            prefills += dp
            if not live:
                if pending:
                    continue   # keep chunking: nothing to decode yet
                if queue.next_arrival() is None:
                    break
                self._idle_wait(queue, decode_iterations)
                continue
            emitted = self._decode_round(live)
            decode_iterations += 1
            clock.on_decode_iteration()
            now = clock.now()
            for slot in sorted(live):
                lv = live[slot]
                for j, tok in enumerate(emitted[slot]):
                    lv.result.tokens.append(tok)
                    # ITL per emitted token: a verify round delivers its
                    # accepted tokens at one instant, so the round's first
                    # token carries the gap and the others 0
                    lv.result.itl_s.append((now - lv.last_t) if j == 0
                                           else 0.0)
                    lv.last_t = now
                    self._decode_tokens += 1
                    if on_token is not None:
                        on_token(lv.req.rid, tok)
                    if self._finished(lv):
                        self._finish(slot, live)
                        break
        return decode_iterations, prefills, chunks

    def _admission_pass(self, queue: RequestQueue, live: dict[int, _Live],
                        pending: dict[int, dict],
                        on_token: Callable[[int, int], None] | None) -> int:
        """Admission between decode iterations → prefill count delta."""
        kv, clock = self.kv, self.clock
        prefills = 0
        can_admit = (self._preempted is None
                     and (self.mode == "continuous"
                          or not (live or pending)))
        while can_admit and kv.free_slots:
            req = queue.pop_ready(clock.now())
            if req is None:
                break
            # paged block-exhaustion gate: a free slot is not enough; the
            # request's worst-case block need must fit the free list.  With
            # nothing in flight the pool is as free as it gets, so admit
            # and let BlockPoolExhausted surface an impossible config.
            if (hasattr(kv, "can_admit") and (live or pending)
                    and not kv.can_admit(
                        int(np.asarray(req.prompt).reshape(-1).shape[0]),
                        req.max_new_tokens)):
                queue.push(req)
                self._block_deferrals += 1
                break
            if self.prefill_chunk:
                self._begin_admit(req, pending)
            else:
                first = self._admit(req, live)
                prefills += 1
                if on_token is not None:
                    on_token(req.rid, first)  # the prefill's own token
        return prefills

    def _shed_pass(self, queue: RequestQueue) -> None:
        """Bounded admission: arrived backlog past ``queue_cap`` is shed."""
        if self.queue_cap and self._preempted is None:
            now = self.clock.now()
            depth = queue.depth(now)
            for req in queue.shed_ready(now, self.queue_cap):
                self._shed(req, depth)

    def _observe_pass(self, queue: RequestQueue, live: dict[int, _Live],
                      pending: dict[int, dict]) -> None:
        """The arrived backlog, per iteration, into the histogram the
        summary's queue_depth_p95 reads, and the timeline's sample batch
        at the same boundary: host counters only, no device read."""
        clock = self.clock
        self._registry.record("queue_depth", queue.depth(clock.now()))
        if self.timeline is not None:
            self.timeline.sample_many(
                {"queue_depth": queue.depth(clock.now()),
                 "active_slots": len(live),
                 "prefill_pending": len(pending),
                 **self.kv.timeline_gauges()},
                replica=self.timeline_tag, group="batcher")

    def _chunk_pass(self, live: dict[int, _Live], pending: dict[int, dict],
                    on_token: Callable[[int, int], None] | None,
                    ) -> tuple[int, int]:
        """At most ONE ≤budget-token chunk rides each iteration → (chunk,
        prefill) count deltas."""
        if not pending:
            return 0, 0
        kv, tracer, clock = self.kv, self.tracer, self.clock
        slot = next(iter(pending))    # FIFO admission order
        pend = pending[slot]
        n = min(kv.pending_tokens(slot), self.prefill_chunk)
        start = int(kv.lengths[slot])
        with tracer.span("prefill_chunk", rid=pend["req"].rid,
                         slot=slot, tokens=n, start=start):
            first = kv.prefill_chunk(slot, self.prefill_chunk)
        clock.on_prefill(n)
        if self._rf_cost is not None:
            # n new positions over `start` cached ones; the LM head once,
            # on the final chunk's sample
            self._rf_prefill_flops += self._rf_cost.prefill_chunk_flops(
                n, start)
            if first is not None:
                self._rf_prefill_flops += self._rf_cost.lm_head_flops
        if first is None:
            return 1, 0
        pending.pop(slot)
        self._promote(slot, pend, first, live)
        if on_token is not None:
            on_token(pend["req"].rid, first)
        return 1, 1

    # ------------------------------------------------- multi-step pipeline
    def _serve_multi(self, queue: RequestQueue, live: dict[int, _Live],
                     pending: dict[int, dict],
                     on_token: Callable[[int, int], None] | None,
                     ) -> tuple[int, int, int]:
        """The ``multi_step`` loop (JAX ``_serve_multi``): each pass runs
        the admission, shed and chunk passes, DISPATCHES the next fused
        round and only then DRAINS the previous one, so the card decodes
        round i+1 while the host delivers round i.  One round is in flight
        at a time; an admission seen between a dispatch and its drain
        joins the next round."""
        kv, tracer, clock = self.kv, self.tracer, self.clock
        k = self.multi_step
        decode_iterations = 0
        prefills = 0
        chunks = 0
        inflight = None
        while len(queue) or live or pending or inflight is not None:
            self._check_preempt(decode_iterations, queue)
            if self._preempted is not None \
                    and not (live or pending or inflight is not None):
                break
            prefills += self._admission_pass(queue, live, pending, on_token)
            self._shed_pass(queue)
            self._observe_pass(queue, live, pending)
            dc, dp = self._chunk_pass(live, pending, on_token)
            chunks += dc
            prefills += dp
            handle = pre = None
            # slots the device halted (EOS/budget mid-round) never
            # dispatch again: they finish at this round's drain
            if live and any(not kv.halted[s] for s in live):
                # the host lengths at dispatch (JAX's roofline contexts)
                pre = kv.lengths.copy()
                with tracer.span("decode_dispatch", active=len(live), k=k):
                    handle = kv.dispatch_multi(k)
            if inflight is not None:
                h, pre_prev = inflight
                inflight = None
                toks, acts = kv.drain_multi(h)
                decode_iterations += self._deliver_multi(
                    live, toks, acts, pre_prev, on_token)
                # a live slot still halted after delivery met the device's
                # stop conditions without ``_finished`` agreeing: only the
                # table's end (length == max_len) does that
                for slot in sorted(live):
                    if kv.halted[slot]:
                        raise SlotOverflow(
                            f"slot {slot} reached max_len={kv.max_len} "
                            f"mid-round with "
                            f"{live[slot].req.max_new_tokens} tokens "
                            "requested — admission must bound "
                            "prompt+max_new_tokens to max_len")
            if handle is not None:
                inflight = (handle, pre)
                continue
            if live or pending:
                continue
            if queue.next_arrival() is None:
                break
            self._idle_wait(queue, decode_iterations)
        return decode_iterations, prefills, chunks

    def _deliver_multi(self, live: dict[int, _Live], toks: np.ndarray,
                       acts: np.ndarray, pre: np.ndarray,
                       on_token: Callable[[int, int], None] | None) -> int:
        """Replay a drained (k, slots) stack level by level as if each
        level were one decode iteration → the iterations delivered.  Each
        non-empty level advances the clock once and stamps each of its
        tokens with ``now - last_t``: under ``VirtualClock`` the k = 1
        attribution exactly.  Levels where every slot had stopped deliver
        nothing and are not counted.  ``pre``: the host lengths at the
        round's dispatch (the roofline's contexts)."""
        clock = self.clock
        iterations = 0
        for j in range(acts.shape[0]):
            if not acts[j].any():
                continue
            if self._rf_cost is not None:
                # level j's context: the dispatch-time length + j
                self._tally_decode([int(pre[s]) + j for s in sorted(live)
                                    if acts[j, s]])
            clock.on_decode_iteration()
            now = clock.now()
            iterations += 1
            for slot in np.flatnonzero(acts[j]):
                slot = int(slot)
                if slot not in live:
                    continue
                lv = live[slot]
                tok = int(toks[j, slot])
                lv.result.tokens.append(tok)
                lv.result.itl_s.append(now - lv.last_t)
                lv.last_t = now
                self._decode_tokens += 1
                if on_token is not None:
                    on_token(lv.req.rid, tok)
                if self._finished(lv):
                    self._finish(slot, live)
        return iterations

    # ------------------------------------------------- speculative decode
    def _decode_round(self, live: dict[int, _Live]) -> dict[int, list[int]]:
        """One target decode iteration → each live slot's emitted tokens:
        one from ``advance``, or, with a draft that can help this round,
        up to ``draft_k + 1`` from a draft-k → verify-1 round."""
        k_eff = self._spec_k(live) if self.draft_kv is not None else 0
        if k_eff < 1:
            if self._rf_cost is not None:
                self._tally_decode([int(self.kv.lengths[s])
                                    for s in sorted(live)])
            with self.tracer.span("decode_step", active=len(live)):
                toks = self.kv.advance()
            return {slot: [int(toks[slot])] for slot in live}
        return self._spec_round(live, k_eff)

    def _tally_decode(self, contexts: list[int]) -> None:
        """The roofline's decode tallies of one step over slots at these
        context lengths: each slot's token FLOPs, and the step's
        must-read bytes (the weights once, each slot's KV)."""
        if contexts:
            self._rf_decode_flops += sum(
                self._rf_cost.decode_flops_per_token(c) for c in contexts)
            self._rf_decode_bytes += self._rf_cost.decode_step_bytes(
                contexts)

    def _spec_k(self, live: dict[int, _Live]) -> int:
        """This round's draft budget: ``draft_k`` capped by the room left
        in every live slot (all k + 1 verify positions must fit) and by
        the longest remaining request (one round emits at most k + 1)."""
        kv = self.kv
        cap = min(kv.max_len - int(kv.lengths[s]) for s in live) - 1
        needed = max(lv.req.max_new_tokens - len(lv.result.tokens)
                     for lv in live.values()) - 1
        return min(self.draft_k, cap, needed)

    def _spec_round(self, live: dict[int, _Live],
                    k_eff: int) -> dict[int, list[int]]:
        """Draft-k → verify-1 (JAX ``_spec_round``): the draft proposes
        ``k_eff`` tokens for every live slot (one fused round with
        ``multi_step`` and ``k_eff > 1``, else ``k_eff`` single steps),
        the target scores all ``k_eff + 1`` positions in one verify, and
        each slot accepts the longest draft prefix matching the target's
        argmaxes plus the target's own next token.  The draft resyncs by
        ``rewind``; a fully accepted slot never consumed its last
        proposal, so it takes one masked catch-up step."""
        kv, draft, tracer = self.kv, self.draft_kv, self.tracer
        slots = sorted(live)
        base = {s: int(kv.lengths[s]) for s in slots}
        if self._rf_cost is not None:
            # the target's verify FLOPs; the bytes of one step (the
            # verify width widens activations, not weight or KV reads)
            self._rf_decode_flops += sum(
                self._rf_cost.verify_flops(base[s], k_eff + 1)
                for s in slots)
            self._rf_decode_bytes += self._rf_cost.decode_step_bytes(
                [base[s] for s in slots])
        block = np.zeros((kv.slots, k_eff + 1), np.int32)
        block[:, 0] = kv.tokens
        with tracer.span("draft_propose", active=len(live), k=k_eff):
            if self.multi_step is not None and k_eff > 1:
                stack, _ = draft.advance_multi(k_eff)
                block[:, 1:] = stack.T
                self._draft_iterations += k_eff
            else:
                for j in range(k_eff):
                    block[:, j + 1] = draft.advance()
                    self._draft_iterations += 1
        with tracer.span("decode_step", active=len(live),
                         verify_width=k_eff + 1):
            g = kv.verify_block(block)
        emitted: dict[int, list[int]] = {}
        full = np.zeros(kv.slots, np.bool_)
        for s in slots:
            a = 0
            while a < k_eff and block[s, a + 1] == g[s, a]:
                a += 1
            emitted[s] = [int(t) for t in g[s, :a + 1]]
            lv = live[s]
            lv.result.proposed_tokens += k_eff
            lv.result.accepted_tokens += a
            self._proposed += k_eff
            self._accepted += a
            kv.commit_block(s, a + 1, int(g[s, a]))
            if a < k_eff:
                # the draft's positions base..base+a already hold the
                # committed tokens' K/V: drop the rest by length
                draft.rewind(s, base[s] + a + 1, int(g[s, a]))
            else:
                full[s] = True
        if full.any():
            # one masked draft step writes the last proposal's K/V (the
            # draft's pending token), then the target's bonus token
            # becomes the pending one
            draft.advance(only=full)
            self._draft_catchup += 1
            for s in slots:
                if full[s]:
                    draft.tokens[s] = emitted[s][-1]
        return emitted

    def run(self, requests: Iterable[Request] | RequestQueue,
            on_token: Callable[[int, int], None] | None = None,
            ) -> dict[str, Any]:
        """Serve every request to completion; returns the summary dict
        (per-request results under ``results``).  ``on_token(rid, token)``
        is the streaming hook."""
        queue = (requests if isinstance(requests, RequestQueue)
                 else RequestQueue(requests))
        self._check_lockstep(queue)
        offered = len(queue)
        self._results: list[RequestResult] = []
        self._decode_tokens = 0
        self.idle_polls = 0
        self._registry = MetricsRegistry()
        self._shed_count = 0
        self._shed_rids: list[int] = []
        self._block_deferrals = 0
        self._preempted: str | None = None
        # speculative ledger (zeros without a draft): accepted + rejected
        # == proposed exactly
        self._proposed = 0
        self._accepted = 0
        self._draft_iterations = 0
        self._draft_catchup = 0
        # the roofline's tallies (stay 0 without one): analytic model
        # FLOPs of prefill and decode, a decode's must-read bytes
        self._rf_prefill_flops = 0.0
        self._rf_decode_flops = 0.0
        self._rf_decode_bytes = 0.0
        if self.slo is not None:
            self.slo.reset()   # one monitor measures one window
        live: dict[int, _Live] = {}
        pending: dict[int, dict] = {}
        prefix_before = self.kv.prefix_cache_stats()
        prefill_before = self.kv.prefill_tokens_computed
        phases_before = self.kv.phase_times()
        # cumulative pool counters: the summary reports deltas over this run
        paged_before = (self.kv.paged_stats()
                        if hasattr(self.kv, "paged_stats") else None)
        # forwards issued (both tables) as a delta over this run, and the
        # real wall time: the host gap that fused rounds shrink is wall
        # time outside the tables' forwards, whatever the clock
        disp_before = self._dispatches()
        with queue.claim():
            self.clock.start()
            t_start = self.clock.now()
            wall0 = time.perf_counter()
            try:
                decode_iterations, prefills, chunks = self._serve(
                    queue, live, pending, on_token)
            except BaseException:
                # a torn fused round first: its host mirrors lag the
                # device, and evict() below edits them
                self.kv.abandon_multi()
                if self.draft_kv is not None:
                    self.draft_kv.abandon_multi()
                # a failed window must not poison the slot table: free the
                # in-flight slots (decoding and mid-prefill, and their
                # draft slots) and close their spans
                for slot in sorted(live):
                    lv = live.pop(slot)
                    lv.dec_span.__exit__(None, None, None)
                    lv.req_span.__exit__(None, None, None)
                    self.kv.evict(slot)
                    if (self.draft_kv is not None
                            and self.draft_kv.active[slot]):
                        self.draft_kv.evict(slot)
                for slot in sorted(pending):
                    pend = pending.pop(slot)
                    pend["span"].__exit__(None, None, None)
                    if self.kv.has_pending(slot):
                        self.kv.abort_insert(slot)
                    elif self.kv.active[slot]:
                        self.kv.evict(slot)
                raise
            wall_elapsed = time.perf_counter() - wall0
            elapsed = self.clock.now() - t_start
        results = sorted(self._results, key=lambda r: r.rid)
        ttfts = [r.ttft_s for r in results]
        itls = [g for r in results for g in r.itl_s]
        queue_waits = [r.queue_wait_s for r in results]
        tokens = sum(len(r.tokens) for r in results)
        slo_sec = (self.slo.summary(elapsed) if self.slo is not None
                   else None)
        if self.metrics is not None:
            self.metrics.merge(self._registry)
        phases_after = self.kv.phase_times()
        prefill_tokens = self.kv.prefill_tokens_computed - prefill_before
        # prefix-pool ledger (None: pool off): deltas over this run, and
        # the block-level hit rate
        prefix_after = self.kv.prefix_cache_stats()
        prefix_sec = hit_rate = None
        if prefix_after is not None:
            prefix_sec = {
                k: prefix_after[k] - (prefix_before or {}).get(k, 0)
                for k in ("hits", "misses", "evictions", "tokens_reused",
                          "inserted_blocks")}
            prefix_sec["cached_blocks"] = prefix_after["cached_blocks"]
            asked = prefix_sec["hits"] + prefix_sec["misses"]
            hit_rate = prefix_sec["hits"] / asked if asked else 0.0
        # paged pool (None under monolithic): current utilization, the
        # zero-copy/CoW ledger as deltas; the zero-copy hit rate is blocks
        # aliased by pointer over blocks asked of the prefix pool
        paged_sec = zero_copy_rate = None
        if paged_before is not None:
            paged_after = self.kv.paged_stats()
            paged_sec = {
                k: paged_after[k] - paged_before.get(k, 0)
                for k in ("zero_copy_hits", "zero_copy_blocks",
                          "zero_copy_tokens", "cow_copies")}
            for k in ("num_blocks", "block", "blocks_in_use", "utilization"):
                paged_sec[k] = paged_after[k]
            paged_sec["block_deferrals"] = self._block_deferrals
            if prefix_sec is not None:
                asked = prefix_sec["hits"] + prefix_sec["misses"]
                zero_copy_rate = (paged_sec["zero_copy_blocks"] / asked
                                  if asked else 0.0)

        def rate(n):
            return n / elapsed if elapsed > 0 else None

        device_phase = {k: phases_after[k] - phases_before.get(k, 0.0)
                        for k in phases_after}
        summary = {
            "mode": self.mode,
            "requests": len(results),
            "completed": len(results),
            "serve_kv_dtype": self.kv.kv_dtype,
            "serve_kv_bytes_per_slot": self.kv.kv_bytes_per_slot(),
            "serve_kv_layout": self.kv.kv_layout,
            "serve_kv_blocks_in_use": (paged_sec["blocks_in_use"]
                                       if paged_sec else None),
            "serve_kv_block_utilization": (paged_sec["utilization"]
                                           if paged_sec else None),
            "serve_prefix_zero_copy_hit_rate": zero_copy_rate,
            "serve_kv_block_deferrals": self._block_deferrals,
            "paged": paged_sec,
            # speculative decoding: the accept rate over this run's
            # proposals (None without a draft) and the ledger
            "serve_accept_rate": (self._accepted / self._proposed
                                  if self._proposed else None),
            "speculative": (None if self.draft_kv is None else {
                "draft_k": self.draft_k,
                "proposed_tokens": self._proposed,
                "accepted_tokens": self._accepted,
                "rejected_tokens": self._proposed - self._accepted,
                "draft_iterations": self._draft_iterations,
                "draft_catchup_steps": self._draft_catchup,
                "draft_kv_dtype": self.draft_kv.kv_dtype,
            }),
            "decode_iterations": decode_iterations,
            "prefills": prefills,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": chunks,
            "prefill_tokens": prefill_tokens,
            "decode_tokens": self._decode_tokens,
            "idle_polls": self.idle_polls,
            "tokens_generated": tokens,
            "elapsed_s": elapsed,
            "serve_requests_per_sec": rate(len(results)),
            "serve_tokens_per_sec": rate(tokens),
            "serve_prefill_tokens_per_sec": rate(prefill_tokens),
            "serve_decode_tokens_per_sec": rate(self._decode_tokens),
            "serve_prefix_cache_hit_rate": hit_rate,
            "prefix_cache": prefix_sec,
            "serve_ttft_p50_s": _percentile(ttfts, 0.50),
            "serve_ttft_p95_s": _percentile(ttfts, 0.95),
            "serve_ttft_p99_s": _percentile(ttfts, 0.99),
            "serve_itl_p50_s": _percentile(itls, 0.50),
            "serve_itl_p95_s": _percentile(itls, 0.95),
            "serve_itl_p99_s": _percentile(itls, 0.99),
            "serve_queue_wait_p50_s": _percentile(queue_waits, 0.50),
            "serve_queue_wait_p95_s": _percentile(queue_waits, 0.95),
            "serve_queue_wait_p99_s": _percentile(queue_waits, 0.99),
            "queue_depth_p95": self._registry.histogram(
                "queue_depth").quantile(0.95),
            "queue_depth_high_watermark": queue.depth_high_watermark,
            "queue_cap": self.queue_cap,
            "offered": offered,
            "admitted": len(results),
            "shed_requests": self._shed_count,
            "shed_rids": list(self._shed_rids),
            "unserved_requests": len(queue),
            "serve_shed_rate": (self._shed_count / offered
                                if offered else 0.0),
            "preempted": self._preempted,
            # goodput under the SLO (requests/sec meeting both targets;
            # None without a monitor) and the monitor's section
            "serve_goodput_under_slo": (
                slo_sec.get("goodput_requests_per_sec")
                if slo_sec else None),
            "slo": slo_sec,
            "histograms": self._registry.snapshot(),
            "device_phase_s": device_phase,
            "results": results,
        }
        if self.roofline is not None:
            # only with a Roofline (the key set without it is unchanged):
            # the analytic tallies over the table's own phase seconds;
            # None on an unknown card (a peak is never invented)
            rf = self.roofline
            pre_s = device_phase.get("prefill_s", 0.0)
            dec_s = device_phase.get("decode_s", 0.0)
            pre_fps = (self._rf_prefill_flops / pre_s
                       if pre_s > 0 else None)
            dec_fps = (self._rf_decode_flops / dec_s
                       if dec_s > 0 else None)
            dec_bps = (self._rf_decode_bytes / dec_s
                       if dec_s > 0 else None)
            summary["serve_prefill_mfu"] = rf.mfu(pre_fps)
            summary["serve_decode_mbu"] = rf.mbu(dec_bps)
            summary["roofline"] = {
                "prefill_model_flops": self._rf_prefill_flops,
                "decode_model_flops": self._rf_decode_flops,
                "decode_must_read_bytes": self._rf_decode_bytes,
                "prefill_s": pre_s,
                "decode_s": dec_s,
                "prefill_achieved_flops_per_sec": pre_fps,
                "decode_achieved_flops_per_sec": dec_fps,
                "decode_achieved_bytes_per_sec": dec_bps,
                "prefill_mfu": rf.mfu(pre_fps),
                "decode_mfu": rf.mfu(dec_fps),
                "decode_mbu": rf.mbu(dec_bps),
                "device": rf.describe(),
            }
        if self.multi_step is not None:
            # only with the option set (the key set without it is the
            # single-step one): forwards issued, and wall time less the
            # tables' host-observed forward time — scheduling, uploads,
            # the waits for tokens
            summary["serve_multi_step"] = self.multi_step
            summary["serve_dispatches"] = self._dispatches() - disp_before
            summary["serve_host_gap_s"] = max(
                wall_elapsed - device_phase.get("prefill_s", 0.0)
                - device_phase.get("decode_s", 0.0), 0.0)
            if self.roofline is not None:
                summary["roofline"]["dispatches"] = summary[
                    "serve_dispatches"]
                summary["roofline"]["host_gap_s"] = summary[
                    "serve_host_gap_s"]
        if self.timeline is not None:
            # only with sampling on (the key set without it is unchanged)
            tag = self.timeline_tag
            summary["queue_depth_auc"] = self.timeline.stat(
                "queue_depth", "auc", replica=tag)
            summary["kv_blocks_in_use_p95"] = self.timeline.stat(
                "kv_blocks_in_use", "p95", replica=tag)
            summary["timeline_overhead_s"] = self.timeline.overhead_s
        return summary

    def _dispatches(self) -> int:
        return self.kv.dispatch_count + (
            self.draft_kv.dispatch_count if self.draft_kv is not None else 0)
