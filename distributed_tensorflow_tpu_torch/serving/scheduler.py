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

All host-side: this module is the JAX package's scheduler with the
single-token decode loop only, over either table layout (the paged pool's
admission gate and ledger are used when the table has them).  The summary
carries the prefix pool's hit rate and ledger, and under the paged layout
the zero-copy hit rate.  Speculative decoding (``draft_kv``),
``multi_step``, disaggregated roles/handoff, the roofline, the timeline
sampler and SLO monitors are not ported yet and raise
``NotImplementedError``.
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
from distributed_tensorflow_tpu_torch.serving.kv_cache import SlotKVCache


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
                 draft_kv: SlotKVCache | None = None, timeline=None,
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
            not_ported("speculative decoding (draft_kv)",
                        "speculative verify and advance_multi")
        if multi_step is not None:
            not_ported("multi_step decode",
                        "speculative verify and advance_multi")
        if role is not None or handoff_out is not None:
            not_ported("disaggregated roles / KV handoff", "fleet")
        if slo is not None or timeline is not None or roofline is not None:
            not_ported("SLO monitors, the timeline and the roofline",
                        "rest of observability")
        self.kv = kv
        self.tracer = tracer
        self.clock = clock if clock is not None else WallClock()
        self.mode = mode
        self.prefill_chunk = int(prefill_chunk)
        self.metrics = metrics
        self.queue_cap = int(queue_cap)
        self.should_stop = should_stop
        self.idle_polls = 0

    # ------------------------------------------------------------ admission
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
        if self._finished(live[slot]):
            self._finish(slot, live)

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
        lv.req_attrs.update(
            queue_wait_s=r.queue_wait_s, prefill_s=r.prefill_s,
            decode_s=r.decode_s, ttft_s=r.ttft_s, tokens=len(r.tokens))
        lv.dec_span.__exit__(None, None, None)
        lv.req_span.__exit__(None, None, None)
        self.kv.evict(slot)
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
        prefill_chunks)."""
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
            self._registry.record("queue_depth", queue.depth(clock.now()))
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
                tok = emitted[slot]
                lv.result.tokens.append(tok)
                lv.result.itl_s.append(now - lv.last_t)
                lv.last_t = now
                self._decode_tokens += 1
                if on_token is not None:
                    on_token(lv.req.rid, tok)
                if self._finished(lv):
                    self._finish(slot, live)
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
        if first is None:
            return 1, 0
        pending.pop(slot)
        self._promote(slot, pend, first, live)
        if on_token is not None:
            on_token(pend["req"].rid, first)
        return 1, 1

    def _decode_round(self, live: dict[int, _Live]) -> dict[int, int]:
        """One decode iteration → each live slot's emitted token."""
        with self.tracer.span("decode_step", active=len(live)):
            toks = self.kv.advance()
        return {slot: int(toks[slot]) for slot in live}

    def run(self, requests: Iterable[Request] | RequestQueue,
            on_token: Callable[[int, int], None] | None = None,
            ) -> dict[str, Any]:
        """Serve every request to completion; returns the summary dict
        (per-request results under ``results``).  ``on_token(rid, token)``
        is the streaming hook."""
        queue = (requests if isinstance(requests, RequestQueue)
                 else RequestQueue(requests))
        offered = len(queue)
        self._results: list[RequestResult] = []
        self._decode_tokens = 0
        self.idle_polls = 0
        self._registry = MetricsRegistry()
        self._shed_count = 0
        self._shed_rids: list[int] = []
        self._block_deferrals = 0
        self._preempted: str | None = None
        live: dict[int, _Live] = {}
        pending: dict[int, dict] = {}
        prefix_before = self.kv.prefix_cache_stats()
        prefill_before = self.kv.prefill_tokens_computed
        phases_before = self.kv.phase_times()
        # cumulative pool counters: the summary reports deltas over this run
        paged_before = (self.kv.paged_stats()
                        if hasattr(self.kv, "paged_stats") else None)
        with queue.claim():
            self.clock.start()
            t_start = self.clock.now()
            try:
                decode_iterations, prefills, chunks = self._serve(
                    queue, live, pending, on_token)
            except BaseException:
                # a failed window must not poison the slot table: free the
                # in-flight slots (decoding and mid-prefill) and close
                # their spans
                for slot in sorted(live):
                    lv = live.pop(slot)
                    lv.dec_span.__exit__(None, None, None)
                    lv.req_span.__exit__(None, None, None)
                    self.kv.evict(slot)
                for slot in sorted(pending):
                    pend = pending.pop(slot)
                    pend["span"].__exit__(None, None, None)
                    if self.kv.has_pending(slot):
                        self.kv.abort_insert(slot)
                    elif self.kv.active[slot]:
                        self.kv.evict(slot)
                raise
            elapsed = self.clock.now() - t_start
        results = sorted(self._results, key=lambda r: r.rid)
        ttfts = [r.ttft_s for r in results]
        itls = [g for r in results for g in r.itl_s]
        queue_waits = [r.queue_wait_s for r in results]
        tokens = sum(len(r.tokens) for r in results)
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

        return {
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
            "histograms": self._registry.snapshot(),
            "device_phase_s": {
                k: phases_after[k] - phases_before.get(k, 0.0)
                for k in phases_after},
            "results": results,
        }
