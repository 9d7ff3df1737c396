"""Offline analysis of the telemetry streams (port of
``observability/analyze.py``; a copy of the JAX module with its imports
pointed at the port's ``timeline``, ``xla_stats`` and ``roofline``).  Its
CLI, ``python -m distributed_tensorflow_tpu_torch.observability.analyze``,
turns the files a run wrote into answers:

  spans TRACE.jsonl        span aggregation + stall/starvation summary
  export TRACE.jsonl -o F  Chrome-trace-event JSON — load F in Perfetto
                           (https://ui.perfetto.dev) or chrome://tracing
  health METRICS.jsonl     health timeline: first anomaly step, stat maxima
  serve TRACE.jsonl        per-request serving waterfall
                           (queue→prefill-chunks→decode) from the
                           scheduler's request/prefill_chunk spans +
                           overload shed events; --text renders bars
  diff BASE NEW            run-vs-run regression diff of two run reports;
                           exits nonzero iff a metric regressed beyond
                           --threshold
  timeline TRACE.jsonl     the --timeline gauge series (queue depth, KV
                           blocks, chunk step time) rendered as text
                           sparklines per series from the trace file
                           alone; --json emits the exact summaries instead
  programs REPORT          the program ledger (``xla_stats``): per-program
                           capture/build seconds, memory bytes and FLOPs;
                           with --against BASE it becomes the drift gate —
                           exit nonzero when the program set grew or a
                           program's temp bytes grew past --temp-threshold
                           (flops growth warns)
  roofline REPORT          the --roofline attribution table: per-program
                           arithmetic intensity, compute/bandwidth bound
                           and attainable %-of-peak, plus the run's
                           train_mfu / serve_decode_mbu headline — from a
                           run report or a bare manifest, the peaks looked
                           up from the report's ``environment.device_kind``
                           (the card's name); --device/--dtype override
                           the lookup, --json for JSON

Inputs are whatever the sinks wrote: a trace JSONL (``--trace``), a metrics
JSONL (``--metrics-path``), a result JSONL (``--result-path``) or the
harness's printed summary.  ``load_report`` accepts any of them — for
multi-line files the LAST parsable JSON object wins (the summary line),
and a ``run_report`` found inside a summary is flattened into the
comparison.

The module itself is stdlib-only (json/math/argparse), as are the three
sibling modules it reads with; the messages and output are the JAX
module's, so both analyzers print the same answers from the same files.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Any, Iterable

# sibling pure-host modules (stdlib only, like this file): the timeline
# ring buffer/sparkline renderer and the program-manifest differ are the
# read side's data structures
from distributed_tensorflow_tpu_torch.observability.timeline import (
    GaugeSeries, sparkline)
from distributed_tensorflow_tpu_torch.observability.xla_stats import (
    diff_manifests)


def read_jsonl(path: str | Path) -> list[dict]:
    """Parse a JSONL stream.  The sink's crash-durability contract is
    whole-lines-only, so every non-empty line must parse; a torn line is a
    real error, not something to paper over."""
    records = []
    for i, line in enumerate(Path(path).read_text().splitlines(), 1):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{i}: unparsable JSONL line "
                             f"({e.msg})") from e
    return records


# ------------------------------------------------------------ span summary

def span_aggregate(records: Iterable[dict]) -> dict[str, dict[str, float]]:
    """Per-name {count, total_s, max_s, mean_s} over the span records —
    the offline twin of Tracer.span_summary (which only exists while the
    run's process is alive)."""
    agg: dict[str, list] = {}
    for rec in records:
        if rec.get("event") != "span":
            continue
        a = agg.setdefault(rec["name"], [0, 0.0, 0.0])
        a[0] += 1
        a[1] += float(rec.get("dur_s", 0.0))
        a[2] = max(a[2], float(rec.get("dur_s", 0.0)))
    return {name: {"count": c, "total_s": tot, "max_s": mx,
                   "mean_s": tot / c if c else 0.0}
            for name, (c, tot, mx) in sorted(agg.items())}


def trace_summary(records: list[dict]) -> dict[str, Any]:
    """Everything the trace stream can answer offline: the span table, a
    wall-clock estimate, counter totals, and the stall/starvation story
    (prefetch queue-depth gauges, anomaly events, stall events)."""
    spans = span_aggregate(records)
    ts = [float(r["t"]) for r in records if "t" in r]
    ends = [float(r["t"]) + float(r.get("dur_s", 0.0))
            for r in records if "t" in r]
    gauges = [r for r in records if r.get("event") == "gauge"
              and r.get("name") == "prefetch_depth"]
    counters: dict[str, int] = {}
    for r in records:
        if r.get("event") == "counter":
            counters[r["name"]] = r.get("total", 0)
    anomalies = [r for r in records if r.get("event") == "event"
                 and r.get("name") == "anomaly"]
    # serving overload: one `overload` event per shed (429'd) request —
    # surfaced here so `analyze spans` answers "did admission control
    # engage" without a separate tool
    overloads = [r for r in records if r.get("event") == "event"
                 and r.get("name") == "overload"]
    # dispatch gaps: time between consecutive chunk_dispatch span STARTS
    # minus the span's own duration — host-side stall between dispatches
    dispatch = sorted((float(r["t"]), float(r.get("dur_s", 0.0)))
                      for r in records if r.get("event") == "span"
                      and r.get("name") == "chunk_dispatch")
    gaps = [max(b[0] - (a[0] + a[1]), 0.0)
            for a, b in zip(dispatch, dispatch[1:])]
    # checkpoint time split: 'checkpoint' (sync save) and 'ckpt_snapshot'
    # (async backpressure + device snapshot) block the training thread;
    # 'ckpt_write' is the background writer's Orbax write.  NB these are
    # span WALL times — the run report's checkpoint_overlapped_s
    # additionally discounts write seconds the trainer stood blocked on
    # (they live in checkpoint_wait_s), so blocked_s + the report's
    # overlapped_s ≈ the span totals here, never more
    ckpt_blocked = sum(spans.get(n, {}).get("total_s", 0.0)
                       for n in ("checkpoint", "ckpt_snapshot"))
    ckpt_overlapped = spans.get("ckpt_write", {}).get("total_s", 0.0)
    return {
        "records": len(records),
        "spans": spans,
        "wall_s": (max(ends) - min(ts)) if ts else 0.0,
        "counters": counters,
        "stalls": {
            "prefetch_starvation": (max(int(g.get("starvation", 0))
                                        for g in gauges) if gauges else None),
            "zero_depth_gauges": sum(1 for g in gauges
                                     if not g.get("value")),
            "gauges": len(gauges),
            "max_dispatch_gap_s": max(gaps) if gaps else None,
            "checkpoint_blocked_s": ckpt_blocked,
            "checkpoint_overlapped_s": ckpt_overlapped,
            "anomaly_events": len(anomalies),
            "first_anomaly_step": (anomalies[0].get("step")
                                   if anomalies else None),
            "overload_events": len(overloads),
        },
    }


# --------------------------------------------------------- Perfetto export

def _json_safe(value: Any) -> Any:
    """Strict-JSON rendering of an arg value: Python's json module emits
    bare ``Infinity``/``NaN`` tokens that JSON.parse (Perfetto,
    chrome://tracing) rejects — and anomalous runs, the ones most worth
    looking at, carry exactly those values.  Render them as strings."""
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)  # 'inf' / '-inf' / 'nan'
    return value


def to_chrome_trace(records: list[dict]) -> dict[str, Any]:
    """Chrome-trace-event JSON (the format Perfetto and chrome://tracing
    load): every span record becomes exactly ONE complete ('X') event —
    the round-trip tests count on that bijection — events become instants
    ('i'), gauges/counters become counter tracks ('C').  Timestamps are
    the records' monotonic seconds in microseconds; pid is the JAX process
    index (so merged pod timelines separate per process), tid the OS pid."""
    events: list[dict] = []
    procs: dict[int, str] = {}
    for rec in records:
        kind = rec.get("event")
        if "t" not in rec or kind not in ("span", "event", "gauge",
                                          "counter"):
            continue
        pid = int(rec.get("process", 0))
        tid = int(rec.get("pid", 0))
        procs.setdefault(pid, f"{rec.get('host', '?')} "
                              f"(process {pid}, run {rec.get('run', '?')})")
        if kind == "event" and rec.get("name") == "timeline_series":
            # --timeline bulk series → one counter-track sample per ring
            # entry.  Per-replica series get their own pid LANE (Perfetto
            # groups counter tracks by pid), so a fleet trace shows each
            # replica's queue depth / KV blocks as parallel lanes with a
            # named header instead of one interleaved mess.
            replica = rec.get("replica")
            cpid = pid if replica is None else _TIMELINE_PID_BASE + replica
            if replica is not None:
                procs.setdefault(cpid, f"replica {replica} (timeline)")
            series = rec.get("series", "?")
            for t_mono, _wall, value in rec.get("samples", ()):
                events.append({"name": series, "cat": "timeline",
                               "ph": "C", "ts": float(t_mono) * 1e6,
                               "pid": cpid, "tid": 0,
                               "args": {series: _json_safe(value)}})
            continue
        ts = float(rec["t"]) * 1e6
        drop = {"event", "name", "t", "dur_s", "run", "host", "pid",
                "process", "schema_version"}
        if kind in ("gauge", "counter"):
            # only there is 'value' the counter-track payload; an EVENT's
            # value field (e.g. an anomaly's offending stat value) is an
            # arg the operator needs to see
            drop.add("value")
        args = {k: _json_safe(v) for k, v in rec.items() if k not in drop}
        if kind == "span":
            events.append({"name": rec["name"], "cat": "span", "ph": "X",
                           "ts": ts, "dur": float(rec.get("dur_s", 0.0)) * 1e6,
                           "pid": pid, "tid": tid, "args": args})
        elif kind == "event":
            events.append({"name": rec["name"], "cat": "event", "ph": "i",
                           "ts": ts, "s": "t", "pid": pid, "tid": tid,
                           "args": args})
        elif kind == "gauge":
            events.append({"name": rec["name"], "cat": "gauge", "ph": "C",
                           "ts": ts, "pid": pid, "tid": tid,
                           "args": {rec["name"]: rec.get("value", 0)}})
        else:  # counter
            events.append({"name": rec["name"], "cat": "counter", "ph": "C",
                           "ts": ts, "pid": pid, "tid": tid,
                           "args": {rec["name"]: rec.get("total", 0)}})
    events.sort(key=lambda e: e["ts"])
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "ts": 0,
             "args": {"name": label}} for pid, label in sorted(procs.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


# per-replica timeline counter lanes: offset far above any real JAX
# process index so fleet lanes never collide with pod processes
_TIMELINE_PID_BASE = 100000


# ------------------------------------------------------ timeline (gauges)

def timeline_series(records: Iterable[dict]) -> dict[str, GaugeSeries]:
    """Rebuild the run's gauge series from the trace's bulk
    ``timeline_series`` events (Timeline.emit): {series_key: GaugeSeries},
    per-replica series under their ``name@rN`` key.  Lossless — the
    events carry the exact totals alongside the retained ring."""
    out: dict[str, GaugeSeries] = {}
    for rec in records:
        if rec.get("event") != "event" \
                or rec.get("name") != "timeline_series":
            continue
        name = rec.get("series", "?")
        replica = rec.get("replica")
        key = name if replica is None else f"{name}@r{replica}"
        g = GaugeSeries.from_dict({
            "capacity": rec.get("capacity", 512),
            "samples": rec.get("samples", []),
            "count": rec.get("count",
                             len(rec.get("samples", []))
                             + int(rec.get("dropped", 0) or 0)),
            "sum": rec.get("sum", 0.0),
            "vmin": rec.get("vmin"),
            "vmax": rec.get("vmax"),
        })
        if key in out:      # several windows in one trace (bench/sweep)
            out[key].merge(g)
        else:
            out[key] = g
    return out


def timeline_summary(records: list[dict]) -> dict[str, Any]:
    """JSON summary of a trace's timeline: per-series digests
    (GaugeSeries.summary) plus the sampler's self-measured overhead from
    the ``timeline_overhead`` event."""
    series = timeline_series(records)
    overhead = None
    for rec in records:
        if rec.get("event") == "event" \
                and rec.get("name") == "timeline_overhead":
            overhead = (overhead or 0.0) + float(rec.get("overhead_s", 0.0))
    return {
        "series": {k: s.summary() for k, s in sorted(series.items())},
        "series_n": len(series),
        "overhead_s": overhead,
    }


def render_timeline_text(records: list[dict], width: int = 60) -> str:
    """Sparkline rendering of every timeline series — one line per
    series, per-replica lanes grouped under their base name, retained
    window min→max annotated.  Stdlib glyphs only."""
    series = timeline_series(records)
    if not series:
        return "(no timeline_series events in trace — run with --timeline)"
    out = []
    namew = max(len(k) for k in series)
    for key in sorted(series):
        s = series[key]
        d = s.summary()
        drop = f" (+{d['dropped']} dropped)" if d["dropped"] else ""
        out.append(
            f"{key:>{namew}} |{sparkline(s.values(), width):<{width}}| "
            f"min={d['min']:g} max={d['max']:g} last={d['last']:g} "
            f"n={d['count']}{drop}")
    summ = timeline_summary(records)
    if summ["overhead_s"] is not None:
        out.append(f"sampler overhead: {summ['overhead_s'] * 1e3:.3f} ms")
    return "\n".join(out)


# -------------------------------------------------- XLA program manifests

def extract_manifest(report: dict[str, Any]) -> dict[str, Any]:
    """The program-ledger manifest from any artifact shape: a bare
    manifest (``analyze programs`` against another run's saved manifest),
    a run report carrying the ``xla`` section, or a summary whose nested
    run_report carries it (load_report already flattened that case)."""
    if isinstance(report.get("programs"), dict):
        return report
    xla = report.get("xla")
    if isinstance(xla, dict) and isinstance(xla.get("programs"), dict):
        return xla
    raise ValueError(
        "no XLA program manifest found (expected a 'programs' dict or an "
        "'xla' section — was the run launched with --timeline?)")


# ------------------------------------------------------- serving waterfall

def serve_waterfall(records: list[dict]) -> dict[str, Any]:
    """Per-request phase waterfall from a serving trace: the scheduler's
    ``request`` spans carry queue_wait_s/prefill_s/decode_s/ttft_s attrs
    (attached at finish), ``prefill_chunk`` spans carry the chunk-by-
    chunk fill, and ``overload`` events are the shed (429'd) requests.
    One row per request SPAN (not per rid: a bench/sweep trace holds
    several windows that all reuse rids 0..n−1 — every window's spans
    get their own rows, and each chunk attaches to the request span
    whose [start, end] interval contains it), arrival-ordered — the
    queue→prefill-chunks→decode story of every request served.

    Fleet traces (serving/fleet.py) add failover: each ``requeue`` event
    is a retry hop — the retried request's NEXT request span is its new
    segment on the surviving replica.  Same-rid rows get an ``attempt``
    number in time order, retried rows carry the hop's
    ``original_arrival_s`` (retry TTFT is charged from the ORIGINAL
    arrival — the row is keyed to it, not to the requeue time), and the
    hops ride the output as ``requeues``."""
    rows: list[dict[str, Any]] = []
    chunk_recs: list[dict[str, Any]] = []
    shed: list[dict[str, Any]] = []
    requeues: list[dict[str, Any]] = []
    for rec in records:
        kind = rec.get("event")
        rid = rec.get("rid")
        if rid is None:
            continue
        if kind == "event" and rec.get("name") == "requeue":
            requeues.append({"rid": rid, "t": rec.get("t"),
                             "from_replica": rec.get("from_replica"),
                             "to_replica": rec.get("to_replica"),
                             "attempt": rec.get("attempt"),
                             "arrival_s": rec.get("arrival_s"),
                             "emitted": rec.get("emitted"),
                             "reason": rec.get("reason")})
            continue
        if kind == "span" and rec.get("name") == "request":
            rows.append({
                "rid": rid,
                "t": rec.get("t"),
                "dur_s": rec.get("dur_s"),
                "prompt_len": rec.get("prompt_len"),
                "max_new_tokens": rec.get("max_new_tokens"),
                "queue_wait_s": rec.get("queue_wait_s"),
                "prefill_s": rec.get("prefill_s"),
                "decode_s": rec.get("decode_s"),
                "ttft_s": rec.get("ttft_s"),
                "tokens": rec.get("tokens"),
                "slo_met": rec.get("slo_met"),
                "prefill_chunks": [],
            })
        elif kind == "span" and rec.get("name") == "prefill_chunk":
            chunk_recs.append({
                "rid": rid,
                "t": rec.get("t"), "dur_s": rec.get("dur_s"),
                "tokens": rec.get("tokens"), "start": rec.get("start")})
        elif kind == "event" and rec.get("name") == "overload":
            shed.append({"rid": rid, "t": rec.get("t"),
                         "queue_depth": rec.get("queue_depth"),
                         "queue_cap": rec.get("queue_cap")})
    rows.sort(key=lambda r: (r["t"] is None, r["t"]))
    # chunk → request-span attribution by containment: the chunk's entry
    # time falls inside exactly one same-rid request span's interval
    # (windows run sequentially, so same-rid intervals are disjoint);
    # chunks of a request whose span never closed (killed window) drop
    for c in sorted(chunk_recs, key=lambda c: (c["t"] is None, c["t"])):
        if c["t"] is None:
            continue
        for row in rows:
            if (row["rid"] == c["rid"] and row["t"] is not None
                    and row["t"] <= c["t"]
                    <= row["t"] + (row["dur_s"] or 0.0)):
                row["prefill_chunks"].append(
                    {k: v for k, v in c.items() if k != "rid"})
                break
    # failover attribution: a row is a RETRY segment (attempt 2, 3, ...)
    # only when a requeue hop for its rid landed between the previous
    # same-rid row's start and this row's start — bench traces reuse
    # rids 0..n−1 across windows, so bare same-rid counting would tag
    # every later window's rows as phantom retries.  The hop's original
    # arrival keys the retried row (the retry-TTFT accounting rule).
    hops_by_rid: dict[Any, list] = {}
    for q in requeues:
        if q.get("t") is not None:
            hops_by_rid.setdefault(q["rid"], []).append(q)
    last_row: dict[Any, dict[str, Any]] = {}
    for row in rows:   # rows are already time-sorted
        prev = last_row.get(row["rid"])
        attempt, hop = 1, None
        if prev is not None and row["t"] is not None \
                and prev["t"] is not None:
            for q in hops_by_rid.get(row["rid"], ()):
                if prev["t"] <= q["t"] <= row["t"]:
                    hop = q
            if hop is not None:
                # the journal's own attempt number when the hop carries
                # it (a request can hop twice while QUEUED, leaving no
                # span between — prev+1 would undercount against the
                # requeue rows rendered alongside)
                attempt = hop.get("attempt") or (prev["attempt"] + 1)
        row["attempt"] = attempt
        if hop is not None and hop.get("arrival_s") is not None:
            row["original_arrival_s"] = hop["arrival_s"]
        last_row[row["rid"]] = row
    met = [r["slo_met"] for r in rows if r.get("slo_met") is not None]
    return {
        "requests": rows,
        "shed": shed,
        "requeues": requeues,
        "requests_n": len(rows),
        "shed_n": len(shed),
        "requeue_n": len(requeues),
        "slo_met_n": sum(bool(m) for m in met) if met else None,
    }


def render_waterfall_text(wf: dict[str, Any], width: int = 60) -> str:
    """ASCII rendering of ``serve_waterfall``: one bar per request on a
    shared wall-clock axis — '.' queue wait, '=' prefill, '#' decode —
    plus a shed line per 429'd request.  Falls back to span duration when
    a request has no phase attrs (a pre-round-13 trace)."""
    rows = wf["requests"]
    timed = [r for r in rows if r.get("t") is not None]
    if not timed:
        return "(no request spans in trace)"
    t0 = min(r["t"] for r in timed)
    # the span's t is its HOST entry (admission claim); the waterfall
    # starts each bar at claim − queue_wait so the queue phase shows
    starts = [r["t"] - (r.get("queue_wait_s") or 0.0) for r in timed]
    ends = [r["t"] + (r.get("dur_s") or 0.0) for r in timed]
    t0 = min(t0, min(starts))
    span = max(max(ends) - t0, 1e-9)
    scale = width / span
    out = []
    for r, start in zip(timed, starts):
        q = r.get("queue_wait_s") or 0.0
        p = r.get("prefill_s") or 0.0
        d = r.get("decode_s")
        d = (r.get("dur_s") or 0.0) - q - p if d is None else d
        off = int((start - t0) * scale)
        bar = (" " * off + "." * max(int(q * scale), 0)
               + "=" * max(int(p * scale), 1)
               + "#" * max(int(max(d, 0.0) * scale), 1))
        slo = ("" if r.get("slo_met") is None
               else (" SLO+" if r["slo_met"] else " SLO-"))
        # a retry hop's new span segment: tagged with its attempt number
        # and (when the requeue event carried it) the ORIGINAL arrival
        # the retried request's TTFT is charged from
        retry = ""
        if (r.get("attempt") or 1) > 1:
            orig = r.get("original_arrival_s")
            retry = (f" retry#{r['attempt']}"
                     + (f" (orig arrival {orig:.4f}s)"
                        if orig is not None else ""))
        out.append(f"{str(r['rid']):>6} |{bar:<{width + 4}}| "
                   f"q={q:.4f}s p={p:.4f}s d={max(d, 0.0):.4f}s"
                   f"{slo}{retry}")
    for rq in wf.get("requeues", ()):
        # the hop itself: where on the shared axis the request left its
        # dead replica for a survivor (same clamping as shed marks —
        # requeue events are emitted immediately, spans only at exit)
        off = int(max((rq["t"] or 0) - t0, 0.0) * scale)
        off = min(max(off, 0), width + 3)
        out.append(f"{str(rq['rid']):>6} |{' ' * off}>"
                   f"{'':<{max(width + 3 - off, 0)}}"
                   f"| requeue r{rq.get('from_replica')}→"
                   f"r{rq.get('to_replica')} after "
                   f"{rq.get('emitted')} tokens ({rq.get('reason')})")
    for s in wf["shed"]:
        # clamp into the axis: overload events are emitted immediately
        # while request spans only land at exit, so a partial trace can
        # carry sheds PAST the last closed span's end — a negative pad
        # width would crash the formatter
        off = int((max(s["t"] - t0, 0.0)) * scale) if s.get("t") else 0
        off = min(max(off, 0), width + 3)
        out.append(f"{str(s['rid']):>6} |{' ' * off}x"
                   f"{'':<{max(width + 3 - off, 0)}}"
                   f"| shed (429) at depth {s.get('queue_depth')}")
    out.append(f"legend: .=queue =prefill #=decode x=shed >=requeue; "
               f"{wf['requests_n']} served, {wf['shed_n']} shed, "
               f"{wf.get('requeue_n', 0)} requeued")
    return "\n".join(out)


# ----------------------------------------------------------- health files

def health_timeline(records: list[dict], *,
                    max_update_ratio: float = 1.0,
                    loss_spike_factor: float = 10.0) -> dict[str, Any]:
    """Summary of a metrics stream carrying the health keys (or a trace
    stream carrying ``anomaly`` events): first anomaly step, run maxima,
    and the non-finite/threshold step counts — the offline twin of the
    fit result's ``health`` section, recomputable from the file alone.

    The threshold kwargs mirror ``HealthConfig``'s defaults (this module
    stays stdlib-only, so it cannot import the torch-backed health module) —
    pass the run's actual thresholds when they were customized."""
    first = None
    nonfinite_steps = 0
    threshold_steps = 0
    maxima: dict[str, float] = {}
    steps = 0
    anomaly_steps: list[int] = []
    for rec in records:
        if rec.get("event") == "event" and rec.get("name") == "anomaly":
            step = rec.get("step")
            if step is not None and step not in anomaly_steps:
                anomaly_steps.append(step)
            continue
        if "event" in rec or "step" not in rec:
            # trace records (spans/gauges/counters) may carry a 'step'
            # attr (checkpoint/eval spans do) but are not health steps —
            # only metric records (no 'event' envelope) count
            continue
        steps += 1
        nonfinite = bool(rec.get("nonfinite_count"))
        crossed = False
        for key in ("grad_norm", "param_norm", "update_norm",
                    "update_ratio", "loss_spike", "loss"):
            v = rec.get(key)
            if v is None:
                continue
            if not math.isfinite(v):
                nonfinite = True
                continue
            if key != "loss":
                maxima[key] = max(maxima.get(key, v), v)
            if key == "update_ratio" and v > max_update_ratio:
                crossed = True
            if key == "loss_spike" and v > loss_spike_factor:
                crossed = True
        nonfinite_steps += nonfinite
        threshold_steps += (crossed and not nonfinite)
        if (nonfinite or crossed) and first is None:
            first = rec["step"]
    if anomaly_steps and (first is None or anomaly_steps[0] < first):
        first = anomaly_steps[0]
    return {
        "steps": steps,
        "first_anomaly_step": first,
        "nonfinite_steps": nonfinite_steps,
        "threshold_steps": threshold_steps,
        "anomaly_events": len(anomaly_steps),
        **{f"max_{k}": v for k, v in sorted(maxima.items())},
    }


# ------------------------------------------------------------ run-vs-run

# (key, better-direction) pairs the differ compares when present+numeric in
# BOTH reports.  Covers run reports, fit summaries AND bench.py lines —
# one table so a BENCH_*.json trajectory can be diffed against a run.
_DIFF_METRICS: tuple[tuple[str, str], ...] = (
    ("step_time_p50_s", "lower"), ("step_time_p95_s", "lower"),
    ("step_time_mean_s", "lower"), ("compile_s", "lower"),
    ("elapsed_s", "lower"), ("telemetry_overhead_frac", "lower"),
    ("grad_allreduce_bytes", "lower"),
    # per-device state footprint (--precision; run report AND bench line):
    # the storage numbers mixed precision exists to shrink — param bytes
    # halve under bf16 storage; optimizer bytes are gated too so a master
    # policy's f32 copy (a deliberate, bounded cost) cannot silently grow
    # past what the policy change justified
    ("param_bytes_per_device", "lower"),
    ("opt_state_bytes_per_device", "lower"),
    # fp16 dynamic-loss-scale skips (flattened from the loss_scale
    # section below): a step that skipped did no training — more skips at
    # equal work is a regression
    ("loss_scale_skipped_steps", "lower"),
    # exposed gradient-collective seconds (run report AND bench line —
    # the communication/compute-overlap gate, BASELINE.md: exposed time
    # is the number that must go down; hidden_s is deliberately NOT
    # compared — burying more collective time under compute is the point)
    ("grad_collective_exposed_s", "lower"),
    # training-thread seconds blocked on checkpointing (run report /
    # fit result; overlapped_s is deliberately NOT compared — moving work
    # onto the background writer is the point, not a regression)
    ("checkpoint_wait_s", "lower"),
    # elastic preemption accounting (run report of an --elastic-restore
    # run; BASELINE.md "Preemption accounting"): wall seconds between the
    # restored checkpoint's save and the resume — time nothing trained —
    # and steps whose data-stream position could not be restored (0 = an
    # exact exactly-once resume).  Both lower-is-better: a fatter
    # preemption window or a lossier resume is a regression in
    # time-to-quality even when throughput held.
    ("preemption_lost_s", "lower"),
    ("resume_replay_steps", "lower"),
    # step-time outlier count (flattened from the stragglers section
    # below): more outlier chunks at equal work = a degrading lease
    ("straggler_events", "lower"),
    ("examples_per_sec", "higher"), ("examples_per_sec_per_device", "higher"),
    ("test_accuracy", "higher"),
    # bench.py line vocabulary ("value"'s direction is resolved per line —
    # see _value_direction; today's value-bearing bench metrics are rates)
    ("step_time_p50", "lower"), ("step_time_p95", "lower"),
    ("prefetch_starvation", "lower"), ("grad_bytes_per_step_wire", "lower"),
    ("dispatch_value", "higher"), ("trainer_examples_per_sec", "higher"),
    ("mfu", "higher"),
    # health: anomaly count (flattened from the health section below)
    ("health_anomalies", "lower"),
    # serving (bench --serve line / run report `serve` section, flattened
    # below): latency percentiles gate lower-is-better — TTFT includes
    # queue wait by the BASELINE.md accounting rule, so an admission
    # regression shows up here, not just in throughput — and
    # requests/sec/chip higher.  ITL/TTFT p50s compared too: a p95-only
    # gate would let the median regress behind a stable tail.
    ("serve_requests_per_sec_per_chip", "higher"),
    ("serve_requests_per_sec", "higher"),
    ("serve_tokens_per_sec", "higher"),
    ("serve_ttft_p50_s", "lower"), ("serve_ttft_p95_s", "lower"),
    ("serve_itl_p50_s", "lower"), ("serve_itl_p95_s", "lower"),
    # chunked prefill + prefix caching (round 10): the prefill/decode
    # token split and the prefix-pool hit rate are rates — all
    # higher-is-better (NB every *_per_sec key here must be listed, or
    # the `sec_per`-substring direction bug class regresses silently;
    # the _value_direction unit tests pin each one)
    ("serve_prefill_tokens_per_sec", "higher"),
    ("serve_decode_tokens_per_sec", "higher"),
    ("serve_prefix_cache_hit_rate", "higher"),
    # SLO-aware serving observability (round 13; BASELINE.md "Goodput
    # accounting"): tail latency gates at p99 — the percentile the SLO is
    # written against — queue wait p99 bounds the admission backlog
    # (overload mode exists to keep THIS bounded), goodput-under-SLO and
    # the swept maximum are THE headline serving numbers (higher), and
    # the shed rate at a fixed offered rate must not grow (shedding more
    # at equal load is lost goodput even though shedding per se is the
    # designed overload behavior)
    ("serve_ttft_p99_s", "lower"), ("serve_itl_p99_s", "lower"),
    ("serve_queue_wait_p99_s", "lower"),
    ("serve_goodput_under_slo", "higher"),
    ("serve_max_goodput_under_slo", "higher"),
    ("serve_knee_rate_per_s", "higher"),
    ("serve_shed_rate", "lower"),
    # raw decode speed (round 14): the speculative-decode accept rate is
    # draft-token efficiency — fewer accepts at the same draft config is
    # a regression in verify-step yield (BASELINE.md: cross-run
    # comparisons must state the draft config, the rate is workload-
    # dependent) — and the stored KV bytes per serving slot are the
    # capacity-per-chip number int8/bf16 storage exists to shrink.
    # serve_tokens_per_sec (the gated speculative headline, emitted
    # tokens only) is already listed above.
    ("serve_accept_rate", "higher"),
    ("serve_kv_bytes_per_slot", "lower"),
    # fleet robustness (round 15; BASELINE.md "Failover accounting"):
    # failover recovery — replica-failure detection to the failed-over
    # request's first post-requeue delivery — is the seconds a reader's
    # stream stood still, and duplicate emissions are the exactly-once
    # claim measured (0 by construction; any growth is a journal-fence
    # regression).  Both lower-is-better.
    ("serve_failover_recovery_p95_s", "lower"),
    ("serve_duplicate_emissions", "lower"),
    # paged KV (round 16; BASELINE.md "Paged accounting"): blocks in use
    # at equal workload is the footprint the block pool exists to shrink
    # (aliased prefixes stored once), and the zero-copy hit rate is the
    # fraction of prefix-pool lookups served by pointer aliasing instead
    # of device copies — fewer zero-copy hits at the same trace means
    # admissions are paying prefill for KV the pool already holds.
    ("serve_kv_blocks_in_use", "lower"),
    ("serve_prefix_zero_copy_hit_rate", "higher"),
    # timeline + XLA ledger (round 17; BASELINE.md "Memory/compile
    # accounting"): the summed per-program HBM estimate is the
    # capacity-per-chip number every KV/precision optimization exists to
    # shrink, and total compile seconds at equal work growing means a
    # program-set or cache regression.  The telemetry's own cost is gated
    # too — sink drops are lost observability records, the trace/sampler
    # overheads are the "<1% of wall" budget measured (all lower).
    ("peak_hbm_bytes_est", "lower"),
    ("compile_total_s", "lower"),
    ("sink_dropped", "lower"),
    ("serve_sink_dropped", "lower"),
    ("serve_trace_overhead_s", "lower"),
    ("timeline_overhead_s", "lower"),
    # queue-depth area (requests·s of queueing over the window) and the
    # KV block-footprint p95 — the autoscaler's target signals; at equal
    # offered load, growth is an admission/capacity regression
    ("queue_depth_auc", "lower"),
    ("kv_blocks_in_use_p95", "lower"),
    # heterogeneous fleet (round 18; BASELINE.md "Disaggregation
    # accounting"): the affinity router's fleet-wide prefix hit rate is
    # the number the router exists to raise (fewer hits at the same
    # trace = shared-prefix traffic landing on cold pools); replica-
    # seconds is the capacity actually paid for the window — the
    # autoscaler's whole point is to shrink it at held goodput; and the
    # disagg/homogeneous ITL-p95 ratio on the same seeded trace is the
    # decode-interference number disaggregation exists to shrink (< 1 =
    # disagg wins, growth = the handoff is leaking prefill work back
    # into decode iterations).
    ("serve_fleet_prefix_hit_rate", "higher"),
    ("serve_replica_seconds", "lower"),
    ("disagg_vs_homogeneous_itl_p95", "lower"),
    # roofline utilizations (round 19; BASELINE.md "Roofline
    # accounting"): MFU/MBU are fractions of the hardware actually
    # achieved — THE comparable headline across configs (a rate can rise
    # while utilization falls on a bigger device); all higher-is-better.
    # Cross-run claims must state the peak-table revision the run report
    # carries.
    ("train_mfu", "higher"),
    ("serve_decode_mbu", "higher"),
    ("serve_prefill_mfu", "higher"),
    # multi-step decode dispatch (round 20; BASELINE.md "Dispatch
    # accounting"): host-gap seconds — wall time the device sat idle
    # while Python scheduled, synced D2H, and re-uploaded — is THE
    # number fused dispatch exists to shrink (same seeded trace, same
    # k); dispatches is its denominator, and the per-role replica-
    # seconds split attributes the autoscaled capacity bill per pool.
    ("serve_host_gap_s", "lower"),
    ("serve_dispatches", "lower"),
    ("serve_replica_seconds_prefill", "lower"),
    ("serve_replica_seconds_decode", "lower"),
)


def load_report(path: str | Path) -> dict[str, Any]:
    """One comparable dict from any artifact this repo writes: a JSON
    object, or a JSONL stream whose LAST parsable object wins (result
    sinks append the summary last; bench prints one line).  A nested
    ``run_report`` is flattened under the summary's own keys, and the
    ``health`` section's anomaly count surfaces as ``health_anomalies``."""
    text = Path(path).read_text()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        obj = None
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
        if obj is None:
            raise ValueError(f"{path}: no parsable JSON object found")
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a JSON object, got "
                         f"{type(obj).__name__}")
    flat = dict(obj)
    nested = obj.get("run_report")
    if isinstance(nested, dict):
        # summary keys win where both exist (they are the same numbers)
        flat = {**nested, **{k: v for k, v in obj.items()
                             if k != "run_report"}}
    health = flat.get("health")
    if isinstance(health, dict) and "anomalies" in health:
        flat.setdefault("health_anomalies", health["anomalies"])
    # the fp16 loss-scale section's skip count surfaces flat so scaling
    # regressions diff with the same machinery as everything else
    ls = flat.get("loss_scale")
    if isinstance(ls, dict) and "skipped_steps" in ls:
        flat.setdefault("loss_scale_skipped_steps", ls["skipped_steps"])
    # the straggler section's outlier count surfaces flat (events = how
    # many chunks exceeded factor × the running median step time)
    stragglers = flat.get("stragglers")
    if isinstance(stragglers, dict) and "events" in stragglers:
        flat.setdefault("straggler_events", stragglers["events"])
    # a run report's nested `serve` section surfaces its serve_* metrics
    # at the top level so serving runs diff with the same machinery as
    # training runs (bench --serve lines already emit them flat)
    serve = flat.get("serve")
    if isinstance(serve, dict):
        for key, value in serve.items():
            if key.startswith("serve_"):
                flat.setdefault(key, value)
        # the --timeline gauge digests ride the serve section under their
        # own names (batcher/fleet summary keys, no serve_ prefix) —
        # surface the gated ones flat
        for key in ("queue_depth_auc", "kv_blocks_in_use_p95",
                    "timeline_overhead_s"):
            if isinstance(serve.get(key), (int, float)):
                flat.setdefault(key, serve[key])
        # fleet-mode telemetry self-accounting (serve_fleet subsection)
        fleet = serve.get("serve_fleet")
        if isinstance(fleet, dict) \
                and isinstance(fleet.get("sink_dropped"), (int, float)):
            flat.setdefault("sink_dropped", fleet["sink_dropped"])
    # the run report's trace-sink health: drops are lost observability
    # records — surfaced flat for the lower-is-better gate
    trace = flat.get("trace")
    if isinstance(trace, dict) \
            and isinstance(trace.get("dropped"), (int, float)):
        flat.setdefault("sink_dropped", trace["dropped"])
    return flat


def _value_direction(report: dict[str, Any]) -> str:
    """Better-direction of a bench line's headline ``value``, resolved
    from the line itself: time-valued metrics/units (ms, seconds) are
    lower-is-better, rates (the current bench vocabulary — examples/sec,
    tokens/sec) higher.  Hard-coding 'higher' would invert the verdict
    the day a time-valued bench metric gains a headline value."""
    probe = f"{report.get('metric', '')} {report.get('unit', '')}".lower()
    # rates first: "…_per_sec_per_chip" CONTAINS the substring "sec_per",
    # so the time-per test alone misread every rate-valued bench line as
    # lower-is-better (an examples/sec improvement diffed as a regression)
    if any(s in probe for s in ("per_sec", "per sec", "/sec", "/s ")):
        return "higher"
    # utilization-valued headlines (round 19: MFU/MBU fractions of the
    # hardware peak) are higher-is-better — checked before the time/byte
    # classes so e.g. a "decode_mbu" metric never trips the "byte" test
    if any(s in probe for s in ("mfu", "mbu", "utilization")):
        return "higher"
    if any(s in probe for s in ("_ms", " ms", "ms/", "_s ", "seconds_per",
                                "sec_per", "s/step", "latency",
                                # byte-valued headlines (kv_bytes_per_slot
                                # class): smaller footprint is the win
                                "byte",
                                # latency-ratio headlines (the round-18
                                # disagg line: disagg/homogeneous itl_p95,
                                # < 1 = disagg wins): ITL is a latency
                                "itl")):
        return "lower"
    return "higher"


def diff_reports(base: dict[str, Any], new: dict[str, Any],
                 threshold: float = 0.1) -> dict[str, Any]:
    """Compare every shared numeric metric of the table; a metric REGRESSES
    when it moves in its worse direction by more than ``threshold``
    (relative; a zero baseline uses absolute change).  Returns
    {regressions, improvements, unchanged, compared, threshold} — plus
    ``metric_mismatch`` (and NO comparisons) when the two inputs are bench
    lines for different metrics: a decode line diffed against an attention
    line would otherwise compare unrelated numbers silently."""
    m_a, m_b = base.get("metric"), new.get("metric")
    if m_a is not None and m_b is not None and m_a != m_b:
        return {"compared": 0, "threshold": threshold,
                "metric_mismatch": {"base": m_a, "new": m_b},
                "regressions": [], "improvements": [], "unchanged": []}
    table = _DIFF_METRICS + (("value", _value_direction(base)),)
    regressions, improvements, unchanged = [], [], []
    for key, better in table:
        a, b = base.get(key), new.get(key)
        if not isinstance(a, (int, float)) or not isinstance(b, (int, float)) \
                or isinstance(a, bool) or isinstance(b, bool):
            continue
        if not (math.isfinite(a) and math.isfinite(b)):
            continue
        delta = (b - a) / abs(a) if a else (b - a)
        worse = delta > threshold if better == "lower" \
            else delta < -threshold
        better_move = delta < -threshold if better == "lower" \
            else delta > threshold
        row = {"metric": key, "base": a, "new": b,
               "delta_frac": round(delta, 6), "better": better}
        (regressions if worse else
         improvements if better_move else unchanged).append(row)
    return {
        "compared": len(regressions) + len(improvements) + len(unchanged),
        "threshold": threshold,
        "regressions": regressions,
        "improvements": improvements,
        "unchanged": unchanged,
    }


# --------------------------------------------------- roofline attribution

def _cmd_roofline(args) -> int:
    """``analyze roofline``: render the per-program roofline table —
    arithmetic intensity, compute/bandwidth bound, attainable %-of-peak —
    plus the run's headline utilizations, offline from a run report or a
    bare manifest (stdlib only; the roofline module imports no torch).
    Device kind/dtype come from the report's own roofline section (or
    environment), overridable; an unknown kind degrades honestly —
    intensity still renders, bound/%-of-peak stay None."""
    from distributed_tensorflow_tpu_torch.observability.roofline import (
        PEAK_TABLE_REVISION, device_peaks, program_attribution,
        ridge_point)

    flat = load_report(args.report)
    rf = flat.get("roofline")
    rf = rf if isinstance(rf, dict) else {}
    dev = rf.get("device") or {}
    kind = (args.device or dev.get("device_kind")
            or (flat.get("environment") or {}).get("device_kind"))
    dtype = args.dtype or dev.get("dtype") or "bf16"
    peaks = device_peaks(kind)
    try:
        manifest = extract_manifest(flat)
    except ValueError:
        manifest = {"programs": {}}
    rows = program_attribution(manifest.get("programs", {}),
                               peaks=peaks, dtype=dtype)
    headline = {k: flat.get(k) for k in ("train_mfu", "serve_decode_mbu",
                                         "serve_prefill_mfu")
                if isinstance(flat.get(k), (int, float))}
    out = {
        "device_kind": kind,
        "known_device": peaks is not None,
        "peak_table_revision": (dev.get("peak_table_revision")
                                or PEAK_TABLE_REVISION),
        "dtype": dtype,
        "ridge_flops_per_byte": ridge_point(peaks, dtype),
        **headline,
        "programs": rows,
    }
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    known = "known" if peaks is not None else "UNKNOWN — no peaks"
    ridge = out["ridge_flops_per_byte"]
    print(f"device: {kind or '?'} ({known})  dtype={dtype}  "
          f"peak-table rev {out['peak_table_revision']}"
          + (f"  ridge={ridge:.1f} flops/byte" if ridge else ""))
    if headline:
        print("  ".join(f"{k}={v:.4f}" for k, v in headline.items()))
    if not rows:
        print("no programs with cost-analysis data (run with --roofline "
              "on a backend that reports cost_analysis)")
        return 0
    namew = max(len(r["program"]) for r in rows)

    def _fmt(v, spec, none="-"):
        return format(v, spec) if isinstance(v, (int, float)) else none

    print(f"{'program':<{namew}}  {'flops':>10}  {'bytes':>10}  "
          f"{'flops/B':>8}  {'bound':>9}  {'%peak':>6}")
    for r in rows:
        frac = r["attainable_frac_of_peak"]
        print(f"{r['program']:<{namew}}  "
              f"{_fmt(r['flops'], '10.3g'):>10}  "
              f"{_fmt(r['bytes_accessed'], '10.3g'):>10}  "
              f"{_fmt(r['arithmetic_intensity'], '8.2f'):>8}  "
              f"{r['bound'] or '-':>9}  "
              + (f"{100 * frac:>5.1f}%" if isinstance(frac, (int, float))
                 else f"{'-':>6}"))
    return 0


# ------------------------------------------------------------------- CLI

def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_tensorflow_tpu_torch.observability.analyze",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("spans", help="span aggregation + stall summary")
    sp.add_argument("trace", help="trace JSONL (--trace output)")

    ex = sub.add_parser("export", help="Chrome-trace JSON for Perfetto")
    ex.add_argument("trace", help="trace JSONL (--trace output)")
    ex.add_argument("-o", "--output", default=None,
                    help="output path (default: <trace>.chrome.json)")

    he = sub.add_parser("health", help="health timeline summary")
    he.add_argument("metrics", help="metrics or trace JSONL")
    he.add_argument("--max-update-ratio", type=float, default=1.0,
                    help="update-ratio anomaly ceiling (HealthConfig "
                         "default; pass the run's value if customized)")
    he.add_argument("--spike-factor", type=float, default=10.0,
                    help="loss-spike anomaly factor (HealthConfig default)")

    sv = sub.add_parser("serve", help="per-request serving waterfall "
                                      "(queue→prefill-chunks→decode)")
    sv.add_argument("trace", help="serving trace JSONL (--trace output "
                                  "of a --serve run or bench --serve)")
    sv.add_argument("--text", action="store_true",
                    help="render ASCII bars instead of JSON")
    sv.add_argument("--width", type=int, default=60,
                    help="--text: bar width in characters")

    df = sub.add_parser("diff", help="run-vs-run regression diff "
                                     "(exit 1 iff a metric regressed)")
    df.add_argument("base", help="baseline report/summary/bench JSON(L)")
    df.add_argument("new", help="candidate report/summary/bench JSON(L)")
    df.add_argument("--threshold", type=float, default=0.1,
                    help="relative regression threshold (default 0.1)")

    tl = sub.add_parser("timeline", help="--timeline gauge series as "
                                         "text sparklines (per-replica "
                                         "lanes) from the trace alone")
    tl.add_argument("trace", help="trace JSONL of a --timeline run")
    tl.add_argument("--json", action="store_true",
                    help="emit the per-series summaries as JSON instead")
    tl.add_argument("--width", type=int, default=60,
                    help="sparkline width in characters")

    pg = sub.add_parser("programs",
                        help="--timeline XLA program ledger: memory/"
                             "compile manifest; --against BASE = drift "
                             "gate (exit 1 on added programs or temp-"
                             "bytes growth)")
    pg.add_argument("report", help="run report / summary JSON(L) with an "
                                   "'xla' section, or a bare manifest")
    pg.add_argument("--against", default=None, metavar="BASE",
                    help="baseline report/manifest to diff against")
    pg.add_argument("--temp-threshold", type=float, default=0.10,
                    help="relative temp-bytes growth that fails the gate "
                         "(default 0.10)")

    rl = sub.add_parser("roofline",
                        help="--roofline attribution: per-program "
                             "arithmetic intensity, compute/bandwidth "
                             "bound and attainable %-of-peak from a run "
                             "report (or a bare program manifest)")
    rl.add_argument("report", help="run report / summary JSON(L) with an "
                                   "'xla' section, or a bare manifest")
    rl.add_argument("--device", default=None, metavar="KIND",
                    help="device kind override (default: the report's "
                         "roofline/environment section; unknown kinds "
                         "render intensity only — bound and %-of-peak "
                         "honestly stay None)")
    rl.add_argument("--dtype", default=None,
                    help="peak dtype key (bf16|f32|int8; default: the "
                         "report's roofline dtype, else bf16)")
    rl.add_argument("--json", action="store_true",
                    help="emit the table as JSON instead of text")

    args = p.parse_args(argv)
    if args.cmd == "spans":
        print(json.dumps(trace_summary(read_jsonl(args.trace)), indent=2))
        return 0
    if args.cmd == "export":
        out = args.output or str(args.trace) + ".chrome.json"
        trace = to_chrome_trace(read_jsonl(args.trace))
        Path(out).write_text(json.dumps(trace))
        n = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
        print(f"wrote {out}: {len(trace['traceEvents'])} events "
              f"({n} spans) — load it at https://ui.perfetto.dev",
              file=sys.stderr)
        return 0
    if args.cmd == "serve":
        wf = serve_waterfall(read_jsonl(args.trace))
        if args.text:
            print(render_waterfall_text(wf, width=args.width))
        else:
            print(json.dumps(wf, indent=2))
        return 0
    if args.cmd == "health":
        print(json.dumps(health_timeline(
            read_jsonl(args.metrics),
            max_update_ratio=args.max_update_ratio,
            loss_spike_factor=args.spike_factor), indent=2))
        return 0
    if args.cmd == "timeline":
        records = read_jsonl(args.trace)
        if args.json:
            print(json.dumps(timeline_summary(records), indent=2))
        else:
            print(render_timeline_text(records, width=args.width))
        return 0
    if args.cmd == "programs":
        current = extract_manifest(load_report(args.report))
        if args.against is None:
            print(json.dumps(current, indent=2))
            return 0
        base = extract_manifest(load_report(args.against))
        findings = diff_manifests(current, base,
                                  temp_threshold=args.temp_threshold)
        failed = [f for f in findings if f.get("severity") == "fail"]
        print(json.dumps({"findings": findings,
                          "failed": len(failed),
                          "temp_threshold": args.temp_threshold,
                          "program_count": {
                              "base": len(base.get("programs", {})),
                              "new": len(current.get("programs", {}))}},
                         indent=2))
        # the drift gate: growth in the program set or in a program's
        # temp bytes past threshold fails CI; removals are informational
        return 1 if failed else 0
    if args.cmd == "roofline":
        return _cmd_roofline(args)
    # diff: 0 = no regression, 1 = regression past threshold, 2 = nothing
    # was compared (mismatched bench metrics, or inputs sharing no known
    # metric keys — e.g. an operator diffing two trace files).  A 0 on an
    # empty comparison would read as "no regression" for a typo.
    result = diff_reports(load_report(args.base), load_report(args.new),
                          threshold=args.threshold)
    print(json.dumps(result, indent=2))
    if result.get("metric_mismatch") or result["compared"] == 0:
        return 2
    return 1 if result["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
