"""The port's sinks, tracing, timeline and run report
(``observability/{sink,trace,timeline,report}.py``,
``utils/metrics.py``) and their wiring into ``Trainer.fit``, the batcher
and the CLI, held to the JAX package on the CPU at a small size (the GPT
of ``test_torch_train.py``: vocab 64, hidden 32, 2 layers, f32, flash,
dropout 0; the serving GPT of ``test_torch_serving.py``):

* the sink writes whole, schema-stamped lines, counts its drops and
  closes idempotently, as JAX's does; the tracer's records carry JAX's
  envelope, and its aggregates stay exact when two threads record spans;
* one ``Trainer.fit`` from the same converted parameters in both
  packages, with a file-backed tracer, a metrics logger, a timeline, a
  straggler detector and the async checkpoint manager: the same span,
  event and gauge names, metrics records with JAX's keys and values within
  ``rtol=1e-5`` (``test_torch_train.py``'s f32 tolerance), and JAX's
  offline ``analyze.py`` reads the port's trace into the port's own span
  table;
* the port's metrics records at k = 8 and k = 1 are bitwise equal (the
  wall-clock ``time`` field aside);
* the timeline copy throttles, merges and digests as JAX's; the batcher
  with a timeline serves the streams it serves without one, in both
  layouts, and gains exactly JAX's three summary keys; at every sample the
  tables' ``timeline_gauges()`` equal the JAX tables' on the same trace
  (monolithic and paged, bf16 and int8 storage);
* ``build_run_report`` has JAX's keys (the environment's named apart),
  reports absent subsystems as None and a zero elapsed time as 0.0;
* the CLI's telemetry flags parse as JAX's do.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.data import loaders as jloaders
from distributed_tensorflow_tpu.engines.allreduce import Trainer as JaxTrainer
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu.observability import report as jreport
from distributed_tensorflow_tpu.observability import sink as jsink
from distributed_tensorflow_tpu.observability import timeline as jtimeline
from distributed_tensorflow_tpu.observability import trace as jtrace
from distributed_tensorflow_tpu.parallel.mesh import create_mesh
from distributed_tensorflow_tpu.serving import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest,
    SlotKVCache as JaxKV, VirtualClock as JaxClock)
from distributed_tensorflow_tpu.utils import metrics as jmetrics

from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.elastic import StragglerDetector
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.models.convert import gpt_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.observability import (
    SCHEMA_VERSION, AsyncJsonlSink, GaugeSeries, Timeline, Tracer,
    build_run_report, sparkline)
from distributed_tensorflow_tpu_torch.serving import (
    ContinuousBatcher, Request, SlotKVCache, VirtualClock)
from distributed_tensorflow_tpu_torch.utils.checkpoint import (
    AsyncCheckpointManager)
from distributed_tensorflow_tpu_torch.utils.metrics import MetricsLogger

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0, attention_impl="flash")
METRIC = dict(rtol=1e-5, atol=0)


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


# ------------------------------------------------------------- the sink

def test_sink_writes_whole_schema_stamped_lines(tmp_path):
    assert SCHEMA_VERSION == jsink.SCHEMA_VERSION
    with AsyncJsonlSink(tmp_path / "s.jsonl") as sink:
        for i in range(200):
            assert sink.write({"i": i, "pad": "x" * i})
        sink.flush()
        assert sink.stats() == {"written": 200, "dropped": 0}
    recs = _lines(tmp_path / "s.jsonl")
    assert [r["i"] for r in recs] == list(range(200))
    assert all(r["schema_version"] == SCHEMA_VERSION for r in recs)


def test_sink_counts_drops_and_close_is_idempotent(tmp_path):
    stats = []
    for mod, name in ((jsink, "j"), (None, "t")):
        cls = AsyncJsonlSink if mod is None else mod.AsyncJsonlSink
        sink = cls(tmp_path / f"{name}.jsonl", maxsize=4, start=False)
        accepted = [sink.write({"i": i}) for i in range(10)]
        sink.close()
        sink.close()                       # idempotent
        accepted.append(sink.write({"late": 1}))   # after close: a drop
        stats.append((accepted, sink.stats(),
                       [r["i"] for r in _lines(tmp_path / f"{name}.jsonl")]))
    assert stats[0] == stats[1]
    assert stats[1] == ([True] * 4 + [False] * 7,
                        {"written": 4, "dropped": 7}, [0, 1, 2, 3])


# ----------------------------------------------------------- the tracer

def _trace_script(cls, path):
    t = cls(path=path, run_id="r-test", process_index=3)
    with t.span("work", step=1) as attrs:
        attrs["late"] = 2
    t.event("ev", k=1)
    t.gauge("g", 1.5, starvation=0)
    t.counter("c", 2)
    t.counter("c")
    summary, stats = t.span_summary(), t.stats()
    t.close()
    return _lines(path), summary, stats


def test_tracer_envelope_matches_jax(tmp_path):
    (jrecs, jsum, jstats), (trecs, tsum, tstats) = (
        _trace_script(jtrace.Tracer, tmp_path / "j.jsonl"),
        _trace_script(Tracer, tmp_path / "t.jsonl"))
    assert [(r["event"], r["name"]) for r in trecs] == [
        (r["event"], r["name"]) for r in jrecs]
    for a, b in zip(trecs, jrecs):
        assert set(a) == set(b), (a, b)
        for key in ("schema_version", "run", "process", "late", "k",
                    "value", "starvation", "inc", "total"):
            assert a.get(key) == b.get(key), key
    assert tsum.keys() == jsum.keys() and tsum["work"]["count"] == 1
    assert set(tsum["work"]) == set(jsum["work"])
    assert tstats["counters"] == jstats["counters"] == {"c": 3}
    assert set(tstats) == set(jstats)
    assert tstats["overhead_s"] > 0


def test_tracer_aggregates_exact_across_threads():
    """The checkpoint writer records ckpt_write spans while training
    records its own: every span and counter lands."""
    tracer = Tracer()

    def work(name):
        for _ in range(2000):
            with tracer.span(name):
                pass
            tracer.counter("n")

    threads = [threading.Thread(target=work, args=(n,))
               for n in ("a", "b", "a")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    summary = tracer.span_summary()
    assert summary["a"]["count"] == 4000 and summary["b"]["count"] == 2000
    assert tracer.stats()["counters"] == {"n": 6000}


# -------------------------------------------- one fit in both packages

def _lm(n, split="train", seed=3):
    return jloaders.synthetic_lm(n, seq_len=32, vocab_size=64, seed=seed,
                                 split=split)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The same 8-step fit (chunks of 4, a checkpoint every 4 steps) in
    both packages from the same parameters, every telemetry option on."""
    tmp = tmp_path_factory.mktemp("fits")
    x, y = _lm(32)
    out = {}
    jt = JaxTrainer(None, engine=JaxSync(JaxGPT(**SMALL),
                                         mesh=create_mesh(1)), seed=0)
    jt.state = jt.engine.init_state(jax.random.key(0), x[:1])
    tt = Trainer(None, engine=SyncEngine(GPTLM(**SMALL, device="cpu"),
                                         device="cpu"), seed=0)
    tt.state = tt.engine.init_state(torch.Generator().manual_seed(0))
    tt.state.model.load_state_dict(gpt_state_dict(
        jax.tree.map(np.asarray, jt.state.params)))
    from distributed_tensorflow_tpu.elastic import (
        StragglerDetector as JaxStragglers)
    from distributed_tensorflow_tpu.utils.checkpoint import (
        AsyncCheckpointManager as JaxAsyncManager)

    for name, tr, ds_cls, tr_cls, ml_cls, tl_cls, sd_cls, mgr_cls in (
            ("jax", jt, jloaders.Dataset, jtrace.Tracer,
             jmetrics.MetricsLogger, jtimeline.Timeline, JaxStragglers,
             JaxAsyncManager),
            ("port", tt, tloaders.Dataset, Tracer, MetricsLogger, Timeline,
             StragglerDetector, AsyncCheckpointManager)):
        tracer = tr_cls(path=tmp / f"{name}_trace.jsonl")
        ml = ml_cls(tmp / f"{name}_metrics.jsonl")
        tl = tl_cls(interval_s=0.0)
        mgr = mgr_cls(tmp / f"{name}_ckpt")
        r = tr.fit(ds_cls(x=x, y=y, num_classes=64, name="lm_synth"),
                   epochs=2, batch_size=8, log_every=0, steps_per_call=4,
                   checkpoint_manager=mgr, checkpoint_every=4,
                   metrics_logger=ml, tracer=tracer, timeline=tl,
                   straggler_detector=sd_cls(tracer=tracer))
        mgr.close()
        summary = tracer.span_summary()
        ml.close()
        tracer.close()
        out[name] = dict(result=r, spans=summary, timeline=tl,
                         trace=_lines(tmp / f"{name}_trace.jsonl"),
                         metrics=_lines(tmp / f"{name}_metrics.jsonl"),
                         trace_path=tmp / f"{name}_trace.jsonl")
    return out


def _names(records, event):
    return {r["name"] for r in records if r["event"] == event}


def test_fit_trace_names_match_jax(fits):
    j, t = fits["jax"], fits["port"]
    for event in ("span", "event", "gauge"):
        assert _names(t["trace"], event) == _names(j["trace"], event), event
    assert {"compile", "chunk_dispatch", "materialize", "ckpt_snapshot",
            "ckpt_write"} <= _names(t["trace"], "span")
    assert {k: v["count"] for k, v in t["spans"].items()} == {
        k: v["count"] for k, v in j["spans"].items()}
    # the gauge's fields, and the collective_profile event's
    for rec_t, rec_j in ((next(r for r in t["trace"] if r["name"] == n),
                          next(r for r in j["trace"] if r["name"] == n))
                         for n in _names(t["trace"], "gauge")
                         | (_names(t["trace"], "event") - {"trace_start"})):
        assert set(rec_t) == set(rec_j), rec_t["name"]
    assert set(t["result"]["stragglers"]) == set(j["result"]["stragglers"])
    assert t["result"]["stragglers"]["observed"] == \
        j["result"]["stragglers"]["observed"] == 2
    assert t["timeline"].names() == j["timeline"].names() == [
        "chunk_step_time_s", "prefetch_depth"]
    assert t["timeline"].stat("prefetch_depth", "count") == 2


def test_fit_metrics_records_match_jax(fits):
    j, t = fits["jax"]["metrics"], fits["port"]["metrics"]
    assert [r["step"] for r in t] == [r["step"] for r in j] == list(
        range(1, 9))
    for a, b in zip(t, j):
        assert set(a) == set(b), (set(a), set(b))
        for key in set(a) - {"time", "step", "schema_version"}:
            np.testing.assert_allclose(a[key], b[key], err_msg=key, **METRIC)


def test_jax_analyze_reads_the_port_trace(fits):
    from distributed_tensorflow_tpu.observability.analyze import (
        read_jsonl, span_aggregate, trace_summary)

    t = fits["port"]
    records = read_jsonl(t["trace_path"])
    table = span_aggregate(records)
    assert {k: v["count"] for k, v in table.items()} == {
        k: v["count"] for k, v in t["spans"].items()}
    for k, v in table.items():
        assert v["total_s"] == pytest.approx(t["spans"][k]["total_s"])
    assert trace_summary(records)["spans"].keys() == table.keys()


def test_metrics_records_bitwise_across_k(tmp_path):
    x, y = _lm(48)
    recs = {}
    for k in (8, 1):
        tr = Trainer(GPTLM(**dict(SMALL, dropout_rate=0.1), device="cpu"),
                     device="cpu", seed=0)
        ml = MetricsLogger(tmp_path / f"k{k}.jsonl")
        tr.fit(tloaders.Dataset(x=x, y=y, num_classes=64), epochs=2,
               batch_size=8, log_every=0, steps_per_call=k,
               metrics_logger=ml)
        ml.close()
        recs[k] = [{kk: v for kk, v in r.items() if kk != "time"}
                   for r in _lines(tmp_path / f"k{k}.jsonl")]
    assert len(recs[8]) == 12 and recs[8] == recs[1]


# ------------------------------------------------------- the timeline

def _timeline_script(cls, series_cls, spark):
    clock = iter([0.0, 0.1, 0.6, 0.65, 1.2, 1.3, 2.0, 2.05, 2.1, 3.0,
                  3.5, 4.0])
    tl = cls(interval_s=0.5, capacity=4, clock=lambda: next(clock))
    taken = [tl.sample_many({"q": float(i), "skip": None}, group="a")
             for i in range(6)]
    taken += [tl.sample("r", 2.0 * i, replica=1) for i in range(6)]
    other = cls(interval_s=0.0, capacity=4)
    for i in range(3):
        other.series("q").record(10.0 + i, t_mono=0.5 + i, wall=0.0)
    tl.merge(other)
    digest = {k: {f: v for f, v in s.items()} for k, s in
              tl.summary().items()}
    samples = {k: [(t, v) for t, _, v in tl._series[k].samples()]
               for k in tl.names()}
    g = series_cls(capacity=3)
    for i in range(5):
        g.record(float(i), t_mono=float(i), wall=0.0)
    back = series_cls.from_dict(g.to_dict())
    return (taken, tl.names(), digest, samples,
            tl.stat("q", "max"), tl.stat("r", "count", replica=1),
            tl.stat("missing", "p50"), back.summary(), g.dropped,
            spark([1, 5, 2, 8, 3] * 30, width=20))


def test_timeline_copy_matches_jax():
    want = _timeline_script(jtimeline.Timeline, jtimeline.GaugeSeries,
                            jtimeline.sparkline)
    got = _timeline_script(Timeline, GaugeSeries, sparkline)
    assert got == want
    assert got[0][:6] == [True, False, True, False, True, False]
    with pytest.raises(ValueError, match="interval_s"):
        Timeline(interval_s=-1.0)


SERVE = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0)
BLK = 4


@pytest.fixture(scope="module")
def serve_models():
    jm = JaxGPT(**SERVE)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    params = dict(params, token_embed={
        "embedding": params["token_embed"]["embedding"] * 6.0})
    return jm, params, gpt_state_dict(jax.tree.map(np.asarray, params))


def _trace(n=5):
    rng = np.random.default_rng(1)
    return [(i, rng.integers(0, 64, int(rng.integers(3, 12))).astype(
        np.int32), int(rng.integers(2, 8)), float(rng.integers(0, 4)))
        for i in range(n)]


def _port_table(sd, layout, kv_dtype):
    kw = dict(paged_block=BLK) if layout == "paged" else {}
    return SlotKVCache(GPTLM(**SERVE, device="cpu"), sd, 3,
                       kv_layout=layout, prefix_block=BLK, device="cpu",
                       kv_dtype=kv_dtype, prefix_cache_blocks=4, **kw)


def _streams(summary):
    return [(r.rid, r.tokens, r.itl_s) for r in summary["results"]]


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_batcher_timeline_changes_no_token(serve_models, layout):
    _, _, sd = serve_models
    runs = {}
    for on in (False, True):
        kw = dict(timeline=Timeline(interval_s=0.0)) if on else {}
        runs[on] = ContinuousBatcher(
            _port_table(sd, layout, "bfloat16"), clock=VirtualClock(),
            prefill_chunk=4, **kw).run(
                [Request(i, p, n, a) for i, p, n, a in _trace()])
    assert _streams(runs[True]) == _streams(runs[False])
    assert set(runs[True]) - set(runs[False]) == {
        "queue_depth_auc", "kv_blocks_in_use_p95", "timeline_overhead_s"}


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_timeline_gauges_match_jax(serve_models, layout, kv_dtype):
    """Every sample of every series (queue, slots, pending prefills and
    the table's host gauges, the int8 scales counted in the stored
    bytes) on the same trace equals the JAX table's, and the summary
    gains the same keys."""
    jm, params, sd = serve_models
    kw = dict(paged_block=BLK) if layout == "paged" else {}
    jkv = JaxKV(jm, params, slots=3, kv_layout=layout, prefix_block=BLK,
                kv_dtype=kv_dtype, prefix_cache_blocks=4, **kw)
    jtl, ttl = jtimeline.Timeline(interval_s=0.0), Timeline(interval_s=0.0)
    trace = _trace()
    want = JaxBatcher(jkv, clock=JaxClock(), prefill_chunk=4,
                      timeline=jtl).run(
        [JaxRequest(i, p, n, a) for i, p, n, a in trace])
    got = ContinuousBatcher(_port_table(sd, layout, kv_dtype),
                            clock=VirtualClock(), prefill_chunk=4,
                            timeline=ttl).run(
        [Request(i, p, n, a) for i, p, n, a in trace])
    assert [r.tokens for r in got["results"]] == [
        r.tokens for r in want["results"]]
    assert ttl.names() == jtl.names()
    assert {"kv_live_bytes", "kv_live_tokens"} <= set(ttl.names())
    for name in ttl.names():
        assert ttl.series(name).values() == jtl.series(name).values(), name
    assert max(ttl.series("kv_live_bytes").values()) > 0
    # the AUC integrates over the sampler's own monotonic clock, not the
    # batcher's VirtualClock: its value is each run's own
    assert got["kv_blocks_in_use_p95"] == want["kv_blocks_in_use_p95"]
    assert (got["queue_depth_auc"] is None) == (
        want["queue_depth_auc"] is None)


# ------------------------------------------------------ the run report

def _fit_result():
    st = jmetrics.StepTimer()
    st.compile_steps = 8
    st.times = [0.5] * 8 + [0.01] * 24
    return {"elapsed": 4.5, "steps": 32, "steps_per_call": 8,
            "chunk_sizes": [8], "prefetch_depth": 2,
            "prefetch_starvation": 1, "prefetch_fill_wait_s": 0.2,
            "step_time": st.summary(), "preempted": "max_steps_per_lease:30",
            "lease": {"max_steps_per_lease": 30}, "stragglers": {
                "events": 0}}


ENV_JAX = {"jax_version", "device_kind", "xla_flags", "libtpu_init_args"}
ENV_PORT = {"torch_version", "cuda_version", "nccl_version", "device_kind",
            "power_limit_w"}


def test_run_report_keys_match_jax(tmp_path):
    reports = []
    for rep, ml_cls, tr_cls, tl_cls in (
            (jreport, jmetrics.MetricsLogger, jtrace.Tracer,
             jtimeline.Timeline),
            (None, MetricsLogger, Tracer, Timeline)):
        build = build_run_report if rep is None else rep.build_run_report
        ml = ml_cls(None)
        for i in range(1, 33):
            ml.log(i, loss=1.0 / i)
        tracer = tr_cls(path=None)
        with tracer.span("compile", steps=8):
            pass
        tl = tl_cls(interval_s=0.0)
        tl.sample("q", 1.0)
        reports.append(build(_fit_result(), metrics_logger=ml,
                             tracer=tracer, timeline=tl))
    want, got = reports
    assert set(got) == set(want), set(got) ^ set(want)
    assert set(want["environment"]) == ENV_JAX
    assert set(got["environment"]) == ENV_PORT
    assert got["environment"]["torch_version"] == torch.__version__
    for key in set(got) - {"environment", "spans", "timeline",
                           "telemetry_overhead_s", "telemetry_overhead_frac",
                           "compile_total_s"}:
        assert got[key] == want[key], key
    assert got["spans"]["compile"]["count"] == 1
    assert got["timeline"]["series"].keys() == want["timeline"][
        "series"].keys()
    assert 0 <= got["telemetry_overhead_frac"] < 0.05


def test_run_report_none_for_absent_subsystems():
    for build in (jreport.build_run_report, build_run_report):
        report = build({"elapsed": 0.0, "steps": 0})
        for key in ("watchdog", "metrics_sink", "prefetch", "spans",
                    "trace", "health", "timeline", "xla",
                    "peak_hbm_bytes_est", "compile_total_s", "lease",
                    "stragglers", "preempted", "telemetry_overhead_frac"):
            assert report[key] is None, key
        assert report["elapsed_s"] == 0.0
        assert build({"steps": 0})["elapsed_s"] is None
    # ported since: the ledger's and the roofline's sections, present only
    # when given
    from distributed_tensorflow_tpu_torch.observability import (
        ProgramLedger, Roofline)

    assert "roofline" not in build_run_report({"steps": 0})
    report = build_run_report({"steps": 0}, ledger=ProgramLedger(),
                              roofline=Roofline(None))
    assert report["xla"]["program_count"] == 0
    assert report["peak_hbm_bytes_est"] == 0
    assert report["roofline"]["programs"] == []


# ------------------------------------------------------------- the CLI

def test_cli_telemetry_flags_parse_as_jax():
    from distributed_tensorflow_tpu.cli import build_parser as jax_parser

    from distributed_tensorflow_tpu_torch.cli import build_parser

    dests = ("metrics_path", "trace", "timeline", "timeline_interval",
             "profile_dir", "max_steps_per_lease")
    for argv in ([], ["--metrics", "m.jsonl", "--trace", "t.jsonl",
                      "--timeline", "--timeline-interval", "0",
                      "--profile-dir", "p"],
                 ["--metrics-path", "m2.jsonl", "--timeline-interval",
                  "-1", "--max-steps-per-lease", "4"]):
        a, b = build_parser().parse_args(argv), jax_parser().parse_args(argv)
        assert [getattr(a, d) for d in dests] == [getattr(b, d)
                                                  for d in dests], argv
