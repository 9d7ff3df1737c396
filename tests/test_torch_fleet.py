"""The serving fleet's replica layer (``serving/fleet.py``) held to the JAX
package on the CPU, on JAX's own tiny GPT (``tests/test_serving_fleet.py``:
vocab 64, hidden 32, 1 layer, 2 heads, f32) carried across by
``models.convert``:

* the same chaos schedules through JAX's ``ReplicaSet`` and the port's on
  a ``VirtualClock`` — no fault, a decode crash, a crash in a prefill
  chunk, a crash between verify and commit with a draft, nonfinite
  logits, retry exhaustion, a hot swap of the same weights and one to the
  weights × 0.5, a paged-table fleet: per-request streams and statuses
  bitwise, and the fleet's counters equal;
* ``FaultSpec.parse``'s grammar and its rejections in JAX's words, the
  seeded ``prob`` schedule, the journal's fence, retry and least-loaded
  routing on the same operation sequences, a threaded wall-clock run
  against the one-replica streams, and ``swap_params``'s refusals;
* the harness's fleet branch (``_serve_from_state``) against JAX's: the
  serve section's keys, ``serve_fleet``'s keys and the streams; its
  validation in JAX's words; ``cli.main --device cpu`` with the four
  fleet flags.

Greedy token streams are compared exactly (f32, one replica's decode is
the same math whatever the batching).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu import serving as jserving
from distributed_tensorflow_tpu.serving import fleet as jfleet
from distributed_tensorflow_tpu.utils import harness as jharness
from distributed_tensorflow_tpu.observability.trace import (
    NULL_TRACER as JAX_NULL_TRACER)
from distributed_tensorflow_tpu_torch import cli as tcli
from distributed_tensorflow_tpu_torch import serving as tserving
from distributed_tensorflow_tpu_torch.models.convert import gpt_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.serving import fleet as tfleet
from distributed_tensorflow_tpu_torch.utils import harness as tharness

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_harness_lm import (
    _jax_ex, _port_ex, _small_lm_fn, _validation_pair)

TINY = dict(vocab_size=64, hidden=32, layers=1, heads=2, ffn=64,
            max_len=48, dropout_rate=0.0)


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny GPT (its fleet tests' ``model_params``), its params and
    their port state_dict."""
    jm = JaxGPT(**TINY)
    x = jnp.asarray(np.random.default_rng(0).integers(0, 64, (2, 8)),
                    jnp.int32)
    params = jm.init(jax.random.key(0), x, train=False)["params"]
    return jm, params, gpt_state_dict(jax.tree.map(np.asarray, params))


def _requests(lib, n=6, seed=3, max_new=8, spread=0.5):
    """JAX's fleet trace (``tests/test_serving_fleet.py`` ``_requests``)
    as ``lib``'s requests."""
    rng = np.random.default_rng(seed)
    return [lib.Request(rid=i, prompt=rng.integers(0, 64, 6 + i % 4)
                        .astype(np.int32), max_new_tokens=max_new,
                        arrival_s=float(i) * spread)
            for i in range(n)]


def _swap_requests(lib):
    """Rids 0-1 complete before the swap, rids 2-3 arrive after it."""
    return [lib.Request(rid=i, prompt=np.arange(5, dtype=np.int32),
                        max_new_tokens=6,
                        arrival_s=0.0 if i < 2 else 50.0)
            for i in range(4)]


def _port_kvs(sd, n, slots, **kw):
    model = GPTLM(**TINY, device="cpu")
    return tfleet.build_replica_kvs(model, sd, n, slots, device="cpu", **kw)


def _jax_kvs(jm, params, n, slots, **kw):
    return jfleet.build_replica_kvs(jm, params, n, slots, **kw)


def _half(sd):
    return {k: v * 0.5 for k, v in sd.items()}


# each schedule: (fault spec, ReplicaSet kwargs, replicas, slots, requests,
# table kwargs, with drafts, swap: None | "same" | "half")
SCHEDULES = {
    "none": (None, {}, 2, 2, "fleet", {}, False, None),
    "crash": ("crash:replica=0,iter=3", {}, 2, 2, "fleet", {}, False, None),
    "prefill-chunk": ("crash:replica=0,prefill=2", dict(prefill_chunk=3),
                      2, 2, "fleet", {}, False, None),
    "verify": ("crash:replica=0,verify=2", dict(draft_k=3), 2, 2, "fleet",
               {}, True, None),
    "nanlogits": ("nanlogits:replica=0,iter=2", {}, 2, 2, "fleet", {},
                  False, None),
    "exhaustion": ("crash:replica=0,iter=2;crash:replica=1,iter=2",
                   dict(retry_limit=1), 2, 2, "fleet", {}, False, None),
    "swap-same": (None, {}, 2, 2, "fleet", {}, False, "same"),
    "swap-half": (None, {}, 1, 2, "swap", {}, False, "half"),
    "paged": ("crash:replica=0,iter=3", {}, 2, 2, "fleet",
              dict(kv_layout="paged", paged_block=8), False, None),
}
FLEET_COUNTERS = ("failovers", "failed_replicas", "requeued_requests",
                  "retries", "duplicate_emissions", "swap_generations",
                  "min_admitting_replicas", "faults_injected")


def _run_schedule(lib, case, tiny):
    """One schedule through ``lib``'s ReplicaSet: (summary, the journal's
    status per rid)."""
    jm, params, sd = tiny
    spec, kw, n, slots, trace, table_kw, drafts, swap = SCHEDULES[case]
    jax_side = lib is jfleet
    mk = ((lambda k: _jax_kvs(jm, params, n, slots, **k)) if jax_side
          else (lambda k: _port_kvs(sd, n, slots, **k)))
    clock = (jserving.VirtualClock() if jax_side
             else tserving.VirtualClock())
    inj = lib.FaultInjector(spec, seed=0) if spec else None
    rs = lib.ReplicaSet(mk(table_kw), clock=clock, fault_injector=inj,
                        draft_kvs=mk({}) if drafts else None, **kw)
    if swap == "same":
        rs.schedule_swap(params if jax_side else sd, after_completions=2)
    elif swap == "half":
        rs.schedule_swap(jax.tree.map(lambda t: t * 0.5, params)
                         if jax_side else _half(sd), after_completions=2)
    reqs = (_requests if trace == "fleet" else _swap_requests)(
        jserving if jax_side else tserving)
    s = rs.run(reqs)
    return s, {rid: e.status for rid, e in rs.journal.entries.items()}


_ORACLES: dict = {}


def _jax_schedule(case, tiny):
    if case not in _ORACLES:
        _ORACLES[case] = _run_schedule(jfleet, case, tiny)
    return _ORACLES[case]


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_equals_jax_replica_set(tiny, case):
    want, want_status = _jax_schedule(case, tiny)
    got, got_status = _run_schedule(tfleet, case, tiny)
    assert got_status == want_status
    assert ({r.rid: r.tokens for r in got["results"]}
            == {r.rid: r.tokens for r in want["results"]})
    for k in FLEET_COUNTERS:
        assert got["serve_fleet"][k] == want["serve_fleet"][k], k
    for k in ("completed", "offered", "admitted", "shed_requests",
              "unserved_requests", "serve_duplicate_emissions",
              "decode_iterations", "prefills", "prefill_chunks",
              "serve_accept_rate"):
        assert got[k] == want[k], k
    assert got["serve_fleet"]["failover_recovery_s"] == \
        want["serve_fleet"]["failover_recovery_s"]
    assert ([e["kind"] for e in got["serve_fleet"]["failover_events"]]
            == [e["kind"] for e in want["serve_fleet"]["failover_events"]])
    if case == "swap-half":
        # the perturbation must matter: rids 2-3 decode under new weights
        toks = {r.rid: r.tokens for r in got["results"]}
        assert toks[0] == toks[1] != toks[2] == toks[3]
    if case == "nanlogits":
        assert all(0 <= t < 64 for r in got["results"] for t in r.tokens)


def test_summary_keys_equal_jax(tiny):
    want, _ = _jax_schedule("crash", tiny)
    got, _ = _run_schedule(tfleet, "crash", tiny)
    assert set(got) == set(want)
    assert set(got["serve_fleet"]) == set(want["serve_fleet"])


# ------------------------------------------------------------ fault specs

GRAMMAR = ("crash:replica=0,iter=3;stall:replica=1,iter=2,stall_s=0.5;"
           "nanlogits:replica=0,iter=4;crash:replica=1,prefill=2;"
           "crash:replica=0,verify=1;crash:replica=1,prob=0.1;"
           "crash:replica=2,handoff=1")


def test_fault_spec_parse_grammar_equals_jax():
    want = [dataclasses.asdict(s) for s in jfleet.FaultInjector.parse(
        GRAMMAR)]
    got = [dataclasses.asdict(s) for s in tfleet.FaultInjector.parse(
        GRAMMAR)]
    assert got == want and len(got) == 7


@pytest.mark.parametrize("bad", [
    "boom:replica=0,iter=1", "crash:iter=1", "crash:replica=0",
    "crash:replica=0,iter=1,prob=0.5", "crash:replica=0,wat=1",
    "crash:replica=0,iter=x", "stall:replica=0,iter=1",
    "nanlogits:replica=0,prefill=1", "crash:replica=0,iter", ""])
def test_fault_spec_rejections_equal_jax(bad):
    msgs = []
    for lib in (jfleet, tfleet):
        with pytest.raises(ValueError) as err:
            lib.FaultInjector.parse(bad)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_fault_spec_dataclass_rejections_equal_jax():
    for kw in (dict(kind="stall", replica=0, site="verify", at=1,
                    stall_s=1.0),
               dict(kind="crash", replica=-1, at=1),
               dict(kind="crash", replica=0, site="nowhere", at=1)):
        msgs = []
        for lib in (jfleet, tfleet):
            with pytest.raises(ValueError) as err:
                lib.FaultSpec(**kw)
            msgs.append(str(err.value))
        assert msgs[1] == msgs[0]


def test_seeded_prob_schedule_equals_jax(tiny):
    """A prob spec fires at the same decode iteration in both packages for
    the same seed (one seeded draw per event)."""
    jm, params, sd = tiny

    def fire(lib, kv, seed):
        inj = lib.FaultInjector("crash:replica=0,prob=0.3", seed=seed)
        inj.arm(0, kv)
        kv.insert(np.arange(4, dtype=np.int32))
        for i in range(40):
            try:
                kv.advance()
            except lib.InjectedFault:
                return i, inj.fired
        return None, inj.fired

    for seed in (7, 3):
        want = fire(jfleet, jserving.SlotKVCache(jm, params, slots=1), seed)
        got = fire(tfleet, _port_kvs(sd, 1, 1)[0], seed)
        assert got == want and got[0] is not None


def test_injector_one_shot_and_instance_level(tiny):
    _, _, sd = tiny
    kv, other = _port_kvs(sd, 2, 1)
    inj = tfleet.FaultInjector("crash:replica=0,iter=2", seed=0)
    inj.arm(0, kv)
    inj.arm(1, other)                  # no spec for replica 1: untouched
    assert "advance" not in vars(other)
    kv.insert(np.arange(4, dtype=np.int32))
    kv.advance()
    with pytest.raises(tfleet.InjectedFault, match="decode iteration 2"):
        kv.advance()
    for _ in range(3):
        kv.advance()                   # one-shot: no re-fire
    assert len(inj.fired) == 1
    # the fused round is no fault site (as in JAX)
    assert "dispatch_multi" not in vars(kv)


# ---------------------------------------------------------------- journal

def _journal_ops(lib):
    """The same operation sequence on ``lib``'s RequestJournal: the fence,
    a retry resume, a complete stream, least-loaded picks."""
    req = lib.Request if lib is not jfleet else jserving.Request
    reqs = [req(rid=0, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=3),
            req(rid=1, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=2)] + [
        req(rid=i, prompt=np.arange(4, dtype=np.int32), max_new_tokens=2)
        for i in range(2, 7)]
    j = lib.RequestJournal(reqs)
    out = [j.assign(0, 0, 0.0), j.emit(0, 0, 11, 1.0)]
    retry = j.retry_request(0)
    out.append((retry.prompt.tolist(), retry.max_new_tokens,
                retry.arrival_s))
    j.mark_failed([0], 2.0)
    j.assign(0, 1, 2.0, retry=True)
    out += [j.emit(0, 0, 12, 3.0), j.emit(0, 1, 12, 4.0),
            j.emit(0, 1, 13, 5.0), j.emit(0, 1, 14, 6.0)]
    j.assign(1, 0, 0.0)
    out += [j.emit(1, 0, 7, 1.0), j.emit(1, 0, 8, 2.0),
            j.retry_request(1)]
    picks = []
    for rid in range(2, 7):
        r = j.least_loaded([0, 1])
        picks.append(r)
        j.assign(rid, r, 0.0)
    j.finalize_if_assigned(2, 1, "shed")      # not its replica: no-op
    j.finalize_if_assigned(3, 1, "shed")
    j.finalize(4, "lost")
    e = j.entries[0]
    out += [picks, e.emitted, e.completed_by, e.status, j.requeues,
            sorted(j.requeued_rids), j.fenced_emissions,
            j.duplicate_emissions, j.recovery_s, j.counts(), j.load,
            j.done_count, j.all_terminal(), j.pending_for(0),
            [(r.rid, r.tokens, r.ttft_s, r.itl_s) for r in j.results()]]
    return out


def test_journal_sequences_equal_jax():
    assert _journal_ops(tfleet) == _journal_ops(jfleet)
    with pytest.raises(ValueError, match="duplicate rid"):
        tfleet.RequestJournal(_requests(tserving, n=2) * 2)


# ---------------------------------------------------------- threaded run

def test_threaded_wall_clock_chaos_equals_oracle(tiny):
    """The decode crash under real threads and the wall clock: exactly
    once and bitwise the streams of JAX's fault-free fleet (those of one
    table)."""
    _, _, sd = tiny
    want, _ = _jax_schedule("none", tiny)
    reqs = _requests(tserving)
    for r in reqs:
        r.arrival_s = 0.0
    inj = tfleet.FaultInjector("crash:replica=0,iter=3", seed=0)
    rs = tfleet.ReplicaSet(_port_kvs(sd, 2, 2), fault_injector=inj)
    try:
        s = rs.run(reqs)
    finally:
        rs.close()
    assert rs.threaded
    assert s["completed"] == 6 and s["serve_duplicate_emissions"] == 0
    assert s["serve_fleet"]["failovers"] == 1
    assert ({r.rid: r.tokens for r in s["results"]}
            == {r.rid: r.tokens for r in want["results"]})


def test_run_reuse_and_validation(tiny):
    _, _, sd = tiny
    kvs = _port_kvs(sd, 2, 2)
    rs = tfleet.ReplicaSet(kvs, clock=tserving.VirtualClock())
    first = rs.run(_requests(tserving))
    second = rs.run(_requests(tserving))
    assert ([r.tokens for r in first["results"]]
            == [r.tokens for r in second["results"]])
    for kw, err, match in (
            (dict(retry_limit=-1), ValueError, "retry_limit"),
            (dict(draft_kvs=kvs[:1]), ValueError, "1:1"),
            (dict(routing="nearest"), ValueError, "least-loaded"),
            (dict(roles=["prefill", "decode"]), NotImplementedError,
             "Queue 1: 10b"),
            (dict(routing="affinity"), NotImplementedError, "10b"),
            (dict(autoscale="1:2"), NotImplementedError, "10b"),
            (dict(parallel_lanes=True), NotImplementedError, "10b")):
        with pytest.raises(err, match=match):
            tfleet.ReplicaSet(kvs, **kw)
    with pytest.raises(ValueError, match="at least one"):
        tfleet.ReplicaSet([])
    with pytest.raises(RuntimeError, match="already in flight"):
        rs.schedule_swap(sd)
        rs.schedule_swap(sd)
    with pytest.raises(NotImplementedError, match="Queue 1: 10b"):
        tserving.ContinuousBatcher(kvs[0], role="prefill")


def test_replicas_own_their_model(tiny):
    """Each replica's table holds its own copy of the model: a swap on one
    leaves the other's weights as they were."""
    _, _, sd = tiny
    a, b = _port_kvs(sd, 2, 1)
    assert a.model is not b.model
    a.swap_params(_half(sd))
    key = "token_embed.weight"
    assert torch.equal(a.model.state_dict()[key], sd[key] * 0.5)
    assert torch.equal(b.model.state_dict()[key], sd[key])


def test_swap_params_refusals_and_in_place(tiny):
    _, _, sd = tiny
    kv = _port_kvs(sd, 1, 1)[0]
    ptrs = {k: v.data_ptr() for k, v in kv.model.state_dict().items()}
    other = GPTLM(**dict(TINY, hidden=16, ffn=32), device="cpu")
    with pytest.raises(ValueError, match="shape/dtype mismatch") as err:
        kv.swap_params(other.state_dict())
    assert err.value.args[0].count("vs") == 3   # the first three listed
    with pytest.raises(ValueError, match="same param tree structure"):
        kv.swap_params({k: v for k, v in sd.items()
                        if k != "token_embed.weight"})
    with pytest.raises(ValueError, match="shape/dtype mismatch"):
        kv.swap_params({k: v.double() for k, v in sd.items()})
    kv.swap_params(_half(sd))
    assert {k: v.data_ptr() for k, v in kv.model.state_dict().items()} \
        == ptrs
    assert torch.equal(kv.model.state_dict()["token_embed.weight"],
                       sd["token_embed.weight"] * 0.5)


# ------------------------------------------------------- harness and CLI

FLEET_CASES = {
    "crash-swap": dict(serve_replicas=2, serve_hot_swap=True,
                       serve_fault_spec="crash:replica=0,iter=2"),
    "paged-one-replica": dict(serve_kv_layout="paged",
                              serve_fault_spec="crash:replica=0,prefill=3",
                              serve_prefix_cache=8, serve_prefix_block=4),
}


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_serve_from_state_fleet_equals_jax(case, monkeypatch):
    """The harness's fleet branch on the same weights: the serve section's
    keys and ``serve_fleet``'s keys JAX's, every request once, streams
    bitwise JAX's (a resume re-prefills, greedy, so the streams are those
    of one table whatever the schedule)."""
    from test_torch_harness_lm import _gpt_pair
    from distributed_tensorflow_tpu_torch.data import loaders as tloaders

    jm, params, tm = _gpt_pair(weight_scale=3.0)
    test = tloaders.load_lm_dataset("lm_synth", split="test", seq_len=16,
                                    vocab_size=64, n_test=8)
    kw = dict(model="gpt", serve_requests=7, serve_slots=2,
              serve_max_new=4, serve_prompt_len=4, **FLEET_CASES[case])
    runs = {}

    def keep(lib, name):
        class Kept(lib.ReplicaSet):
            def run(self, requests, *a, **k):
                runs[name] = summary = super().run(requests, *a, **k)
                return summary
        monkeypatch.setattr(lib, "ReplicaSet", Kept)

    keep(jfleet, "jax")
    keep(tfleet, "port")
    want = jharness._serve_from_state(
        jharness.ExperimentConfig(**kw), _jax_ex(jm),
        types.SimpleNamespace(params=params), test, JAX_NULL_TRACER, 1)
    got = tharness._serve_from_state(tharness.ExperimentConfig(**kw),
                                     _port_ex(tm), None, test)
    assert set(got) == set(want)
    assert set(got["serve_fleet"]) == set(want["serve_fleet"])
    assert got["mode"] == want["mode"] == "fleet"
    for key in ("replicas", "completed", "serve_duplicate_emissions",
                "serve_kv_layout", "unserved_requests"):
        assert got[key] == want[key], key
    for key in ("failovers", "swap_generations", "failed_replicas"):
        assert got["serve_fleet"][key] == want["serve_fleet"][key], key
    streams = [{r.rid: r.tokens for r in runs[k]["results"]}
               for k in ("jax", "port")]
    assert streams[1] == streams[0]
    assert len(streams[1]) == got["completed"]


FLEET_ERRORS = {
    "replicas": dict(serve_replicas=0),
    "fault-spec": dict(serve_fault_spec="boom:replica=0"),
    "fault-replica": dict(serve_replicas=2,
                          serve_fault_spec="crash:replica=3,iter=1"),
    "watchdog": dict(serve_watchdog_s=-1.0),
}


@pytest.mark.parametrize("case", list(FLEET_ERRORS))
def test_validate_serving_fleet_raises_as_jax(case):
    want, got = _validation_pair("_validate_serving", dict(
        serve_requests=4, **FLEET_ERRORS[case]))
    assert got == want


def test_cli_fleet_flags_through_main():
    """``cli.main --device cpu`` with the four fleet flags: the flags
    reach the config as JAX's CLI parses them, and the window runs through
    a fleet with its failover and swap."""
    from distributed_tensorflow_tpu import cli as jcli

    flags = ["--serve", "8", "--serve-slots", "2", "--serve-max-new", "4",
             "--serve-prompt-len", "4", "--serve-replicas", "2",
             "--serve-fault-spec", "crash:replica=0,iter=2",
             "--serve-hot-swap", "--serve-watchdog", "30"]
    ja = jcli.build_parser().parse_args(flags)
    ta = tcli.build_parser().parse_args(flags)
    for k in ("serve_replicas", "serve_fault_spec", "serve_hot_swap",
              "serve_watchdog"):
        assert getattr(ta, k) == getattr(ja, k), k
    summary = tcli.main(["--device", "cpu", "-n", "1", "--model",
                         "gpt_tiny", "--log-every", "0"] + flags,
                        dataset_fn=_small_lm_fn)
    sec = summary["serve"]
    assert sec == summary["run_report"]["serve"]
    assert sec["mode"] == "fleet" and sec["replicas"] == 2
    assert sec["completed"] == 8 and sec["serve_duplicate_emissions"] == 0
    fl = sec["serve_fleet"]
    assert fl["failovers"] == 1 and fl["faults_injected"]
    # the crash left one replica, whose own swap turn admitted nothing
    assert fl["swap_generations"] == 1 and fl["min_admitting_replicas"] == 0
    assert summary["serve_exit_policy"] == 0


def test_launch_counters_exact_under_threads():
    """The replicas of a fleet launch from several threads: the counters'
    updates hold under ``ops.COUNT_LOCK`` with a shortened switch
    interval, where a bare ``+=`` could lose a count."""
    import sys
    import threading

    from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

    fa = tfa.flash_attention
    names = ("fwd_launches", "fwd_tc_launches", "fwd_f16_launches")
    saved = {n: getattr(fa, n) for n in names}
    interval = sys.getswitchinterval()
    threads = [threading.Thread(
        target=lambda: [tfa._count("fwd", "tc", torch.float16)
                        for _ in range(2000)]) for _ in range(16)]
    try:
        sys.setswitchinterval(1e-6)
        for n in names:
            setattr(fa, n, 0)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [getattr(fa, n) for n in names] == [16 * 2000] * 3
    finally:
        sys.setswitchinterval(interval)
        for n, v in saved.items():
            setattr(fa, n, v)
