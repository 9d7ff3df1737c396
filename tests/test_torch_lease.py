"""The port's elastic lease and straggler detector (``elastic/lease.py``,
``elastic/stragglers.py``), the Trainer's drain on them and the harness's
wiring (``utils/harness.py``, ``cli.py``), held to the JAX package at a
small size on the CPU, as JAX's ``tests/test_elastic.py`` holds its own:

* the same sequence of step budget, ``trigger``, ``reset_trigger`` and
  SIGTERM gives the same ``should_stop`` reasons and ``report()`` from
  JAX's and the port's ``LeaseManager``; ``uninstall`` restores the
  previous handler; off the main thread the manager is the budget alone;
* one seeded step-time series (outliers, then a new pace) through both
  detectors with recording tracers: the same flags, events and reports;
* a GPT-tiny ``Trainer.fit`` drained by the lease's budget and by a
  SIGTERM sent at a chunk boundary stops at the first boundary at or
  after it with its final checkpoint, and the resumed run is BITWISE the
  uninterrupted one, at k = 1 and k = 8;
* ``harness.run`` of one small MLP config with ``max_steps_per_lease``
  and a checkpoint directory in both packages: the same ``preempted``
  reason, step count, ``lease`` report and supervisor message, then an
  ``elastic_restore`` run finishing it; the validation messages are
  JAX's;
* two gloo ranks (one spawn): a SIGTERM that reaches rank 1 only stops
  both at the same step with the same reason; the ``-n N`` launcher
  forwards a SIGTERM to its ranks.

This file imports no JAX at the top: a spawned rank re-imports it.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.data.loaders import (
    Dataset, synthetic_classification)
from distributed_tensorflow_tpu_torch.elastic import (
    LeaseManager, StragglerDetector, elastic_restore)
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.utils.checkpoint import (
    AsyncCheckpointManager)
from distributed_tensorflow_tpu_torch.utils.metrics import MetricsLogger

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

GPT_TINY = dict(vocab_size=64, hidden=32, layers=2, heads=4, ffn=64,
                max_len=16, dropout_rate=0.1, attention_impl="flash")


def _lease_script(cls) -> list:
    """One manager of ``cls`` through budget, trigger, reset and a real
    SIGTERM; every decision and report along the way."""
    out = []
    lm = cls(max_steps_per_lease=5).install()
    try:
        out.append(("installed", lm.installed))
        for steps in (0, 4, 5, 9):
            out.append(("budget", steps, lm.should_stop(steps)))
        out.append(("report", lm.report()))
        lm.trigger("drain:swap")
        lm.trigger("second")                   # the first reason wins
        out.append(("triggered", lm.should_stop(1), lm.report()))
        lm.reset_trigger()
        out.append(("reset", lm.should_stop(1)))
        os.kill(os.getpid(), signal.SIGTERM)   # the preemption notice
        out.append(("signal", lm.should_stop(1), lm.report()))
        lm.reset_trigger()                     # a signal stays sticky
        out.append(("sticky", lm.should_stop(1)))
        with pytest.raises(ValueError, match="non-empty"):
            lm.trigger("")
    finally:
        lm.uninstall()
    out.append(("after", lm.installed, lm.report()))
    with pytest.raises(ValueError, match="max_steps_per_lease"):
        cls(max_steps_per_lease=-1)
    return out


def test_lease_matches_jax_sequence():
    from distributed_tensorflow_tpu.elastic import LeaseManager as JaxLease

    before = signal.getsignal(signal.SIGTERM)
    want, got = _lease_script(JaxLease), _lease_script(LeaseManager)
    assert got == want
    assert ("signal", "signal:SIGTERM") == got[-3][:2]
    assert signal.getsignal(signal.SIGTERM) is before


def test_lease_uninstall_restores_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with LeaseManager() as lm:
            os.kill(os.getpid(), signal.SIGTERM)
            assert lm.preempt_signal == signal.SIGTERM and not seen
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]   # the previous disposition is back
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_lease_off_main_thread_degrades_to_budget():
    from distributed_tensorflow_tpu.elastic import LeaseManager as JaxLease

    box = {}

    def install():
        box["port"] = LeaseManager(max_steps_per_lease=2).install()
        box["jax"] = JaxLease(max_steps_per_lease=2).install()

    th = threading.Thread(target=install)
    th.start()
    th.join()
    for lm in box.values():
        assert not lm.installed
        assert lm.should_stop(2) == "max_steps_per_lease:2"
    assert box["port"].report() == box["jax"].report()


class _Recorder:
    def __init__(self):
        self.events = []

    def event(self, name, **fields):
        self.events.append({"name": name, **fields})


def test_stragglers_match_jax():
    from distributed_tensorflow_tpu.elastic import (
        StragglerDetector as JaxStragglers)

    rng = np.random.default_rng(7)
    times = list(0.01 * (1 + 0.1 * rng.standard_normal(40)))
    times[12] *= 6.0                     # outliers
    times[20] *= 4.0
    times += list(0.05 * (1 + 0.1 * rng.standard_normal(30)))  # new pace
    runs = {}
    for name, cls in (("jax", JaxStragglers), ("port", StragglerDetector)):
        tracer = _Recorder()
        det = cls(tracer=tracer, factor=3.0, min_samples=5, window=16)
        flags = [det.observe(i, t) for i, t in enumerate(times)]
        runs[name] = (flags, tracer.events, det.report())
    assert runs["port"] == runs["jax"]
    flags, events, report = runs["port"]
    assert flags[12] and flags[20] and 2 < report["events"] < 16
    assert not any(flags[55:])   # the new pace became the median
    assert [e["step"] for e in events] == [
        i for i, f in enumerate(flags) if f]
    for bad in (dict(factor=1.0), dict(min_samples=1)):
        with pytest.raises(ValueError):
            StragglerDetector(**bad)


# ---------------------------------------------- the Trainer's drain

def _lm_ds(n=96, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 64, (n, 16)).astype(np.int32)
    return Dataset(x=x, y=np.roll(x, -1, axis=1), num_classes=64,
                   name="tokens", synthetic=True)


def _trainer():
    return Trainer(None, engine=SyncEngine(GPTLM(**GPT_TINY, device="cpu"),
                                           device="cpu"), seed=0)


def _fit(tr, k, **kw):
    ml = MetricsLogger(None, log_every=1)
    r = tr.fit(_lm_ds(), epochs=2, batch_size=8, log_every=0,
               steps_per_call=k, metrics_logger=ml, **kw)
    return r, [(m["step"], m["loss"], m["accuracy"]) for m in ml.records]


def _state(tr):
    d = tr.engine.checkpoint_state(tr.state)
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in d.items()}


@pytest.fixture(scope="module")
def uninterrupted():
    """The uninterrupted fit (24 steps) at k = 1 and k = 8."""
    out = {}
    for k in (1, 8):
        tr = _trainer()
        r, traj = _fit(tr, k)
        assert r["steps"] == 24 and r["preempted"] is None
        out[k] = (traj, _state(tr))
    # the drain shapes agree with each other
    assert out[1][0] == out[8][0]
    return out


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("trigger", ["budget", "signal"])
def test_fit_lease_drain_resumes_bitwise(uninterrupted, trigger, k,
                                         tmp_path):
    """The lease ends the fit at the first chunk boundary at or after its
    budget (5 steps), or after a SIGTERM sent at the boundary of step 3 (k
    = 1) or 8 (k = 8; the next boundary is the epoch's 12), with the final
    checkpoint there; a fresh engine
    restores it with its data state, and the two halves are bitwise the
    uninterrupted trajectory and state."""
    before = signal.getsignal(signal.SIGTERM)
    mgr = AsyncCheckpointManager(tmp_path / "c")
    tr = _trainer()
    with LeaseManager(max_steps_per_lease=5 if trigger == "budget" else 0
                      ) as lease:
        def hook(steps_done):
            reason = lease.should_stop(steps_done)
            if trigger == "signal" and steps_done == (3 if k == 1 else 8):
                # after this boundary's decision: read at the next one
                os.kill(os.getpid(), signal.SIGTERM)
            return reason

        r1, traj1 = _fit(tr, k, checkpoint_manager=mgr, should_stop=hook)
    assert signal.getsignal(signal.SIGTERM) is before
    stop = {("budget", 1): 5, ("budget", 8): 8, ("signal", 1): 4,
            ("signal", 8): 12}[(trigger, k)]
    assert r1["preempted"] == ("max_steps_per_lease:5" if trigger ==
                               "budget" else "signal:SIGTERM")
    assert r1["steps"] == stop and mgr.latest_step() == stop
    assert r1["data_state"]["batch_index"] == stop
    tr2 = _trainer()
    template = tr2.engine.init_state(torch.Generator().manual_seed(0),
                                     _lm_ds().x[:1])
    tr2.state, extra = elastic_restore(mgr, tr2.engine, template)
    mgr.close()
    r2, traj2 = _fit(tr2, k, data_state=extra["data_state"])
    assert r2["start_step"] == stop and r2["resume_replay_steps"] == 0
    traj, state = uninterrupted[k]
    assert traj1 + traj2 == traj
    got = _state(tr2)
    assert got.keys() == state.keys()
    for key, v in state.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, got[key]), key
        else:
            assert v == got[key], key


# ------------------------------------------------ the harness, vs JAX

def _port_mlp(batch_size, type="train"):  # noqa: A002 — harness API
    n = 256 if type == "train" else 64
    x, y = synthetic_classification((8,), 4, n, seed=3)
    return Dataset(x=x, y=y, num_classes=4, name="tiny", synthetic=True)


def _jax_mlp(batch_size, type="train"):  # noqa: A002 — harness API
    from distributed_tensorflow_tpu.data.loaders import Dataset as JaxDataset

    n = 256 if type == "train" else 64
    x, y = synthetic_classification((8,), 4, n, seed=3)
    return JaxDataset(x=x, y=y, num_classes=4, name="tiny", synthetic=True)


def _config(cls, directory, dataset_fn, **kw):
    base = dict(engine="sync", model="mlp", dataset="synthetic",
                dataset_fn=dataset_fn, n_devices=1, batch_size=16, epochs=2,
                log_every=0, steps_per_call=4, eval_batch=64,
                checkpoint_dir=str(directory), checkpoint_every=4,
                model_args=dict(hidden=16))
    base.update(kw)
    return cls(**base)


def _supervised(run, config):
    """``run(config)`` under a supervisor listener: (summary, messages,
    the JSONL events)."""
    from distributed_tensorflow_tpu_torch.utils.supervisor import (
        SupervisorListener)

    listener = SupervisorListener()
    try:
        import dataclasses

        summary = run(dataclasses.replace(
            config, supervisor_address=f"127.0.0.1:{listener.port}"))
    finally:
        listener.close()
    return summary, listener.messages


def test_harness_lease_drain_matches_jax(tmp_path):
    """Both packages' ``run`` of the same MLP config under a 6-step lease
    budget (chunks of 4): drained at step 8 with the same reason, lease
    report and ``['preempted', reason, step]`` message; an
    ``elastic_restore`` run of each then trains the remaining 24 steps
    with no replayed step.  The port's restored run is the uninterrupted
    port run's bitwise (its test loss)."""
    from distributed_tensorflow_tpu.utils import harness as jharness

    from distributed_tensorflow_tpu_torch.utils import harness as tharness

    out = {}
    for name, mod, fn in (("jax", jharness, _jax_mlp),
                          ("port", tharness, _port_mlp)):
        cfg = _config(mod.ExperimentConfig, tmp_path / name, fn,
                      **({} if name == "jax" else {"device": "cpu"}))
        import dataclasses

        first, msgs = _supervised(mod.run, dataclasses.replace(
            cfg, max_steps_per_lease=6))
        second = mod.run(dataclasses.replace(cfg, elastic_restore=True))
        out[name] = (first, msgs, second)
    (jf, jm, js), (tf, tm, ts) = out["jax"], out["port"]
    assert tf["preempted"] == jf["preempted"] == "max_steps_per_lease:6"
    assert tf["steps"] == jf["steps"] == 8
    for key in ("preempted", "lease"):
        assert tf["run_report"][key] == jf["run_report"][key], key
    assert tf["run_report"]["lease"] == {
        "max_steps_per_lease": 6, "signal_handler_installed": True,
        "preempt_signal": None, "triggered": None}
    kinds = [[m if isinstance(m, str) else m[0] for m in ms]
             for ms in (tm, jm)]
    assert kinds[0] == kinds[1] == ["start", "preempted", "done", "results"]
    assert tm[1] == jm[1] == ["preempted", "max_steps_per_lease:6", 8]
    for s in (ts, js):
        assert s["steps"] == 24 and s["preempted"] is None
        rep = s["run_report"]
        assert rep["restored_step"] == 8 and rep["resume_replay_steps"] == 0
        assert rep["stragglers"]["observed"] > 0
    assert set(ts["run_report"]) == set(js["run_report"])
    whole = tharness.run(_config(tharness.ExperimentConfig,
                                 tmp_path / "whole", _port_mlp,
                                 device="cpu"))
    assert whole["steps"] == 32 and whole["test_loss"] == ts["test_loss"]


def test_harness_validation_messages_are_jax(tmp_path):
    from distributed_tensorflow_tpu.utils import harness as jharness

    from distributed_tensorflow_tpu_torch.utils import harness as tharness

    cases = {"--max-steps-per-lease requires --checkpoint-dir": dict(
                 max_steps_per_lease=5, checkpoint_dir=None,
                 checkpoint_every=0),
             "--max-steps-per-lease must be >= 0, got -1": dict(
                 max_steps_per_lease=-1),
             "--timeline-interval must be >= 0 seconds": dict(
                 timeline_interval=-1.0)}
    for want, kw in cases.items():
        msgs = []
        for mod, fn in ((jharness, _jax_mlp), (tharness, _port_mlp)):
            cfg = _config(mod.ExperimentConfig, tmp_path / "v", fn, **kw)
            with pytest.raises(ValueError) as e:
                mod.run(cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and want in msgs[0], (kw, msgs)


# ------------------------------------------- two gloo ranks, one spawn

WORLD = 2
SIGNAL_AT_BATCH = 10


class _SignallingDataset(Dataset):
    """Rank 1's batch stream sends SIGTERM to its own process when it
    yields batch ``SIGNAL_AT_BATCH`` of the first epoch: the notice
    reaches one rank only, in the middle of a chunk."""

    def batches(self, *args, **kw):
        for i, batch in enumerate(super().batches(*args, **kw)):
            if (dist.get_rank() == 1 and kw.get("epoch") == 0
                    and i == SIGNAL_AT_BATCH):
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def _signalling_mlp(batch_size, type="train"):  # noqa: A002
    n = 256 if type == "train" else 64
    x, y = synthetic_classification((8,), 4, n, seed=3)
    cls = _SignallingDataset if type == "train" else Dataset
    return cls(x=x, y=y, num_classes=4, name="tiny", synthetic=True)


def _rank_main(rank: int, port: int, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch.utils import harness

    torch.set_num_threads(1)
    meshlib.init_process_group("cpu", WORLD, rank, f"tcp://127.0.0.1:{port}")
    try:
        before = signal.getsignal(signal.SIGTERM)
        out = {}
        for k in (1, 4):
            s = harness.run(_config(
                harness.ExperimentConfig, f"{out_dir}/ck{k}",
                _signalling_mlp, n_devices=WORLD, batch_size=8,
                steps_per_call=k, device="cpu"))
            out[f"k{k}"] = np.asarray([s["steps"]])
            out[f"k{k}_reason"] = np.asarray(str(s["preempted"]))
            out[f"k{k}_signal"] = np.asarray(str(
                s["run_report"]["lease"]["preempt_signal"]))
        out["restored"] = np.asarray(
            signal.getsignal(signal.SIGTERM) is before)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("lease_ranks")
    mp.spawn(_rank_main, args=(meshlib.free_port(), str(out)),
             nprocs=WORLD, join=True)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("k", [1, 4])
def test_two_ranks_agree_on_a_signal(two_ranks, k):
    """Rank 1 alone receives SIGTERM while its batch 10 is staged; the
    vote at each boundary stops both ranks at the same step, past the
    signal and before the epoch's end (16 steps), with the same reason and
    the same lease report; each rank's SIGTERM disposition is back."""
    r0, r1 = two_ranks
    assert int(r0[f"k{k}"][0]) == int(r1[f"k{k}"][0])
    steps = int(r0[f"k{k}"][0])
    assert SIGNAL_AT_BATCH - 2 <= steps < 16 and steps % k == 0, steps
    for r in (r0, r1):
        assert str(r[f"k{k}_reason"]) == "signal:SIGTERM"
        assert str(r[f"k{k}_signal"]) == "SIGTERM"
        assert bool(r["restored"])


def _await_sigterm(ready, done):
    """A child that reports a SIGTERM through ``done`` (set from the main
    loop: the handler itself only appends, as a lease's does)."""
    got = []
    signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    ready.set()
    deadline = time.monotonic() + 60
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    if got:
        done.set()


def test_launcher_forwards_sigterm_to_its_ranks():
    """``cli._forwarding_sigterm``: a SIGTERM to the launcher reaches each
    live child (the ranks, whose leases drain on it), and the launcher's
    own disposition is back after."""
    from distributed_tensorflow_tpu_torch.cli import _forwarding_sigterm

    ctx = multiprocessing.get_context("spawn")
    ready, done = ctx.Event(), ctx.Event()
    child = ctx.Process(target=_await_sigterm, args=(ready, done))
    child.start()
    try:
        assert ready.wait(60)
        before = signal.getsignal(signal.SIGTERM)
        with _forwarding_sigterm([child]):
            os.kill(os.getpid(), signal.SIGTERM)
            assert done.wait(30)
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        child.join(30)
        if child.is_alive():
            child.kill()
