"""The port's checkpoints, policy-aware restore and exactly-once resume
(``utils/checkpoint.py``, ``parallel/precision.py``'s restore,
``elastic/``, the Trainer's and harness's options), case by case as the
JAX package's ``test_checkpoint.py``, ``test_async_checkpoint.py``,
``test_precision.py`` (its checkpoint crossing) and ``test_elastic.py``
(data state, stream positions, the drain, kill and resume), on the CPU
at a small size (an MLP of hidden 32 on 8-feature, 4-class synthetic
rows, dropout 0.25 so the dropout stream is part of the state).

The on-disk format is the port's own (``torch.save`` of flat tensors), so
the port is held by resumed trajectories, not file bytes: a state saved,
restored into a fresh engine and trained on is BITWISE the uninterrupted
state — sync f32, ``bf16-f32master``, ``fp16-f32master`` with its scaler
mid-growth, remat on↔off, the chunked drain at k = 1 and 8, and (one
spawn of two gloo ranks, module fixture) local SGD's per-rank states, the
sync engine's replicated one restored onto another rank count, and the
expert-parallel engine's gathered experts.  One parity test runs JAX and
the port from the same converted MLP parameters through k steps, a
checkpoint, a restore and k more: the port's resumed losses match JAX's
within ``test_torch_train.py``'s f32 tolerance.

This file imports no JAX at the top: a spawned rank re-imports it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch import elastic
from distributed_tensorflow_tpu_torch.data.device_prefetch import (
    DevicePrefetch)
from distributed_tensorflow_tpu_torch.data.loaders import (
    Dataset, load_dataset, synthetic_classification)
from distributed_tensorflow_tpu_torch.data.pipeline import iter_batches
from distributed_tensorflow_tpu_torch.elastic import (
    DataState, ElasticRestoreError, ResumableBatches, consumer_state,
    elastic_restore, preemption_lost_s)
from distributed_tensorflow_tpu_torch.engines import (
    AsyncLocalEngine, SyncEngine, Trainer)
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel import precision as tpl
from distributed_tensorflow_tpu_torch.utils.checkpoint import (
    AsyncCheckpointError, AsyncCheckpointManager, CheckpointManager)

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

# test_torch_train.py's f32 tolerance for the port's metrics against JAX's
METRIC = dict(rtol=1e-5, atol=0)


def _tiny_ds(n=256):
    x, y = synthetic_classification((8,), 4, n, seed=3)
    return Dataset(x=x, y=y, num_classes=4, name="tiny", synthetic=True)


def _engine(precision="f32", cls=SyncEngine, mesh=None, **kw):
    model = create_model("mlp", num_classes=4, hidden=32,
                         dropout_rate=0.25, device="cpu")
    return cls(model, device="cpu", precision=precision, mesh=mesh, **kw)


def _template(eng, seed=0):
    return eng.init_state(torch.Generator().manual_seed(seed),
                          _tiny_ds().x[:1])


def _steps(eng, state, n, lo=0):
    ds = _tiny_ds()
    losses = []
    for i in range(lo, lo + n):
        xs, ys = eng.shard_batch(ds.x[16 * i:16 * (i + 1)],
                                 ds.y[16 * i:16 * (i + 1)])
        state, m = eng.step(state, xs, ys)
        losses.append(float(m["loss"]))
    return state, losses


def _snapshot(state) -> dict:
    """Every tensor and plain field of a state, copied."""
    d = state.engine.checkpoint_state(state)
    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in d.items()}


def assert_states_equal(a, b):
    a = a if isinstance(a, dict) else _snapshot(a)
    b = b if isinstance(b, dict) else _snapshot(b)
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def _trained(precision="f32", n_steps=2, **kw):
    eng = _engine(precision, **kw)
    state, _ = _steps(eng, _template(eng), n_steps)
    return eng, state


# ------------------------------------------------------ test_checkpoint.py

def test_save_restore_roundtrip(tmp_path):
    eng, state = _trained()
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(state)
    assert mgr.latest_step() == 2
    assert sorted(p.name for p in (tmp_path / "ckpt" / "step_2").iterdir()) \
        == ["state.json", "state.pt"]
    eng2 = _engine()
    restored = mgr.restore(_template(eng2, seed=5))
    assert_states_equal(state, restored)
    # the restored state trains on
    _, losses = _steps(eng2, restored, 1)
    assert losses[0] > 0
    # the file holds plain tensors only
    payload = torch.load(tmp_path / "ckpt" / "step_2" / "state.pt",
                         weights_only=True)
    assert all(isinstance(v, torch.Tensor) for v in payload.values())


def _scaling_policy():
    # fp16 with a growth interval of 2: the scale and good_steps move
    # during the run, so the scaler's state is part of what resumes
    return dataclasses.replace(tpl.make_policy("fp16-f32master"),
                               growth_interval=2)


@pytest.mark.parametrize("precision", ["f32", "bf16-f32master",
                                       "fp16-f32master"])
def test_restore_preserves_training_trajectory(precision, tmp_path):
    """Train 3 steps → checkpoint → 3 more; against restore-at-3 → 3 more
    in a fresh engine: the final states are bitwise equal (parameters,
    optimizer, master and scaler)."""
    policy = _scaling_policy() if precision.startswith("fp16") else precision
    eng = _engine(policy)
    state, _ = _steps(eng, _template(eng), 3)
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(state)
    state, want = _steps(eng, state, 3, lo=3)
    eng2 = _engine(policy)
    resumed = mgr.restore(_template(eng2, seed=1))
    resumed, got = _steps(eng2, resumed, 3, lo=3)
    assert got == want
    assert_states_equal(state, resumed)
    if precision.startswith("fp16"):
        assert float(state.optimizer.loss_scale) > 2.0 ** 15


def test_retention(tmp_path):
    _, state = _trained(n_steps=0)
    mgr = CheckpointManager(tmp_path / "c", max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, step=s)
    assert mgr.steps() == [3, 4]


def test_trainer_checkpoint_integration(tmp_path):
    mgr = CheckpointManager(tmp_path / "c")
    tr = Trainer(None, engine=_engine(), seed=0)
    r = tr.fit(_tiny_ds(), epochs=1, batch_size=64, log_every=0,
               checkpoint_manager=mgr, checkpoint_every=2)
    assert mgr.latest_step() == r["steps"] == 256 // 64  # final present
    assert r["steps_per_call_clamp"] == {
        "requested": 8, "effective": 2, "reason": "checkpoint_sync"}


def test_checkpoint_cross_remat_restore(tmp_path):
    """A checkpoint saved WITHOUT remat restores into a remat GPT and both
    train on alike: remat changes the backward's schedule, not the
    parameter names (on the CPU, bitwise)."""
    kw = dict(num_classes=64, hidden=32, layers=2, heads=2, ffn=64,
              max_len=64, dropout_rate=0.0, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.integers(1, 64, (16, 16)).astype(np.int32)
    y = np.roll(x, -1, axis=1)

    def sgd(p):
        return torch.optim.SGD(p, lr=0.1)

    plain = SyncEngine(create_model("gpt", remat=False, **kw),
                       optimizer=sgd, device="cpu")
    state = plain.init_state(torch.Generator().manual_seed(0), x)
    xs, ys = plain.shard_batch(x, y)
    state, _ = plain.step(state, xs, ys)
    mgr = CheckpointManager(tmp_path / "x")
    mgr.save(state)

    rem = SyncEngine(create_model("gpt", remat=True, **kw), optimizer=sgd,
                     device="cpu")
    restored = mgr.restore(rem.init_state(torch.Generator().manual_seed(0),
                                          x))
    assert_states_equal(state, restored)
    state, m0 = plain.step(state, xs, ys)
    restored, m1 = rem.step(restored, xs, ys)
    assert float(m0["loss"]) == float(m1["loss"])
    assert_states_equal(state, restored)


def test_lazy_adam_state_is_materialized_for_restore(tmp_path):
    """torch's Adam builds its state at the first step: a fresh template
    has none, so the restore builds it first (and a checkpoint written
    before any step restores into a fresh template as it is)."""
    eng, state = _trained()
    assert isinstance(state.optimizer, torch.optim.Adam)
    mgr = CheckpointManager(tmp_path / "c", max_to_keep=5)
    mgr.save(state)
    template = _template(_engine())
    assert not template.optimizer.state
    assert_states_equal(state, mgr.restore(template))
    fresh_eng = _engine()
    fresh = _template(fresh_eng)
    mgr.save(fresh, step=0)
    assert_states_equal(_template(_engine()),
                        mgr.restore(_template(fresh_eng, seed=3), step=0))


# ------------------------------------------------ test_async_checkpoint.py

class SlowWriter(AsyncCheckpointManager):
    """Writer-delay shim: every background write sleeps ``delay`` first;
    write number ``crash_at`` (1-based) instead leaves a partial
    ``tmp_step_N`` behind and raises."""

    def __init__(self, *args, delay=0.0, crash_at=None, **kw):
        self.delay, self.crash_at, self.writes = delay, crash_at, 0
        super().__init__(*args, **kw)

    def _write(self, step, host_state, extra=None):
        self.writes += 1
        time.sleep(self.delay)
        if self.crash_at is not None and self.writes == self.crash_at:
            tmp = self.directory / f"tmp_step_{step}"
            tmp.mkdir(exist_ok=True)
            (tmp / "partial.bin").write_text("torn")
            raise RuntimeError("injected writer crash")
        super()._write(step, host_state, extra)


def test_async_sync_checkpoints_bitwise_equal(tmp_path):
    _, state = _trained()
    sync_mgr = CheckpointManager(tmp_path / "sync")
    async_mgr = AsyncCheckpointManager(tmp_path / "async")
    sync_mgr.save(state)
    async_mgr.save(state)
    async_mgr.wait()
    assert sync_mgr.steps() == async_mgr.steps() == [2]
    a = async_mgr.restore(_template(_engine()))
    s = sync_mgr.restore(_template(_engine()))
    assert_states_equal(a, s)
    assert_states_equal(a, state)
    async_mgr.close()


def test_async_save_survives_in_place_steps(tmp_path):
    """The snapshot decouples the save from the live state, which the next
    steps change in place: steps taken IMMEDIATELY after save, while the
    writer still sleeps, must not reach the checkpoint."""
    eng, state = _trained()
    expect = _snapshot(state)
    mgr = SlowWriter(tmp_path / "c", delay=0.2)
    mgr.save(state)
    state, _ = _steps(eng, state, 3, lo=2)
    mgr.wait()
    assert_states_equal(expect, mgr.restore(_template(_engine()), step=2))
    mgr.close()


def test_backpressure_second_save_waits_never_drops(tmp_path):
    _, state = _trained()
    mgr = SlowWriter(tmp_path / "c", delay=0.3, max_to_keep=10)
    t0 = time.perf_counter()
    mgr.save(state, step=1)
    assert time.perf_counter() - t0 < 0.25  # did NOT pay the write here
    t0 = time.perf_counter()
    mgr.save(state, step=2)  # must wait out write #1 (~0.3s)
    assert time.perf_counter() - t0 > 0.2
    assert 1 in mgr.steps()  # write #1 landed before save #2 proceeded
    mgr.wait()
    assert mgr.steps() == [1, 2]  # never dropped
    assert mgr.saves == 2
    assert mgr.wait_s > 0.2
    # blocked wall time is charged to wait_s ONLY
    assert mgr.overlapped_s < 0.3
    assert mgr.stats() == {"saves": 2, "wait_s": mgr.wait_s,
                           "overlapped_s": mgr.overlapped_s}
    mgr.close()


def test_writer_crash_leaves_no_visible_partial(tmp_path):
    _, state = _trained()
    mgr = SlowWriter(tmp_path / "c", delay=0.0, crash_at=1)
    mgr.save(state, step=5)
    mgr._idle.wait()  # let the writer fail without consuming the error
    assert mgr.steps() == []                        # nothing visible
    assert (mgr.directory / "tmp_step_5").exists()  # only the torn tmp
    with pytest.raises(AsyncCheckpointError, match="injected writer crash"):
        mgr.save(state, step=6)  # the NEXT checkpoint surfaces the error
    mgr.wait()
    assert mgr.steps() == []
    mgr.close()
    fresh = AsyncCheckpointManager(tmp_path / "c")  # next start sweeps tmp
    assert not (fresh.directory / "tmp_step_5").exists()
    assert fresh.latest_step() is None
    fresh.close()


def test_writer_error_reraises_at_close(tmp_path):
    _, state = _trained()
    mgr = SlowWriter(tmp_path / "c", crash_at=1)
    mgr.save(state, step=1)
    with pytest.raises(AsyncCheckpointError):
        mgr.close()
    mgr2 = SlowWriter(tmp_path / "c2", crash_at=1)
    mgr2.save(state, step=1)
    mgr2.close(reraise=False)  # the exception-path cleanup swallows


def test_sync_write_is_atomic_too(tmp_path):
    _, state = _trained()

    class CrashingSync(CheckpointManager):
        def _write(self, step, host_state, extra=None):
            tmp = self.directory / f"tmp_step_{step}"
            tmp.mkdir(exist_ok=True)
            (tmp / "partial.bin").write_text("torn")
            raise RuntimeError("boom")

    mgr = CrashingSync(tmp_path / "c")
    with pytest.raises(RuntimeError, match="boom"):
        mgr.save(state, step=3)
    assert mgr.steps() == []
    assert (mgr.directory / "tmp_step_3").exists()


def test_restore_drains_pending_write(tmp_path):
    _, state = _trained()
    mgr = SlowWriter(tmp_path / "c", delay=0.3)
    mgr.save(state, step=1)  # still writing when restore is called
    assert_states_equal(mgr.restore(_template(_engine())), state)
    mgr.close()


def test_fit_async_result_keys(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path / "c", max_to_keep=10)
    tr = Trainer(None, engine=_engine(), seed=0)
    r = tr.fit(_tiny_ds(), epochs=1, batch_size=16, log_every=0,
               steps_per_call=4, checkpoint_manager=mgr,
               checkpoint_every=4, max_steps=12)
    mgr.close()
    assert r["checkpoint_async"] is True
    assert r["checkpoint_wait_s"] >= 0.0
    assert r["checkpoint_overlapped_s"] > 0.0
    assert r["preempted"] is None
    assert {4, 8, 12} <= set(mgr.steps())
    assert r["data_state"]["batch_index"] == 12


def test_fit_sync_keeps_blocking_accounting(tmp_path):
    mgr = CheckpointManager(tmp_path / "c", max_to_keep=10)
    tr = Trainer(None, engine=_engine(), seed=0)
    r = tr.fit(_tiny_ds(), epochs=1, batch_size=16, log_every=0,
               steps_per_call=4, checkpoint_manager=mgr,
               checkpoint_every=4, max_steps=8)
    assert r["checkpoint_async"] is False
    assert r["checkpoint_overlapped_s"] == 0.0
    assert r["checkpoint_wait_s"] > 0.0
    assert mgr.steps() == [4, 8]


def test_fit_async_trajectory_matches_sync(tmp_path):
    """Same seed, both disciplines: final state and every checkpoint
    bitwise equal — async changes WHEN the write happens, never what."""
    results = {}
    for name, mgr in (
            ("sync", CheckpointManager(tmp_path / "s", max_to_keep=10)),
            ("async", AsyncCheckpointManager(tmp_path / "a",
                                             max_to_keep=10))):
        tr = Trainer(None, engine=_engine(), seed=0)
        tr.fit(_tiny_ds(), epochs=1, batch_size=16, log_every=0,
               checkpoint_manager=mgr, checkpoint_every=4, max_steps=12)
        mgr.close()
        results[name] = (tr.state, mgr)
    assert_states_equal(results["sync"][0], results["async"][0])
    s_mgr, a_mgr = results["sync"][1], results["async"][1]
    assert s_mgr.steps() == a_mgr.steps() == [4, 8, 12]
    for step in s_mgr.steps():
        assert_states_equal(s_mgr.restore(_template(_engine()), step=step),
                            a_mgr.restore(_template(_engine()), step=step))


def test_fit_failure_drains_writer_and_keeps_the_error(tmp_path):
    """A fit that raises mid-run leaves no write in flight, and a writer
    crash pending at cleanup does not replace the fit's own error."""
    def boom(msg):
        raise RuntimeError("mid-run failure")

    mgr = SlowWriter(tmp_path / "c", delay=0.3, max_to_keep=10)
    tr = Trainer(None, engine=_engine(), seed=0)
    with pytest.raises(RuntimeError, match="mid-run failure"):
        # log_fn fires at step 2 with the save of step 1 in flight
        tr.fit(_tiny_ds(), epochs=1, batch_size=16, log_every=2,
               log_fn=boom, checkpoint_manager=mgr, checkpoint_every=1,
               max_steps=6)
    assert mgr._idle.is_set()  # drained before the raise escaped
    mgr.close()
    mgr = SlowWriter(tmp_path / "d", delay=0.05, crash_at=1, max_to_keep=10)
    tr = Trainer(None, engine=_engine(), seed=0)
    with pytest.raises(RuntimeError, match="mid-run failure"):
        tr.fit(_tiny_ds(), epochs=1, batch_size=16, log_every=2,
               log_fn=boom, checkpoint_manager=mgr, checkpoint_every=1,
               max_steps=6)
    mgr.close(reraise=False)


def test_cli_checkpoint_flags_parse_as_jax():
    """The eight flags parse to the JAX CLI's defaults and choices."""
    from distributed_tensorflow_tpu import cli as jcli
    from distributed_tensorflow_tpu_torch import cli

    flags = ("checkpoint_dir", "checkpoint_every", "async_checkpoint",
             "resume", "elastic_restore", "watchdog_timeout",
             "watchdog_abort", "max_restarts")
    p, jp = cli.build_parser(), jcli.build_parser()
    argv = ["--checkpoint-dir", "d", "--checkpoint-every", "7",
            "--async-checkpoint", "off", "--resume", "--elastic-restore",
            "--watchdog-timeout", "2.5", "--watchdog-abort",
            "--max-restarts", "3"]
    for args in ([], argv):
        got, want = p.parse_args(args), jp.parse_args(args)
        assert {f: getattr(got, f) for f in flags} == \
            {f: getattr(want, f) for f in flags}
    assert p.parse_args([]).async_checkpoint == "on"
    with pytest.raises(SystemExit):
        p.parse_args(["--async-checkpoint", "maybe"])
    ours = {a.dest for a in p._actions} - {"help", "device"}
    theirs = {a.dest for a in jp._actions} - {"help"}
    assert len(ours & theirs) == 93 and len(theirs) == 93


def _harness_config(tmp_path, **kw):
    from distributed_tensorflow_tpu_torch.utils.harness import (
        ExperimentConfig)

    base = dict(engine="sync", model="mlp", dataset="synthetic",
                dataset_fn=_harness_ds, model_args={"hidden": 32},
                n_devices=1, batch_size=16, epochs=1, log_every=0,
                eval_batch=64, device="cpu", steps_per_call=4,
                checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4)
    base.update(kw)
    return ExperimentConfig(**base)


def _harness_ds(batch_size, type="train"):  # noqa: A002 — harness API
    n = 128 if type == "train" else 64
    x, y = synthetic_classification((8,), 4, n, seed=3)
    return Dataset(x=x, y=y, num_classes=4, name="tiny", synthetic=True)


@pytest.mark.parametrize("async_checkpoint", [True, False])
def test_harness_checkpoint_resume_roundtrip(async_checkpoint, tmp_path):
    """``--checkpoint-every`` then ``--resume`` through ``harness.run``:
    the resumed run continues the step numbering and the run report
    carries the wait split (overlap 0 for the synchronous writer)."""
    from distributed_tensorflow_tpu_torch.utils.harness import run

    cfg = _harness_config(tmp_path, async_checkpoint=async_checkpoint)
    first = run(cfg)
    mgr = CheckpointManager(cfg.checkpoint_dir)
    assert mgr.latest_step() == first["steps"] == 8
    report = first["run_report"]
    assert report["checkpoint_async"] is async_checkpoint
    assert report["checkpoint_wait_s"] >= 0.0
    if not async_checkpoint:
        assert report["checkpoint_overlapped_s"] == 0.0
    second = run(dataclasses.replace(cfg, resume=True))
    assert np.isfinite(second["test_loss"])
    assert mgr.latest_step() == 2 * first["steps"]


# --------------------------------------------- test_precision.py crossing

def test_checkpoint_roundtrip_same_policy(tmp_path):
    """A bf16-f32master checkpoint (master + scale state) round-trips
    bitwise through restore_into_policy."""
    _, st = _trained("bf16-f32master")
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(st, step=2)
    eng2 = _engine("bf16-f32master")
    restored = tpl.restore_into_policy(mgr, _template(eng2, seed=7),
                                       eng2.precision)
    assert_states_equal(st, restored)


def test_f32_checkpoint_adopts_into_bf16_policy(tmp_path):
    """An f32 checkpoint restores into a master policy: the restored f32
    parameters become the MASTER exactly, the stored parameters their
    downcast, the inner Adam state the f32 run's, the scaler fresh; the
    f32 template alone expects that layout."""
    _, stf = _trained("f32")
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(stf, step=2)
    engb = _engine("bf16-f32master")
    template = _template(engb, seed=7)
    with pytest.raises(ValueError, match="precision"):
        mgr.restore(template)  # the direct restore refuses the crossing
    restored = tpl.restore_into_policy(mgr, template, engb.precision)
    m = restored.optimizer
    named = dict(stf.model.named_parameters())
    entries = tpl.optimizer_entries(restored.model, m)
    f32_entries = tpl.optimizer_entries(stf.model, stf.optimizer)
    for name, p in restored.model.named_parameters():
        assert torch.equal(entries[f"master/{name}"], named[name].detach())
        assert torch.equal(p.detach(),
                           named[name].detach().to(torch.bfloat16))
    for k, v in f32_entries.items():
        assert torch.equal(entries[k], v), k
    assert restored.step == 2
    assert float(m.loss_scale) == 1.0 and int(m.good_steps) == 0
    _, losses = _steps(engb, restored, 1, lo=2)
    assert np.isfinite(losses[0])


def test_other_precision_crossings_raise_the_direct_error(tmp_path):
    """A master-policy checkpoint into f32 (or bf16 into fp16) has no
    adoption: the direct restore's error, and elastic_restore's named
    one."""
    _, st = _trained("bf16-f32master")
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(st)
    eng = _engine("f32")
    with pytest.raises(ValueError, match="bf16-f32master"):
        tpl.restore_into_policy(mgr, _template(eng), eng.precision)
    with pytest.raises(ElasticRestoreError, match="GSPMD"):
        elastic_restore(mgr, eng, _template(eng))
    _, st16 = _trained("bf16")
    mgr16 = CheckpointManager(tmp_path / "d")
    mgr16.save(st16)
    eng16 = _engine(_scaling_policy())
    with pytest.raises(ValueError, match="'bf16'"):
        tpl.restore_into_policy(mgr16, _template(eng16), eng16.precision)


def test_harness_e2e_f32_checkpoint_resumes_into_bf16(tmp_path):
    """run()-level crossing: train f32 with checkpoints, resume the same
    directory under bf16-f32master — the restore adopts the f32 state and
    the resumed run continues the numbering."""
    from distributed_tensorflow_tpu_torch.utils.harness import run

    cfg = _harness_config(tmp_path)
    first = run(cfg)
    second = run(dataclasses.replace(cfg, resume=True,
                                     precision="bf16-f32master"))
    assert second["precision"] == "bf16-f32master"
    assert np.isfinite(second["test_loss"])
    assert CheckpointManager(cfg.checkpoint_dir).latest_step() == \
        2 * first["steps"]
    with pytest.raises(ValueError, match="--resume could not restore"):
        run(dataclasses.replace(cfg, resume=True, precision="bf16"))


# ------------------------------------------------------- test_elastic.py

def test_data_state_json_roundtrip():
    st = DataState(epoch=2, batch_index=7, seed=3, batch_size=32,
                   dataset_len=1024, dataset="mnist")
    back = DataState.from_json(st.to_json())
    assert back == st
    assert back.version == elastic.DATA_STATE_VERSION


@pytest.mark.parametrize("garbage", [
    None, [], "x", 42, {}, {"epoch": 1}, {"epoch": "a", "batch_index": 0,
                                          "seed": 0, "batch_size": 1,
                                          "dataset_len": 1},
])
def test_data_state_tolerant_decode(garbage):
    assert DataState.from_json(garbage) is None


def test_data_state_matching_guards_the_stream_identity():
    st = DataState(epoch=0, batch_index=3, seed=1, batch_size=16,
                   dataset_len=256, dataset="tiny")
    assert st.matches(seed=1, batch_size=16, dataset_len=256)
    assert st.matches(seed=1, batch_size=16, dataset_len=256,
                      dataset="tiny")
    assert not st.matches(seed=2, batch_size=16, dataset_len=256)
    assert not st.matches(seed=1, batch_size=32, dataset_len=256)
    assert not st.matches(seed=1, batch_size=16, dataset_len=512)
    assert not st.matches(seed=1, batch_size=16, dataset_len=256,
                          dataset="other")


def test_iter_batches_start_batch_continues_exact_sequence():
    x, y = synthetic_classification((4,), 3, 100, seed=7)
    full = list(iter_batches(x, y, 16, shuffle=True, seed=5, epoch=2,
                             drop_remainder=True))
    resumed = list(iter_batches(x, y, 16, shuffle=True, seed=5, epoch=2,
                                drop_remainder=True, start_batch=3))
    assert len(resumed) == len(full) - 3
    for (ax, ay, am), (bx, by, bm) in zip(full[3:], resumed):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)
        np.testing.assert_array_equal(am, bm)
    with pytest.raises(ValueError, match="start_batch"):
        list(iter_batches(x, y, 8, start_batch=-1))
    assert list(iter_batches(x, y, 8, drop_remainder=True,
                             start_batch=99)) == []


@pytest.mark.parametrize("name", ["synthetic", "lm_synth", "mnist"])
def test_dataset_start_batch_parity_per_loader(name):
    ds = load_dataset(name, split="train")
    full = list(ds.batches(32, shuffle=True, seed=1, epoch=0,
                           drop_remainder=True))
    resumed = list(ds.batches(32, shuffle=True, seed=1, epoch=0,
                              drop_remainder=True, start_batch=2))
    assert len(resumed) == len(full) - 2
    for (ax, ay, _), (bx, by, _) in zip(full[2:], resumed):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_resumable_batches_state_restore_roundtrip():
    ds = _tiny_ds(192)
    rb = ResumableBatches(ds, 16, seed=4, epoch=1)
    consumed = [next(rb) for _ in range(5)]
    st = rb.state()
    assert (st.epoch, st.batch_index) == (1, 5)
    rest = list(ResumableBatches.restore(ds, st))
    uninterrupted = list(ResumableBatches(ds, 16, seed=4, epoch=1))
    assert len(consumed) + len(rest) == len(uninterrupted)
    for (ax, ay, _), (bx, by, _) in zip(uninterrupted[5:], rest):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)
    rb.close()
    bad = dataclasses.replace(ResumableBatches(ds, 16).state(),
                              dataset_len=7)
    with pytest.raises(ValueError, match="dataset"):
        ResumableBatches.restore(ds, bad)
    bad = dataclasses.replace(ResumableBatches(ds, 16).state(),
                              dataset="other")
    with pytest.raises(ValueError, match="other"):
        ResumableBatches.restore(ds, bad)


def test_prefetch_drain_no_drop_no_replay():
    """The exactly-once discounting: with the prefetcher reading ahead,
    the CONSUMER position (``consumer_state``) resumes every staged but
    untrained batch exactly once and no trained batch twice."""
    ds = _tiny_ds(192)  # 12 batches of 16
    rb = ResumableBatches(ds, 16, seed=0, epoch=0)
    pf = DevicePrefetch(rb, lambda b: b, depth=3, device="cpu")
    trained = [next(pf) for _ in range(4)]
    assert pf.consumed == 4
    assert rb.state().batch_index == 7  # 4 consumed + 3 staged
    st = consumer_state(rb, pf)
    assert st.batch_index == 4
    assert pf.stats()["consumed"] == 4
    pf.close()
    resumed = list(ResumableBatches.restore(ds, st))
    full = list(ResumableBatches(ds, 16, seed=0, epoch=0))
    assert len(trained) + len(resumed) == len(full) == 12
    for (ax, ay, _), (bx, by, _) in zip(full[4:], resumed):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def _fit(trainer, ds, k, **kw):
    lines = []
    r = trainer.fit(ds, epochs=2, batch_size=16, log_every=1,
                    log_fn=lines.append, steps_per_call=k, **kw)
    return r, lines


@pytest.mark.parametrize("k", [1, 8])
def test_trainer_should_stop_drains_at_boundary(k, tmp_path):
    """The drain at both drain shapes: fit stops at the first chunk
    boundary where should_stop fires, reports the reason, and the final
    checkpoint carries that boundary's data state."""
    mgr = CheckpointManager(tmp_path / "c")
    tr = Trainer(None, engine=_engine(), seed=0)
    r, _ = _fit(tr, _tiny_ds(), k, checkpoint_manager=mgr,
                should_stop=lambda s: "budget:5" if s >= 5 else None)
    assert r["preempted"] == "budget:5"
    expected = 5 if k == 1 else 8  # first boundary at/after the budget
    assert r["steps"] == expected
    assert mgr.latest_step() == expected
    extra = mgr.load_extra()
    st = DataState.from_json(extra["data_state"])
    assert st is not None and st.batch_index == expected
    assert extra["step"] == expected and extra["wall_time"] > 0


@pytest.mark.parametrize("k", [1, 8])
def test_kill_and_resume_bitwise_same_ranks(k, tmp_path):
    """A run checkpointed at step 6, killed, and resumed with the
    checkpoint's data state gives the BITWISE metric stream and final
    state of the uninterrupted run, at k = 1 and k = 8."""
    tru = Trainer(None, engine=_engine(), seed=0)
    ru, lines_u = _fit(tru, _tiny_ds(), k, max_steps=13)
    assert ru["steps"] == 13
    mgr = CheckpointManager(tmp_path / "c")
    tr1 = Trainer(None, engine=_engine(), seed=0)
    _, lines1 = _fit(tr1, _tiny_ds(), k, checkpoint_manager=mgr,
                     checkpoint_every=6, max_steps=6)
    tr2 = Trainer(None, engine=_engine(), seed=0)
    tr2.state, extra = elastic_restore(mgr, tr2.engine,
                                       _template(tr2.engine))
    r2, lines2 = _fit(tr2, _tiny_ds(), k, max_steps=7,
                      data_state=extra["data_state"])
    assert r2["resume_replay_steps"] == 0
    assert r2["start_step"] == 6
    assert lines1 + lines2 == lines_u  # step-exact heartbeats, 1..13
    assert_states_equal(tru.state, tr2.state)


def test_resume_without_data_state_reports_replay(tmp_path):
    mgr = CheckpointManager(tmp_path / "c")
    tr1 = Trainer(None, engine=_engine(), seed=0)
    _fit(tr1, _tiny_ds(), 4, max_steps=6)
    mgr.save(tr1.state, step=6)  # direct save: no elastic sidecar
    assert mgr.load_extra() is None
    tr2 = Trainer(None, engine=_engine(), seed=0)
    tr2.state, extra = elastic_restore(mgr, tr2.engine,
                                       _template(tr2.engine))
    assert extra is None
    logs = []
    r2 = tr2.fit(_tiny_ds(), epochs=1, batch_size=16, log_every=0,
                 steps_per_call=4, max_steps=4, data_state={},
                 log_fn=logs.append)
    assert r2["resume_replay_steps"] == 6
    assert any("resume_replay_steps=6" in line for line in logs)


def test_mid_epoch_and_cross_epoch_resume_positions(tmp_path):
    """A checkpoint past epoch 0's end records (epoch 1, offset) and the
    resumed fit continues there; only the first resumed epoch starts
    offset, and the whole resumed run is the uninterrupted one."""
    ds = _tiny_ds(96)  # 6 batches of 16 per epoch
    mgr = CheckpointManager(tmp_path / "c")
    tr = Trainer(None, engine=_engine(), seed=0)
    _fit(tr, ds, 4, checkpoint_manager=mgr, checkpoint_every=8, max_steps=8)
    st = DataState.from_json(mgr.load_extra()["data_state"])
    assert (st.epoch, st.batch_index) == (1, 2)  # 8 = 6 + 2
    tr2 = Trainer(None, engine=_engine(), seed=0)
    tr2.state, extra = elastic_restore(mgr, tr2.engine,
                                       _template(tr2.engine))
    r = tr2.fit(ds, epochs=3, batch_size=16, log_every=0, steps_per_call=4,
                data_state=extra["data_state"])
    assert r["steps"] == 18 - 8
    tru = Trainer(None, engine=_engine(), seed=0)
    tru.fit(ds, epochs=3, batch_size=16, log_every=0, steps_per_call=4)
    assert_states_equal(tru.state, tr2.state)


def test_preemption_lost_s_accounting():
    assert preemption_lost_s(None) is None
    assert preemption_lost_s({}) is None
    assert preemption_lost_s({"wall_time": True}) is None  # bool guard
    assert preemption_lost_s({"wall_time": 100.0}, now=130.0) == \
        pytest.approx(30.0)
    assert preemption_lost_s({"wall_time": 100.0}, now=90.0) == 0.0


def test_elastic_restore_pins_requested_step(tmp_path):
    mgr = CheckpointManager(tmp_path / "c", max_to_keep=5)
    tr = Trainer(None, engine=_engine(), seed=0)
    tr.fit(_tiny_ds(), epochs=1, batch_size=16, log_every=0,
           steps_per_call=2, checkpoint_manager=mgr, checkpoint_every=2,
           max_steps=6)
    assert mgr.steps() == [2, 4, 6]
    eng = _engine()
    state, extra = elastic_restore(mgr, eng, _template(eng), step=4)
    assert state.step == 4 and extra["step"] == 4


def test_watchdog_rides_the_fit(tmp_path):
    from distributed_tensorflow_tpu_torch.utils.failure import Watchdog

    tr = Trainer(None, engine=_engine(), seed=0)
    with Watchdog(timeout=30.0) as wd:
        r = tr.fit(_tiny_ds(), epochs=1, batch_size=16, log_every=0,
                   steps_per_call=4, watchdog=wd)
        assert wd.timeout == 120.0  # rescaled to k × 30 s
    # a beat per dispatch and per flush: 4 chunks
    assert r["watchdog_beats"] == 8 and r["watchdog_stalls"] == 0


# ---------------------------------------------- parity with the JAX package

def test_resumed_run_matches_jax(tmp_path):
    """JAX and the port from the same converted MLP parameters (dropout
    0: the two packages draw different masks): 2 steps, checkpoint,
    restore into a fresh engine, 2 more.  The port's resumed losses match
    JAX's resumed losses within the f32 tolerance of
    ``test_torch_train.py``, and the port's resumed run is bitwise its
    uninterrupted one."""
    import jax

    from distributed_tensorflow_tpu.engines.sync import SyncEngine as JSync
    from distributed_tensorflow_tpu.models.mlp import MLP as JaxMLP
    from distributed_tensorflow_tpu.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu.utils.checkpoint import (
        CheckpointManager as JaxManager)
    from distributed_tensorflow_tpu_torch.models.convert import (
        mlp_state_dict)
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    ds = _tiny_ds(64)
    batches = [(ds.x[16 * i:16 * (i + 1)], ds.y[16 * i:16 * (i + 1)])
               for i in range(4)]
    jeng = JSync(JaxMLP(num_classes=4, hidden=32, dropout_rate=0.0),
                 mesh=create_mesh(1))
    jstate = jeng.init_state(jax.random.key(0), ds.x[:1])
    init = mlp_state_dict(jax.tree.map(np.asarray, jstate.params))
    for bx, by in batches[:2]:
        jstate, _ = jeng.step(jstate, *jeng.shard_batch(bx, by))
    jmgr = JaxManager(tmp_path / "jax")
    jmgr.save(jstate)
    jstate = jmgr.restore(jeng.init_state(jax.random.key(1), ds.x[:1]))
    want = []
    for bx, by in batches[2:]:
        jstate, m = jeng.step(jstate, *jeng.shard_batch(bx, by))
        want.append(float(m["loss"]))

    def port_engine(seed):
        eng = SyncEngine(MLP(num_classes=4, hidden=32, dropout_rate=0.0,
                             device="cpu"), device="cpu")
        state = eng.init_state(torch.Generator().manual_seed(seed),
                               ds.x[:1])
        return eng, state

    eng, state = port_engine(0)
    state.model.load_state_dict(init)
    uninterrupted = []
    for i, (bx, by) in enumerate(batches):
        state, m = eng.step(state, *eng.shard_batch(bx, by))
        uninterrupted.append(float(m["loss"]))
        if i == 1:
            mgr = CheckpointManager(tmp_path / "port")
            mgr.save(state)
    eng2, template = port_engine(9)
    resumed = mgr.restore(template)
    got = []
    for bx, by in batches[2:]:
        resumed, m = eng2.step(resumed, *eng2.shard_batch(bx, by))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, **METRIC)
    assert got == uninterrupted[2:]
    assert_states_equal(state, resumed)


# --------------------------------------------- two gloo ranks, one spawn

WORLD = 2


def _rank_main(rank: int, port: int, out_dir: str) -> None:
    """Every multi-rank case on one group of two ranks; each rank leaves
    its results in ``rank<r>.npz`` (and the checkpoints stay on disk for
    the parent's cross-count restores)."""
    from distributed_tensorflow_tpu_torch.engines import ExpertParallelEngine

    torch.set_num_threads(1)
    meshlib.init_process_group("cpu", WORLD, rank, f"tcp://127.0.0.1:{port}")
    out = {}
    try:
        mesh = meshlib.create_mesh(WORLD, device="cpu")
        ds = _tiny_ds()

        def run(cls, directory, **kw):
            """4 uninterrupted steps, against 2 + checkpoint + a fresh
            engine's restore + 2."""
            eng = _engine(cls=cls, mesh=mesh, **kw)
            whole, _ = _steps(eng, _template(eng), 4)
            eng = _engine(cls=cls, mesh=mesh, **kw)
            state, _ = _steps(eng, _template(eng), 2)
            mgr = AsyncCheckpointManager(f"{out_dir}/{directory}")
            mgr.save(state)  # two ranks: synchronous, ends in a barrier
            saved = _snapshot(state)
            eng = _engine(cls=cls, mesh=mesh, **kw)
            resumed, _ = elastic_restore(mgr, eng, _template(eng, seed=4))
            resumed, _ = _steps(eng, resumed, 2, lo=2)
            mgr.close()
            a, b = _snapshot(whole), _snapshot(resumed)
            out[f"{directory}/bitwise"] = np.asarray(all(
                torch.equal(v, b[k]) for k, v in a.items()
                if isinstance(v, torch.Tensor)))
            for k, v in saved.items():
                if k.startswith("model/"):
                    out[f"{directory}/{k}"] = v.numpy()

        run(AsyncLocalEngine, "async", sync_every=100)
        run(SyncEngine, "sync")
        # expert parallel on a (1, 2) mesh: two experts a rank, gathered
        ep_mesh = meshlib.create_mesh(WORLD, device="cpu", shape=(1, 2),
                                      axis_names=("data", "expert"))
        x = np.random.default_rng(1).standard_normal((8, 8, 8)).astype(
            np.float32)
        yy = np.arange(8, dtype=np.int32) % 10

        def ep_engine():
            model = create_model("moe", num_classes=10, num_experts=4,
                                 embed_dim=16, expert_hidden=32,
                                 dropout_rate=0.0, device="cpu")
            return ExpertParallelEngine(model, mesh=ep_mesh)

        eng = ep_engine()
        state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
        xs, ys = eng.shard_batch(x, yy)
        state, _ = eng.step(state, xs, ys)
        mgr = CheckpointManager(f"{out_dir}/ep")
        mgr.save(state)
        eng2 = ep_engine()
        restored, _ = elastic_restore(mgr, eng2, eng2.init_state(
            torch.Generator().manual_seed(3), x[:1]))
        state, m1 = eng.step(state, xs, ys)
        restored, m2 = eng2.step(restored, xs, ys)
        full_a, full_b = (eng.full_state_dict(state),
                          eng2.full_state_dict(restored))
        out["ep/bitwise"] = np.asarray(
            float(m1["loss"]) == float(m2["loss"])
            and all(torch.equal(v, full_b[k]) for k, v in full_a.items()))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    mp.spawn(_rank_main, args=(meshlib.free_port(), str(out)),
             nprocs=WORLD, join=True)
    return out, [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def test_per_rank_states_resume_bitwise_on_two_ranks(two_ranks):
    """Local SGD: each rank's own state is saved (``state_rank<r>.pt``)
    and the resumed run is bitwise the uninterrupted one on each rank;
    the ranks' states differ (no average yet), as JAX's per-device rows
    do."""
    out, ranks = two_ranks
    assert all(bool(r["async/bitwise"]) for r in ranks)
    names = sorted(p.name for p in (out / "async" / "step_2").iterdir())
    assert names == ["elastic.json", "state.json", "state_rank0.pt",
                     "state_rank1.pt"] or names == [
        "state.json", "state_rank0.pt", "state_rank1.pt"]
    key = next(k for k in ranks[0] if k.startswith("async/model/"))
    assert not np.array_equal(ranks[0][key], ranks[1][key])


def test_per_rank_checkpoint_refuses_another_rank_count(two_ranks):
    out, _ = two_ranks
    eng = _engine(cls=AsyncLocalEngine)
    mgr = CheckpointManager(out / "async")
    with pytest.raises(ElasticRestoreError, match="device count") as e:
        elastic_restore(mgr, eng, _template(eng))
    assert "2 ranks' states" in str(e.value)


def test_replicated_checkpoint_restores_onto_any_rank_count(two_ranks):
    """The sync engine's ranks hold one state: rank 0 wrote it, both
    ranks resumed bitwise, and one rank (this process) restores it."""
    out, ranks = two_ranks
    assert all(bool(r["sync/bitwise"]) for r in ranks)
    names = sorted(p.name for p in (out / "sync" / "step_2").iterdir())
    assert names == ["state.json", "state.pt"]
    eng = _engine()
    state, _ = elastic_restore(CheckpointManager(out / "sync"), eng,
                               _template(eng))
    got = _snapshot(state)
    for k, v in ranks[0].items():
        if k.startswith("sync/model/"):
            np.testing.assert_array_equal(got[k[len("sync/"):]].numpy(), v)
            np.testing.assert_array_equal(v, ranks[1][k])


def test_expert_parallel_checkpoint_gathers_the_experts(two_ranks):
    """``-ep 2``: the checkpoint holds every expert (gathered at save), the
    ranks resumed bitwise, and it restores onto one rank's whole layer."""
    from distributed_tensorflow_tpu_torch.engines import (
        ExpertParallelEngine)

    out, ranks = two_ranks
    assert all(bool(r["ep/bitwise"]) for r in ranks)
    saved = torch.load(out / "ep" / "step_1" / "state.pt",
                       weights_only=True)
    w1 = [k for k in saved if k.startswith("model/") and k.endswith("w1")]
    assert w1 and all(saved[k].shape[0] == 4 for k in w1)
    mesh = meshlib.create_mesh(1, device="cpu", shape=(1, 1),
                               axis_names=("data", "expert"))
    try:
        eng = ExpertParallelEngine(create_model(
            "moe", num_classes=10, num_experts=4, embed_dim=16,
            expert_hidden=32, dropout_rate=0.0, device="cpu"), mesh=mesh)
        template = eng.init_state(torch.Generator().manual_seed(5),
                                  np.zeros((1, 8, 8), np.float32))
        state, _ = elastic_restore(CheckpointManager(out / "ep"), eng,
                                   template)
        full = eng.full_state_dict(state)
        for k in w1:
            assert torch.equal(full[k[len("model/"):]], saved[k])
    finally:
        mesh.close()
