"""The port's ``utils/failure.py`` — divergence guard, stall watchdog,
crash recovery — case by case as the JAX package's ``test_failure.py``,
with the JAX functions run beside the port's where both take the same
input:

* ``check_finite`` and the ``Watchdog``'s episodes (quiet while beating,
  a stall, unarmed before the first beat, re-armed after recovery);
* a NaN step raises ``TrainingDiverged`` from ``Trainer.fit`` (the port
  raised ``FloatingPointError`` before), and ``run_with_recovery`` does
  not restart on it;
* ``run_with_recovery``'s control flow: no ``checkpoint_dir`` is a
  ``ValueError``, a restart sets ``resume`` AND ``elastic_restore`` (the
  calls ``(False, False), (True, True), (True, True)`` in both packages),
  ``on_restart`` sees each crash, the last crash propagates, the summary
  gains ``restarts``; ``harness.run`` dispatches it on ``max_restarts``;
* end to end: a run that crashes after its first epoch and is restarted
  from its checkpoint trains on to the uninterrupted run's parameters
  and test loss bitwise, the restart an exact resume
  (``resume_replay_steps`` 0, ``start_step`` one epoch);
* under ``cli -n N`` the recovery loop wraps the spawn (relaunched with
  ``resume``/``elastic_restore``), and a rank's ``TrainingDiverged``
  comes out of the spawn as ``TrainingDiverged``.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch import nn

from distributed_tensorflow_tpu_torch.data.loaders import (
    Dataset, synthetic_classification)
from distributed_tensorflow_tpu_torch.utils import failure
from distributed_tensorflow_tpu_torch.utils.failure import (
    StallDetected, TrainingDiverged, Watchdog, check_finite,
    run_with_recovery)
from distributed_tensorflow_tpu_torch.utils.harness import ExperimentConfig


# ------------------------------------------------------------ check_finite
def test_check_finite_passes():
    check_finite({"loss": 0.5, "accuracy": 1.0})


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_check_finite_raises(bad):
    from distributed_tensorflow_tpu.utils import failure as jfailure

    with pytest.raises(TrainingDiverged, match="loss") as got:
        check_finite({"loss": bad}, step=7)
    with pytest.raises(jfailure.TrainingDiverged) as want:
        jfailure.check_finite({"loss": bad}, step=7)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- watchdog
def test_watchdog_quiet_while_beating():
    with Watchdog(timeout=0.3, poll_interval=0.05) as wd:
        for _ in range(8):
            time.sleep(0.05)
            wd.beat()
            wd.check()
        assert not wd.stalled
        assert wd.beats == 8


def test_watchdog_detects_stall():
    fired = []
    with Watchdog(timeout=0.15, poll_interval=0.03,
                  on_stall=fired.append) as wd:
        wd.beat()  # arm (the clock starts at the first beat)
        time.sleep(0.4)  # then no beats
        assert wd.stalled
        assert fired and fired[0] > 0.15
        with pytest.raises(StallDetected):
            wd.check()


def test_watchdog_unarmed_before_first_beat():
    """No false stall during the first chunk's builds and capture."""
    with Watchdog(timeout=0.1, poll_interval=0.02) as wd:
        time.sleep(0.3)  # no beats yet
        assert not wd.stalled
        wd.check()  # does not raise


def test_watchdog_rearms_after_recovery():
    """A transient pause that recovers must not poison later checks; the
    budget rescales with the chunk length."""
    with Watchdog(timeout=0.12, poll_interval=0.02) as wd:
        wd.beat()
        time.sleep(0.3)  # stall episode fires
        assert wd.stalled
        wd.beat()       # progress resumes
        time.sleep(0.06)
        assert not wd.stalled  # monitor re-armed
        wd.check()      # recovered episode never raises
        assert wd.stall_episodes == 1
        wd.rescale(4)
        assert wd.timeout == pytest.approx(0.48)
        with pytest.raises(ValueError, match="steps_per_beat"):
            wd.rescale(0)


# ------------------------------------------------------- divergence guard
class _NaNModel(nn.Module):
    """A Dense layer whose logits are divided by 0: NaN/inf from step
    one (the JAX test's ``NaNModel``)."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 10, device="cpu")

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.fc.weight.normal_(generator=generator)
        self.fc.bias.zero_()
        return self

    def forward(self, x, train=False, generator=None):
        return self.fc(x.reshape(x.shape[0], -1).float()) / 0.0


def _nan_ds():
    x = np.random.default_rng(0).random((64, 4), np.float32)
    y = (np.arange(64) % 10).astype(np.int32)
    return Dataset(x=x, y=y, num_classes=10)


@pytest.mark.parametrize("k", [1, 4])
def test_trainer_raises_on_nan(k, tmp_path):
    """A diverged loss surfaces as ``TrainingDiverged`` from fit() at both
    drain shapes, and crash recovery does not restart into it."""
    from distributed_tensorflow_tpu_torch.engines.allreduce import Trainer

    tr = Trainer(_NaNModel(), device="cpu")
    with pytest.raises(TrainingDiverged, match="step 1"):
        tr.fit(_nan_ds(), epochs=1, batch_size=16, log_every=1,
               steps_per_call=k, log_fn=lambda s: None)

    calls = []

    def diverging_run(config):
        calls.append((config.resume, config.elastic_restore))
        Trainer(_NaNModel(), device="cpu").fit(
            _nan_ds(), epochs=1, batch_size=16, log_every=1,
            steps_per_call=k, log_fn=lambda s: None)

    cfg = ExperimentConfig(checkpoint_dir=str(tmp_path))
    with pytest.raises(TrainingDiverged):
        run_with_recovery(cfg, max_restarts=3, run_fn=diverging_run)
    assert calls == [(False, False)]


# ---------------------------------------------------------------- recovery
def test_run_with_recovery_requires_checkpoint_dir():
    cfg = ExperimentConfig()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_with_recovery(cfg, max_restarts=1, run_fn=lambda c: {})


def test_run_with_recovery_restarts_with_resume(tmp_path):
    """The restart is the ELASTIC resume: both flags flip on after the
    first crash, in the port as in the JAX package."""
    from distributed_tensorflow_tpu.utils import failure as jfailure
    from distributed_tensorflow_tpu.utils import harness as jharness

    def flaky(calls):
        def run(config):
            calls.append((config.resume, config.elastic_restore))
            if len(calls) < 3:
                raise RuntimeError(f"crash {len(calls)}")
            return {"ok": True}
        return run

    calls, want_calls, restarts = [], [], []
    out = run_with_recovery(ExperimentConfig(checkpoint_dir=str(tmp_path)),
                            max_restarts=2, run_fn=flaky(calls),
                            on_restart=lambda n, e: restarts.append(
                                (n, str(e))))
    want = jfailure.run_with_recovery(
        jharness.ExperimentConfig(checkpoint_dir=str(tmp_path)),
        max_restarts=2, run_fn=flaky(want_calls))
    assert out == want == {"ok": True, "restarts": 2}
    assert calls == want_calls == [(False, False), (True, True),
                                   (True, True)]
    assert restarts == [(1, "crash 1"), (2, "crash 2")]


def test_run_with_recovery_exhausts_restarts(tmp_path):
    cfg = ExperimentConfig(checkpoint_dir=str(tmp_path))
    calls = []

    def always_crash(config):
        calls.append(1)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        run_with_recovery(cfg, max_restarts=2, run_fn=always_crash)
    assert len(calls) == 3


def test_run_with_recovery_no_retry_on_divergence(tmp_path):
    cfg = ExperimentConfig(checkpoint_dir=str(tmp_path))
    calls = []

    def diverge(config):
        calls.append(1)
        raise TrainingDiverged("loss is nan")

    with pytest.raises(TrainingDiverged):
        run_with_recovery(cfg, max_restarts=5, run_fn=diverge)
    assert len(calls) == 1  # restarting into the same NaN is not recovery


def test_harness_run_dispatches_recovery():
    """max_restarts on the config is honored by harness.run itself (the
    programmatic path, not just the CLI); the flags that need a
    checkpoint directory say so before anything is set up."""
    from distributed_tensorflow_tpu_torch.utils import harness

    with pytest.raises(ValueError, match="checkpoint_dir"):
        harness.run(ExperimentConfig(max_restarts=1, device="cpu"))
    for kw, match in ((dict(resume=True), "--resume requires"),
                      (dict(elastic_restore=True), "--elastic-restore"),
                      (dict(checkpoint_every=5), "--checkpoint-every"),
                      (dict(watchdog_abort=True), "watchdog_timeout")):
        with pytest.raises(ValueError, match=match):
            harness.run(ExperimentConfig(device="cpu", **kw))


def _tiny_dataset_fn(batch_size, type="train"):  # noqa: A002 — harness API
    n = 256 if type == "train" else 64
    x, y = synthetic_classification((8,), 4, n, seed=3,
                                    split="train" if type == "train"
                                    else "test")
    return Dataset(x=x, y=y, num_classes=4, name="tiny", synthetic=True)


def _recovery_config(tmp_path, **kw):
    base = dict(engine="sync", model="mlp", dataset="synthetic",
                dataset_fn=_tiny_dataset_fn, model_args={"hidden": 32},
                n_devices=1, batch_size=16, epochs=2, log_every=0,
                eval_batch=64, device="cpu", steps_per_call=4,
                learning_rate=1e-2)
    base.update(kw)
    return ExperimentConfig(**base)


def _final_params(directory, step):
    d = torch.load(f"{directory}/step_{step}/state.pt", weights_only=True)
    return {k: v for k, v in d.items() if k.startswith("model/")}


def test_recovery_end_to_end_resumes_from_checkpoint(tmp_path):
    """Crash after epoch 1 → ``run_with_recovery`` restarts from the
    checkpoint, and the final run continues (not restarts) the original:
    its test loss and final checkpoint's parameters are bitwise the
    uninterrupted run's, the restart an exact resume."""
    from distributed_tensorflow_tpu_torch.utils import harness

    steps = 256 // 16
    want = harness.run(_recovery_config(
        tmp_path, checkpoint_dir=str(tmp_path / "u")))
    cfg = _recovery_config(tmp_path, checkpoint_dir=str(tmp_path / "c"),
                           checkpoint_every=10)
    crashed = {"done": False}

    def crash_once(config):
        if not crashed["done"]:
            crashed["done"] = True
            # a short real run writes the checkpoints, then "crashes"
            harness.run(dataclasses.replace(config, epochs=1))
            raise RuntimeError("injected crash after epoch 1")
        return harness.run(config)

    out = run_with_recovery(cfg, max_restarts=1, run_fn=crash_once)
    assert out["restarts"] == 1
    report = out["run_report"]
    assert report["resume_replay_steps"] == 0
    assert report["restored_step"] == steps
    assert report["preemption_lost_s"] >= 0.0
    assert out["steps"] == steps and want["steps"] == 2 * steps
    assert out["test_loss"] == want["test_loss"]
    assert out["test_accuracy"] > 0.5
    got = _final_params(tmp_path / "c", 2 * steps)
    ref = _final_params(tmp_path / "u", 2 * steps)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(v, got[k]), k


def test_cli_recovery_wraps_the_spawn(monkeypatch, tmp_path):
    """``cli -n 2 --max-restarts 1``: a failed spawn of the ranks is
    relaunched whole with ``resume`` and ``elastic_restore`` (no rank
    runs ``run_with_recovery`` itself)."""
    from distributed_tensorflow_tpu_torch import cli

    calls = []

    def fake_spawn(config, n):
        calls.append((n, config.resume, config.elastic_restore,
                      config.max_restarts))
        if len(calls) == 1:
            raise RuntimeError("a rank died")
        return {"steps": 3}

    monkeypatch.setattr(cli, "_spawn", fake_spawn)
    out = cli.main(["--device", "cpu", "-n", "2", "--checkpoint-dir",
                    str(tmp_path), "--checkpoint-every", "2",
                    "--max-restarts", "1"])
    assert out == {"steps": 3, "restarts": 1}
    assert calls == [(2, False, False, 0), (2, True, True, 0)]


def test_spawned_divergence_is_training_diverged(monkeypatch):
    """A rank's ``TrainingDiverged`` reaches the launcher as the spawn's
    ``ProcessRaisedException``; ``_spawn`` re-raises it as
    ``TrainingDiverged``, which recovery never restarts.  Other rank
    failures pass through."""
    from distributed_tensorflow_tpu_torch import cli

    def raising(text):
        def spawn(*args, **kw):
            raise torch.multiprocessing.ProcessRaisedException(text, 1, 7)
        return spawn

    cfg = ExperimentConfig(device="cpu")
    monkeypatch.setattr(torch.multiprocessing, "spawn", raising(
        "Traceback ...\ndistributed_tensorflow_tpu_torch.utils.failure."
        "TrainingDiverged: metric 'loss' is nan at step 3"))
    with pytest.raises(failure.TrainingDiverged, match="diverged"):
        cli._spawn(cfg, 2)
    monkeypatch.setattr(torch.multiprocessing, "spawn",
                        raising("RuntimeError: boom"))
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        cli._spawn(cfg, 2)


def test_run_refuses_recovery_inside_a_multi_rank_group(monkeypatch):
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.utils import harness

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(ValueError, match="wraps the launch"):
        harness.run(ExperimentConfig(max_restarts=1, device="cpu",
                                     checkpoint_dir="/nonexistent"))
