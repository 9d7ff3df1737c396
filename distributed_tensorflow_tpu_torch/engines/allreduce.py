"""Keras-fit-like Trainer (slim port of ``engines/allreduce.py``).

``Trainer.fit`` runs the JAX Trainer's single-step loop (``steps_per_call``
1): each epoch draws ``train_ds.batches(bs, shuffle=True, seed=seed,
epoch=e, drop_remainder=True)`` and takes one ``engine.step`` per batch,
with the same result keys for what it does.  The scanned multi-step drain
(a CUDA graph in the port), device prefetch, checkpointing, telemetry,
the health policy, target-accuracy early stop and the elastic hooks are
later work (ROADMAP Queue 1): passing any of them raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from distributed_tensorflow_tpu_torch import not_ported
from distributed_tensorflow_tpu_torch.engines.sync import SyncEngine
from distributed_tensorflow_tpu_torch.observability.trace import NULL_TRACER
from distributed_tensorflow_tpu_torch.utils.metrics import StepTimer

_CNN = "training with the CNN/MLP sync path"
_ENGINES = "remaining engines"
_OBS = "rest of observability"


def _check_finite(metrics: dict[str, float], step: int) -> None:
    """The JAX ``check_finite``: a NaN/inf metric ends the fit."""
    for k, v in metrics.items():
        if not math.isfinite(v):
            raise FloatingPointError(f"training diverged: metric '{k}' is "
                                     f"{v} at step {step}")


class Trainer:
    def __init__(self, model, engine=None, mesh=None,
                 learning_rate: float = 1e-3, seed: int = 0, **engine_kw):
        self.engine = engine if engine is not None else SyncEngine(
            model, mesh=mesh, learning_rate=learning_rate, **engine_kw)
        self.model = self.engine.model
        self.seed = seed
        self.state = None
        self.history: list[dict] = []

    def fit(self, train_ds, epochs: int = 1, batch_size: int | None = None,
            log_every: int = 50, log_fn: Callable[[str], None] = print,
            max_steps: int | None = None, eval_ds=None, eval_every: int = 50,
            eval_batch: int = 100, nan_guard: bool = True,
            steps_per_call: int | None = None, prefetch: int = 0,
            checkpoint_manager=None, checkpoint_every: int = 0,
            metrics_logger=None, watchdog=None,
            target_accuracy: float | None = None, tracer=None,
            on_anomaly: str = "warn", should_stop=None, data_state=None,
            straggler_detector=None, timeline=None, roofline=None) -> dict:
        """Train; returns ``{'elapsed': seconds_around_fit, 'steps': n,
        ...}`` and appends it to ``history``.

        ``self.state`` is initialized from ``seed`` on the first fit.  A
        heartbeat line goes to ``log_fn`` every ``log_every`` steps, and
        ``nan_guard`` checks the metrics it materializes then (and the last
        step's at the end) for NaN/inf.  ``eval_ds``/``eval_every``/
        ``eval_batch`` serve the target-accuracy early stop only, as in the
        JAX Trainer, so ``eval_ds`` raises with it.  The step times are host
        times of each step's dispatch: the device runs behind the host until
        the final synchronize, which ``elapsed`` includes."""
        del eval_every, eval_batch
        unported = {
            "steps_per_call > 1 (the scanned drain)": steps_per_call not in (
                None, 1),
            "device prefetch (prefetch > 0)": prefetch != 0,
            "target_accuracy/eval_ds early stop": (
                target_accuracy is not None or eval_ds is not None),
        }
        later = {
            "checkpointing": (checkpoint_manager is not None
                              or checkpoint_every != 0),
            "the watchdog": watchdog is not None,
            "should_stop (lease drain)": should_stop is not None,
            "data_state (elastic resume)": data_state is not None,
            "straggler_detector": straggler_detector is not None,
        }
        telemetry = {
            "metrics_logger": metrics_logger is not None,
            "tracer": tracer is not None and tracer is not NULL_TRACER,
            "timeline": timeline is not None,
            "roofline": roofline is not None,
            "on_anomaly (health policy)": on_anomaly != "warn",
        }
        for table, item in ((unported, _CNN), (later, _ENGINES),
                            (telemetry, _OBS)):
            for what, given in table.items():
                if given:
                    not_ported(f"Trainer.fit {what}", item)

        eng = self.engine
        bs = batch_size or 32
        if self.state is None:
            gen = torch.Generator().manual_seed(self.seed)
            self.state = eng.init_state(gen, train_ds.x[:1])
        start_step = self.state.step
        timer = StepTimer()
        t0 = time.perf_counter()
        steps = examples = 0
        metrics: dict = {}
        last_metrics: dict = {}
        stop = False
        for epoch in range(epochs):
            if stop:
                break
            for bx, by, _mask in train_ds.batches(
                    bs, shuffle=True, seed=self.seed, epoch=epoch,
                    drop_remainder=True):
                with timer:
                    xs, ys = eng.shard_batch(bx, by)
                    self.state, metrics = eng.step(self.state, xs, ys)
                steps += 1
                gstep = start_step + steps
                examples += bs
                if log_every and steps % log_every == 0:
                    m = {kk: float(v) for kk, v in metrics.items()}
                    if nan_guard:
                        _check_finite(m, gstep)
                    last_metrics = m
                    log_fn(f"step {gstep}  loss {m['loss']:.4f}"
                           f"  acc {m['accuracy']:.4f}")
                if max_steps is not None and steps >= max_steps:
                    stop = True
                    break
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        if nan_guard and steps:
            final = {kk: float(v) for kk, v in metrics.items()}
            _check_finite(final, start_step + steps)
            last_metrics = last_metrics or final
        elapsed = time.perf_counter() - t0
        result = {
            "elapsed": elapsed, "steps": steps, "epochs": epochs,
            "steps_per_call": 1,
            "start_step": start_step, "examples": examples,
            "examples_per_sec": examples / elapsed if elapsed > 0 else 0.0,
            "step_time": timer.summary(),
            **{f"final_{k}": v for k, v in last_metrics.items()},
        }
        self.history.append(result)
        return result

    def evaluate(self, test_ds, batch_size: int = 100) -> dict:
        """Full-test-set eval of the trained state."""
        return self.engine.evaluate(self.state, test_ds, batch_size)
