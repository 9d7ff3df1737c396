"""Keras-fit-like Trainer (port of ``engines/allreduce.py``).

``Trainer.fit`` drains the epoch's batches the way the JAX Trainer does:
host batches are staged on the device ``prefetch`` batches ahead
(``data/device_prefetch.py``), and with ``steps_per_call`` k > 1 chunks of
k staged batches run back to back (``Engine.many_step``) with the
per-step loss and accuracy stacked on the device and read by the host
once per chunk; up to ``MAX_IN_FLIGHT`` dispatched chunks stay unread
while no chunk-boundary consumer needs the state.  Heartbeat lines stay
step-exact, and the trajectory is step-for-step identical to k = 1 on
the same seed.  The drain runs eagerly: the JAX package compiles the chunk
as one ``lax.scan`` program; capturing it as a CUDA graph is later work.
k = 1 keeps a loop of its own, as in the JAX Trainer: it reads metrics
only at the log cadence, where chunks of one step under a target
accuracy would each be read before the next eval check
(``tools/drain_k1.py`` measures the difference).

``target_accuracy`` with ``eval_ds`` stops early once a full-test-set
eval reaches the target, evaluated every ``eval_every`` steps far from
it and every ≤ 10 steps within 0.05 of it.  Checkpointing, the watchdog,
telemetry sinks, the health policy and the elastic hooks are not ported:
passing any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from distributed_tensorflow_tpu_torch import not_ported
from distributed_tensorflow_tpu_torch.data.device_prefetch import (
    DevicePrefetch)
from distributed_tensorflow_tpu_torch.engines.sync import SyncEngine
from distributed_tensorflow_tpu_torch.observability.trace import NULL_TRACER
from distributed_tensorflow_tpu_torch.utils.metrics import StepTimer

# steady-state chunk length when no per-step cadence demands step-granular
# host control (see Trainer.resolve_steps_per_call_with_reason)
DEFAULT_STEPS_PER_CALL = 8
# how far the host runs ahead of the device: at k = 1 the dispatched
# steps, in the chunked drain the unread chunks
MAX_IN_FLIGHT = 4


def _check_finite(metrics: dict[str, float], step: int) -> None:
    """The JAX ``check_finite``: a NaN/inf metric ends the fit."""
    for k, v in metrics.items():
        if not math.isfinite(v):
            raise FloatingPointError(f"training diverged: metric '{k}' is "
                                     f"{v} at step {step}")


def _reject_unported(**given) -> None:
    items = {
        "checkpoint_manager": "remaining engines",
        "checkpoint_every": "remaining engines",
        "watchdog": "remaining engines",
        "should_stop": "remaining engines",
        "data_state": "remaining engines",
        "straggler_detector": "remaining engines",
        "metrics_logger": "rest of observability",
        "tracer": "rest of observability",
        "timeline": "rest of observability",
        "roofline": "rest of observability",
        "on_anomaly": "rest of observability",
    }
    for name, value in given.items():
        if value:
            not_ported(f"Trainer.fit {name}", items[name])


class Trainer:
    def __init__(self, model, engine=None, mesh=None,
                 learning_rate: float = 1e-3, seed: int = 0, **engine_kw):
        self.engine = engine if engine is not None else SyncEngine(
            model, mesh=mesh, learning_rate=learning_rate, **engine_kw)
        self.model = self.engine.model
        self.seed = seed
        self.state = None
        self.history: list[dict] = []

    @staticmethod
    def resolve_steps_per_call_with_reason(
            steps_per_call: int | None, *,
            target_accuracy: float | None = None) -> tuple[int, str | None]:
        """(k, clamp_reason): an explicit value wins (validated >= 1);
        auto (``None``) is ``DEFAULT_STEPS_PER_CALL`` unless
        ``target_accuracy`` downshifts it to 1 (the ≤ 10-step eval cadence
        is the steps-to-target resolution, and evals need boundary state
        every step)."""
        if steps_per_call is not None:
            if steps_per_call < 1:
                raise ValueError(
                    f"steps_per_call must be >= 1, got {steps_per_call}")
            return int(steps_per_call), None
        if target_accuracy is not None:
            return 1, "target_accuracy"
        return DEFAULT_STEPS_PER_CALL, None

    def fit(self, train_ds, epochs: int = 1, batch_size: int | None = None,
            log_every: int = 50, log_fn: Callable[[str], None] = print,
            checkpoint_manager=None, checkpoint_every: int = 0,
            metrics_logger=None, watchdog=None, nan_guard: bool = True,
            max_steps: int | None = None, eval_ds=None,
            target_accuracy: float | None = None, eval_every: int = 50,
            eval_batch: int = 100, steps_per_call: int | None = None,
            prefetch: int = 2, tracer=None, on_anomaly: str = "warn",
            should_stop=None, data_state=None, straggler_detector=None,
            timeline=None, roofline=None) -> dict:
        """Train; returns ``{'elapsed': seconds_around_fit, 'steps': n,
        ...}`` (a subset of the JAX Trainer's keys) and appends it to
        ``history``.

        ``self.state`` is initialized from ``seed`` on the first fit.
        ``batch_size`` is the GLOBAL batch (rounded down to a multiple of
        the ranks); every rank draws the same global batches and keeps its
        rows.  A heartbeat line goes to ``log_fn`` every ``log_every``
        steps, and ``nan_guard`` checks the metrics read then (and the
        last step's at the end) for NaN/inf.  Step times are chunk
        averages of the non-overlapped wall time between host reads (at
        k = 1, each step's dispatch)."""
        _reject_unported(
            checkpoint_manager=checkpoint_manager is not None,
            checkpoint_every=checkpoint_every != 0,
            watchdog=watchdog is not None,
            should_stop=should_stop is not None,
            data_state=data_state is not None,
            straggler_detector=straggler_detector is not None,
            metrics_logger=metrics_logger is not None,
            tracer=tracer is not None and tracer is not NULL_TRACER,
            timeline=timeline is not None, roofline=roofline is not None,
            on_anomaly=on_anomaly != "warn")
        if target_accuracy is not None and eval_ds is None:
            raise ValueError("target_accuracy requires eval_ds (nothing "
                             "would ever be evaluated against the target)")
        if prefetch < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {prefetch}")
        eng = self.engine
        n = eng.n_devices
        bs = batch_size or train_ds.batch_size or 32
        bs = (max(bs, n) // n) * n
        # a process-sharded dataset holds this rank's rows: it iterates
        # local batches of bs/n rows, which shard_batch keeps whole
        shard = getattr(train_ds, "process_shard", None)
        process_local = shard is not None and shard[1] > 1
        if process_local and shard[1] != n:
            raise ValueError(
                f"dataset is sharded {shard[1]} ways but the mesh has {n} "
                f"ranks; shard with n_shards == ranks "
                f"(Dataset.process_shard_of)")
        local_bs = bs // n if process_local else bs
        if self.state is None:
            gen = torch.Generator().manual_seed(self.seed)
            self.state = eng.init_state(gen, train_ds.x[:1])
        start_step = self.state.step
        k, clamp_reason = self.resolve_steps_per_call_with_reason(
            steps_per_call, target_accuracy=target_accuracy)
        on_card = eng.device.type == "cuda"
        timer = StepTimer()
        t0 = time.perf_counter()
        steps = examples = 0
        metrics: dict = {}
        last_metrics: dict = {}
        eval_acc = 0.0
        reached = stop = False
        chunk_sizes: set[int] = set()
        pf_starvation, pf_fill_wait = 0, 0.0
        prev_eval_step = 0   # step of the eval BEFORE the current one
        eval_gap = None      # the resolution of a reached target

        def place(batch):
            bx, by, _mask = batch
            return eng.shard_batch(bx, by, process_local=process_local)

        def eval_and_maybe_stop(prev_steps: int, at_cap: bool) -> bool:
            """Target-accuracy eval at the cadence boundary; True = target
            reached, stop now.  Fine cadence (≤ 10 steps) in the first
            window and within 0.05 of the target, coarse in between;
            always at the cap."""
            nonlocal eval_acc, prev_eval_step, eval_gap, reached, stop
            if target_accuracy is None:
                return False
            near = (eval_acc >= target_accuracy - 0.05 or steps <= eval_every)
            cadence = max(min(eval_every, 10) if near else eval_every, 1)
            # crossing test, not modulo: chunk boundaries may step past
            # the due step without landing on it
            if not (steps // cadence > prev_steps // cadence or at_cap):
                return False
            gap = steps - prev_eval_step
            prev_eval_step = steps
            eval_acc = self.evaluate(eval_ds, batch_size=eval_batch)[
                "accuracy"]
            if eval_acc >= target_accuracy:
                eval_gap = gap
                reached = stop = True
                return True
            return False

        def record_step(gstep: int, floats_fn) -> None:
            """The log_every heartbeat with its nan guard; ``floats_fn``
            reads the step's metrics only when the cadence fires."""
            nonlocal last_metrics
            if log_every and steps % log_every == 0:
                m = floats_fn()
                if nan_guard:
                    _check_finite(m, gstep)
                last_metrics = m
                log_fn(f"step {gstep}  loss {m['loss']:.4f}"
                       f"  acc {m['accuracy']:.4f}")

        for epoch in range(epochs):
            if stop:
                break
            pf = DevicePrefetch(
                train_ds.batches(local_bs, shuffle=True, seed=self.seed,
                                 epoch=epoch, drop_remainder=True),
                place, depth=prefetch, device=eng.device)
            try:
                if k == 1:
                    in_flight: list = []
                    for xs, ys in pf:
                        chunk_sizes.add(1)
                        with timer:  # dispatch + throttle
                            self.state, metrics = eng.step(self.state, xs, ys)
                            if on_card:
                                done = torch.cuda.Event()
                                done.record()
                                in_flight.append(done)
                                if len(in_flight) > MAX_IN_FLIGHT:
                                    in_flight.pop(0).synchronize()
                        steps += 1
                        examples += bs  # global examples per step
                        dev_metrics = metrics
                        record_step(start_step + steps, lambda: {
                            kk: float(v) for kk, v in dev_metrics.items()})
                        at_cap = max_steps is not None and steps >= max_steps
                        if eval_and_maybe_stop(steps - 1, at_cap):
                            break
                        if at_cap:
                            stop = True
                            break
                else:
                    # without a chunk-boundary state consumer (the target
                    # eval) up to MAX_IN_FLIGHT chunks stay unread
                    window = MAX_IN_FLIGHT if target_accuracy is None else 0
                    in_flight_chunks: list = []  # (n_steps, t_disp, stacked)
                    t_mark = 0.0

                    def flush_chunk():
                        """Read the oldest dispatched chunk: ONE host sync
                        for its (k,)-stacked metrics, then its per-step
                        bookkeeping."""
                        nonlocal steps, examples, metrics, t_mark
                        n_chunk, t_disp, stacked = in_flight_chunks.pop(0)
                        floats = {kk: v.cpu().numpy()
                                  for kk, v in stacked.items()}
                        now = time.perf_counter()
                        dt = (now - max(t_disp, t_mark)) / n_chunk
                        t_mark = now
                        timer.times.extend([dt] * n_chunk)
                        for i in range(n_chunk):
                            steps += 1
                            examples += bs
                            m = {kk: float(v[i]) for kk, v in floats.items()}
                            metrics = m
                            record_step(start_step + steps, lambda m=m: m)

                    dispatched = steps
                    next_chunk = pf.take(k if max_steps is None
                                         else min(k, max_steps - dispatched))
                    first = not chunk_sizes
                    while not stop and next_chunk:
                        chunk = next_chunk
                        t_disp = time.perf_counter()
                        self.state, stacked = eng.many_step(
                            self.state, [c[0] for c in chunk],
                            [c[1] for c in chunk])
                        if first:
                            # the first chunk carries first-call costs
                            timer.compile_steps = len(chunk)
                            first = False
                        chunk_sizes.add(len(chunk))
                        dispatched += len(chunk)
                        in_flight_chunks.append((len(chunk), t_disp, stacked))
                        # stage chunk N+1 while the device runs chunk N
                        nxt = k if max_steps is None else min(
                            k, max_steps - dispatched)
                        next_chunk = pf.take(nxt) if nxt > 0 else []
                        while len(in_flight_chunks) > window:
                            chunk_start = steps
                            flush_chunk()
                            if window:
                                continue
                            at_cap = (max_steps is not None
                                      and steps >= max_steps)
                            if eval_and_maybe_stop(chunk_start, at_cap):
                                break
                    while in_flight_chunks:
                        flush_chunk()
                    if max_steps is not None and steps >= max_steps:
                        stop = True
            finally:
                pf_starvation += pf.starvation
                pf_fill_wait += pf.fill_wait_s
                pf.close()
        if (target_accuracy is not None and not reached and steps
                and prev_eval_step != steps):
            # ended by exhausting epochs: finish with a real eval so
            # eval_accuracy is never stale
            eval_gap = steps - prev_eval_step
            eval_acc = self.evaluate(eval_ds, batch_size=eval_batch)[
                "accuracy"]
            reached = eval_acc >= target_accuracy
            if not reached:
                eval_gap = None
        if on_card:
            torch.cuda.synchronize(eng.device)
        if nan_guard and steps:
            final = {kk: float(v) for kk, v in metrics.items()}
            _check_finite(final, start_step + steps)
            last_metrics = last_metrics or final
        elapsed = time.perf_counter() - t0
        result = {
            "elapsed": elapsed, "steps": steps, "epochs": epochs,
            "steps_per_call": k, "prefetch_depth": prefetch,
            "chunk_sizes": sorted(chunk_sizes),
            "prefetch_starvation": pf_starvation,
            "prefetch_fill_wait_s": pf_fill_wait,
            **({"steps_per_call_clamp": {
                "requested": DEFAULT_STEPS_PER_CALL, "effective": k,
                "reason": clamp_reason}} if clamp_reason else {}),
            "start_step": start_step, "examples": examples,
            "examples_per_sec": examples / elapsed if elapsed > 0 else 0.0,
            **({"reached_target": reached, "eval_accuracy": eval_acc,
                "eval_resolution": eval_gap}
               if target_accuracy is not None else {}),
            "step_time": timer.summary(),
            **{f"final_{k}": v for k, v in last_metrics.items()},
        }
        self.history.append(result)
        return result

    def evaluate(self, test_ds, batch_size: int = 100) -> dict:
        """Full-test-set eval of the trained state."""
        return self.engine.evaluate(self.state, test_ds, batch_size)
