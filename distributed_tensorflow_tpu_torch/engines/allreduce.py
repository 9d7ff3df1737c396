"""Keras-fit-like Trainer (port of ``engines/allreduce.py``).

``Trainer.fit`` drains the epoch's batches the way the JAX Trainer does:
host batches are staged on the device ``prefetch`` batches ahead
(``data/device_prefetch.py``), and with ``steps_per_call`` k > 1 chunks of
k staged batches run back to back (``Engine.many_step``) with the
per-step loss and accuracy stacked on the device and read by the host
once per chunk; up to ``MAX_IN_FLIGHT`` dispatched chunks stay unread
while no chunk-boundary consumer needs the state.  Heartbeat lines stay
step-exact, and the trajectory is step-for-step identical to k = 1 on
the same seed.  The JAX package compiles the chunk as one ``lax.scan``
program; on the card ``SyncEngine`` replays it as a CUDA graph, the other
engines run it eagerly.  k = 1 keeps a loop of its own, as in the JAX
Trainer: it reads metrics only at the log cadence, where chunks of one
step under a target accuracy would each be read before the next eval
check (``tools/drain_k1.py`` measures the difference).

``target_accuracy`` with ``eval_ds`` stops early once a full-test-set
eval reaches the target, evaluated every ``eval_every`` steps far from
it and every ≤ 10 steps within 0.05 of it.

The result names the engine's precision policy and the per-device
parameter and optimizer bytes, and, where the engine exchanges gradients
or parameters, the wire bytes of one exchange under its codec beside the
raw figure (``grad_allreduce_bytes``, ``grad_allreduce_bytes_raw``,
``grad_compression``, ``grad_bucket_mb``); under fp16 loss scaling it also carries a
``loss_scale`` section (the final scale, the count of skipped steps and up
to 64 of their numbers), read from the per-step ``loss_scale`` and
``ls_skipped`` metrics, which the Trainer then reads every step as the
JAX Trainer does.  ``nan_guard`` checks the metrics read at the log
cadence: a NaN/inf raises ``utils.failure.TrainingDiverged``, which crash
recovery never restarts, unless the scaler skipped the step (the scaler
already answered its non-finite gradients; JAX's cadence check has no
such waiver, its health policy has).

With the engine's health layer on (``Engine.enable_health``) every step's
health stats are read at its chunk's flush (each step at k = 1) and
``on_anomaly`` decides (JAX ``allreduce.py:217-330``): each offending
stat becomes an ``anomaly`` trace event; ``'halt'`` raises
``AnomalyDetected`` at the step, after its metrics record is logged;
under ``'warn'`` a non-finite anomaly stays fatal unless ``nan_guard``
is False (the cadence check itself is off: health subsumes it), and
other anomalies warn once.  A step the fp16 scaler skipped is waived: the
scaler already answered its non-finite gradients.  The result gains a
``health`` section (the anomaly record and the run maxima).  ``roofline``
(``observability.roofline.Roofline``) adds the analytic model FLOPs of a
step, the achieved rate over the fit, ``train_mfu`` and the peak table's
revision to the result, and the achieved rate of each chunk to the
timeline.

``checkpoint_manager`` (``utils/checkpoint.py``) writes a checkpoint at
the first chunk boundary at or after every ``checkpoint_every`` steps
and a final one, each with its data state as the elastic sidecar;
``watchdog`` (``utils/failure.Watchdog``) beats once per dispatch and per
flush, its per-step budget scaled by k; ``should_stop`` (the lease,
``elastic/lease.py``) ends the fit at a chunk boundary (its reason in
``preempted``) after the final checkpoint; ``data_state`` (a
checkpoint's sidecar) resumes the batch stream exactly where the
checkpoint left it.

Telemetry rides the drain without downshifting it, with the JAX
Trainer's names at the JAX Trainer's places: ``tracer``
(``observability.Tracer``) gets the ``compile`` span (the first
dispatch: on the card the first chunk builds the kernels and captures
the CUDA graph), ``chunk_dispatch``, ``materialize``, ``checkpoint`` (a
synchronous save) or ``ckpt_snapshot`` (the async manager's, whose
writer thread adds ``ckpt_write``), ``eval``, the ``prefetch_depth``
gauge at each chunk boundary and the ``collective_profile`` and
``loss_scale`` events; ``metrics_logger`` (``utils.metrics.MetricsLogger``)
logs every step's metrics, read from the chunk's stacked trajectory at
its flush (bitwise the k = 1 records), before the nan guard sees them;
``timeline`` (``observability.Timeline``) samples ``chunk_step_time_s``
and ``prefetch_depth`` at each chunk boundary; ``straggler_detector``
(``elastic.StragglerDetector``) observes each step time at k = 1 and each
chunk's average step time in the chunked drain, and its report rides the
result as ``stragglers``.  None of them reads the device beyond the
drain's own reads, and none changes a loss.
"""

from __future__ import annotations

import contextlib
import functools
import math
import time
import warnings
from typing import Callable

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.data.device_prefetch import (
    DevicePrefetch)
from distributed_tensorflow_tpu_torch.elastic.data_state import DataState
from distributed_tensorflow_tpu_torch.engines.sync import SyncEngine
from distributed_tensorflow_tpu_torch.observability import health as healthlib
from distributed_tensorflow_tpu_torch.observability.trace import NULL_TRACER
from distributed_tensorflow_tpu_torch.utils.failure import (
    AnomalyDetected, check_finite)
from distributed_tensorflow_tpu_torch.utils.metrics import StepTimer

# steady-state chunk length when no per-step cadence demands step-granular
# host control (see Trainer.resolve_steps_per_call_with_reason)
DEFAULT_STEPS_PER_CALL = 8
# how far the host runs ahead of the device: at k = 1 the dispatched
# steps, in the chunked drain the unread chunks
MAX_IN_FLIGHT = 4


def _check_finite(metrics: dict[str, float], step: int) -> None:
    """``failure.check_finite``: a NaN/inf metric raises
    ``TrainingDiverged``, unless the loss scaler skipped the step."""
    if metrics.get("ls_skipped"):
        return
    check_finite(metrics, step)


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
            target_accuracy: float | None = None,
            checkpoint_every: int = 0,
            checkpoint_async: bool = False) -> tuple[int, str | None]:
        """(k, clamp_reason): an explicit value wins (validated >= 1);
        auto (``None``) is ``DEFAULT_STEPS_PER_CALL`` unless
        ``target_accuracy`` downshifts it to 1 (the ≤ 10-step eval cadence
        is the steps-to-target resolution, and evals need boundary state
        every step) or a ``checkpoint_every`` shorter than the chunk caps
        it (state exists only at chunk boundaries; the reason says whether
        each boundary then pays a blocking save, ``checkpoint_sync``, or a
        snapshot, ``checkpoint_async``).  With an explicit value,
        checkpoints land on the first chunk boundary at or after each due
        step."""
        if steps_per_call is not None:
            if steps_per_call < 1:
                raise ValueError(
                    f"steps_per_call must be >= 1, got {steps_per_call}")
            return int(steps_per_call), None
        if target_accuracy is not None:
            return 1, "target_accuracy"
        if 0 < checkpoint_every < DEFAULT_STEPS_PER_CALL:
            return checkpoint_every, ("checkpoint_async" if checkpoint_async
                                      else "checkpoint_sync")
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

        ``checkpoint_manager``/``checkpoint_every``: periodic TrainState
        checkpoints at the first chunk boundary at or after each due step
        (+ one final), every one with the elastic sidecar (its data state
        and save wall time); an async manager pays only the snapshot on
        this thread and the final save drains it, and the result splits
        the cost as ``checkpoint_wait_s`` against
        ``checkpoint_overlapped_s``.  ``watchdog``: beaten after every
        dispatch and every flush, its budget rescaled to k steps.
        ``should_stop(steps_done) -> reason | None``: consulted at every
        chunk boundary (each step at k = 1); a reason finishes the
        in-flight chunks, writes the final checkpoint and returns with
        ``result['preempted'] = reason``.  ``data_state`` (a
        checkpoint's sidecar, possibly ``{}``): a matching state continues
        the batch stream at its (epoch, batch), ``resume_replay_steps``
        0; a missing or mismatched one restarts it at epoch 0 and reports
        ``resume_replay_steps = start_step``.

        ``self.state`` is initialized from ``seed`` on the first fit.
        ``batch_size`` is the GLOBAL batch (rounded down to a multiple of
        the ranks); every rank draws the same global batches and keeps its
        rows.  A heartbeat line goes to ``log_fn`` every ``log_every``
        steps, and ``nan_guard`` checks the metrics read then (and the
        last step's at the end) for NaN/inf.  Step times are chunk
        averages of the non-overlapped wall time between host reads (at
        k = 1, each step's dispatch).

        ``on_anomaly`` (``'warn'`` or ``'halt'``) is the health policy
        with the engine's health layer on; ``roofline`` adds the
        roofline keys (module docstring)."""
        if tracer is None:
            tracer = NULL_TRACER
        if on_anomaly not in ("warn", "halt"):
            raise ValueError(
                f"on_anomaly must be 'warn' or 'halt', got '{on_anomaly}'")
        # the health policy (JAX :226-242): with health on the loss-only
        # guard's cadence checks are off, but divergence stays fatal
        # under 'warn' unless nan_guard was turned off
        health_cfg = self.engine.health
        guard_divergence = nan_guard
        nan_guard = nan_guard and health_cfg is None
        h_max: dict = {}
        anomaly_steps: list[int] = []
        first_anomaly = None
        n_anomalies = 0
        warned_anomaly = False
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
        # global step offset: nonzero after a resume, so heartbeats and
        # the checkpoint cadence continue the original numbering
        start_step = self.state.step
        # exactly-once data resume (elastic/data_state.py): a matching
        # data state positions the stream at the (epoch, batch) the saved
        # step had consumed; None keeps the plain resume (stream restarts
        # at epoch 0, no accounting); a state that does not match this
        # run's seed/batch/dataset restarts the stream and reports the
        # unrecoverable positions as resume_replay_steps
        ds_name = getattr(train_ds, "name", "dataset")
        start_epoch = start_batch = 0
        replay_steps = None
        if data_state is not None:
            restored_ds = DataState.from_json(data_state)
            if restored_ds is not None and restored_ds.matches(
                    seed=self.seed, batch_size=local_bs,
                    dataset_len=len(train_ds), dataset=ds_name):
                start_epoch, start_batch = (restored_ds.epoch,
                                            restored_ds.batch_index)
                replay_steps = 0
            else:
                replay_steps = start_step
                if start_step:
                    log_fn(f"elastic resume: checkpoint carries no "
                           f"matching data state — the batch stream "
                           f"restarts from epoch 0 "
                           f"(resume_replay_steps={start_step})")
        ckpt_async = bool(getattr(checkpoint_manager, "asynchronous", False))
        if ckpt_async:
            # the writer thread's ckpt_write spans join this fit's trace
            checkpoint_manager.tracer = tracer
        ckpt_wait = 0.0        # training-thread seconds in checkpointing
        ckpt_last_step = None  # skip a final save the cadence already wrote
        # managers outlive fits: report THIS fit's overlapped seconds
        ckpt_overlap0 = getattr(checkpoint_manager, "overlapped_s", 0.0)
        # the batch-stream position of the CURRENT epoch: its stream
        # started at epoch_offset when the step counter was epoch_base, so
        # a boundary's position is epoch_offset + (steps - epoch_base) —
        # the step counter, not the prefetch producer, which is how
        # read-ahead gets discounted
        cur_epoch, epoch_base, epoch_offset = start_epoch, 0, start_batch
        last_data_state = None

        def current_data_state() -> dict:
            return DataState(
                epoch=cur_epoch,
                batch_index=epoch_offset + (steps - epoch_base),
                seed=self.seed, batch_size=local_bs,
                dataset_len=len(train_ds), dataset=ds_name).to_json()

        def do_checkpoint(step: int, final: bool = False) -> None:
            """One boundary checkpoint with its elastic sidecar: the
            synchronous manager blocks for the write, the async one pays
            the snapshot (+ any previous-write backpressure) and, on the
            final save, drains, so fit never returns with a write in
            flight.  A final boundary the cadence already saved only
            drains."""
            nonlocal ckpt_wait, ckpt_last_step, last_data_state
            t_ck = time.perf_counter()
            write = not (final and step == ckpt_last_step)
            attrs = {"step": step, **({"final": True} if final else {})}
            with tracer.span("ckpt_snapshot" if ckpt_async
                             else "checkpoint", **attrs) \
                    if ckpt_async or write else contextlib.nullcontext():
                if write:
                    last_data_state = current_data_state()
                    checkpoint_manager.save(
                        self.state, step=step,
                        extra={"data_state": last_data_state,
                               "wall_time": time.time(), "step": step,
                               "schema": 1})
                if final and ckpt_async:
                    checkpoint_manager.wait()
            ckpt_last_step = step
            ckpt_wait += time.perf_counter() - t_ck

        k, clamp_reason = self.resolve_steps_per_call_with_reason(
            steps_per_call, target_accuracy=target_accuracy,
            checkpoint_every=(checkpoint_every
                              if checkpoint_manager is not None else 0),
            checkpoint_async=ckpt_async)
        if clamp_reason == "checkpoint_sync":
            warnings.warn(
                f"checkpoint_every={checkpoint_every} caps the "
                f"steady-state drain at steps_per_call={k} (auto "
                f"default {DEFAULT_STEPS_PER_CALL}): state exists only "
                f"at chunk boundaries, so the requested crash-loss "
                f"window shortens the chunk — and each boundary pays a "
                f"blocking synchronous save.  Pass an explicit "
                f"--steps-per-call to keep longer chunks (checkpoints "
                f"then land on the first boundary at/after each due "
                f"step), or use the async checkpoint manager to take "
                f"the save off the critical path.", stacklevel=2)
        if watchdog is not None:
            # one beat per dispatch and per flush: the per-step stall
            # budget becomes a per-beat budget of k × timeout
            watchdog.rescale(k)
        # --roofline: the analytic model FLOPs of one optimizer step (the
        # GPT family on a (B, L) token batch; else None)
        rf_flops_step = None
        if roofline is not None and roofline.cost is not None:
            xshape = np.shape(train_ds.x)
            if len(xshape) == 2:
                rf_flops_step = roofline.cost.train_step_flops(
                    bs, int(xshape[1]),
                    grad_accum=int(getattr(eng, "grad_accum", 1) or 1))
        on_card = eng.device.type == "cuda"
        # the gradient exchange's payload under the codec and raw
        grad_bytes = eng.grad_collective_bytes(self.state)
        grad_bytes_raw = eng.grad_collective_bytes_raw(self.state)
        codec = eng.grad_codec
        if grad_bytes:
            tracer.event("collective_profile",
                         grad_allreduce_bytes=grad_bytes,
                         grad_allreduce_bytes_raw=grad_bytes_raw,
                         grad_compression=codec.name,
                         grad_bucket_mb=float(getattr(codec, "bucket_mb",
                                                      0.0)),
                         n_devices=n)
        timer = StepTimer()
        t0 = time.perf_counter()
        steps = examples = 0
        metrics: dict = {}
        last_metrics: dict = {}
        eval_acc = 0.0
        reached = stop = False
        preempted = None     # should_stop's reason once the drain fires
        compiled = False     # the first dispatch is spanned as 'compile'
        chunk_sizes: set[int] = set()
        pf_starvation, pf_fill_wait = 0, 0.0
        prev_eval_step = 0   # step of the eval BEFORE the current one
        eval_gap = None      # the resolution of a reached target
        # fp16 loss scaling: the skip accounting of JAX allreduce.py:243-275
        ls_active = eng.precision.loss_scaling
        ls_skipped_steps: list[int] = []
        ls_n_skipped = 0
        ls_last_scale = None

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
            with tracer.span("eval", step=steps):
                eval_acc = self.evaluate(eval_ds, batch_size=eval_batch)[
                    "accuracy"]
            if eval_acc >= target_accuracy:
                eval_gap = gap
                reached = stop = True
                return True
            return False

        def note_loss_scale(gstep: int, floats: dict) -> None:
            """Record the running scale and turn each skipped step into a
            ``loss_scale`` trace event."""
            nonlocal ls_last_scale, ls_n_skipped
            ls_last_scale = floats["loss_scale"]
            if floats["ls_skipped"]:
                ls_n_skipped += 1
                if len(ls_skipped_steps) < 64:
                    ls_skipped_steps.append(gstep)
                tracer.event("loss_scale", step=gstep,
                             action="backoff_skip", scale=ls_last_scale)

        def note_health(gstep: int, floats: dict) -> None:
            """The per-step anomaly policy over the step's floats (JAX
            ``note_health``): the run maxima, one ``anomaly`` trace event
            per offending stat, and the response — the step's metrics
            record is already logged."""
            nonlocal first_anomaly, n_anomalies, warned_anomaly
            for stat in ("grad_norm", "update_ratio", "loss_spike"):
                v = floats.get(stat)
                if v is not None and math.isfinite(v):
                    h_max[stat] = max(h_max.get(stat, v), v)
            anomalies = healthlib.detect_anomalies(floats, health_cfg)
            if not anomalies:
                return
            n_anomalies += len(anomalies)
            if first_anomaly is None:
                first_anomaly = gstep
            if len(anomaly_steps) < 64:  # bounded: a NaN'd run flags every
                anomaly_steps.append(gstep)  # step until it ends
            for a in anomalies:
                tracer.event("anomaly", step=gstep, policy=on_anomaly, **a)
            a = anomalies[0]
            if floats.get("ls_skipped"):
                # the loss scaler already answered this step's non-finite
                # gradients (skip + backoff); the events above record it
                return
            if on_anomaly == "halt":
                raise AnomalyDetected(
                    f"health anomaly at step {gstep}: {a['stat']}="
                    f"{a['value']} ({a['reason']}; limit {a['limit']}) — "
                    f"halted by on_anomaly='halt'")
            diverged = [x for x in anomalies if x["kind"] == "nonfinite"]
            if guard_divergence and diverged:
                d = diverged[0]
                raise AnomalyDetected(
                    f"training diverged at step {gstep}: {d['stat']}="
                    f"{d['value']} ({d['reason']}) — fatal under the "
                    f"nan-guard default; pass nan_guard=False "
                    f"(--no-nan-guard) to record and continue")
            if not warned_anomaly:
                warned_anomaly = True
                log_fn(f"step {gstep}  ANOMALY {a['stat']}={a['value']} "
                       f"({a['reason']}) — continuing under "
                       f"on_anomaly='warn'")

        def record_step(gstep: int, floats_fn) -> None:
            """The per-step sinks: the metrics logger (first — a diverging
            step's record must reach the sink before the guard raises),
            the log_every heartbeat with its nan guard, then the
            loss-scale bookkeeping and the health policy; ``floats_fn``
            reads the step's metrics only when one of them needs them."""
            nonlocal last_metrics
            if metrics_logger is not None and metrics_logger.should_log(
                    gstep):
                floats = floats_fn()
                metrics_logger.log(gstep, **floats)
                if nan_guard:
                    _check_finite(floats, gstep)
            if log_every and steps % log_every == 0:
                m = floats_fn()
                if nan_guard:
                    _check_finite(m, gstep)
                last_metrics = m
                log_fn(f"step {gstep}  loss {m['loss']:.4f}"
                       f"  acc {m['accuracy']:.4f}")
            if ls_active:
                note_loss_scale(gstep, floats_fn())
            if health_cfg is not None:
                note_health(gstep, floats_fn())

        # a failed fit (divergence, a raising engine or log_fn) must not
        # leave a write in flight: the prefetcher closes in its per-epoch
        # finally, and the except below drains the checkpoint writer
        # (reraise=False: the cleanup never masks the original error)
        try:
            for epoch in range(start_epoch, epochs):
                if stop:
                    break
                # only the FIRST resumed epoch starts at the restored
                # offset; the shuffle is a function of (seed, epoch)
                ebatch = start_batch if epoch == start_epoch else 0
                cur_epoch, epoch_base, epoch_offset = epoch, steps, ebatch
                pf = DevicePrefetch(
                    train_ds.batches(local_bs, shuffle=True, seed=self.seed,
                                     epoch=epoch, drop_remainder=True,
                                     start_batch=ebatch),
                    place, depth=prefetch, device=eng.device)
                try:
                    if k == 1:
                        in_flight: list = []
                        for xs, ys in pf:
                            chunk_sizes.add(1)
                            with timer:  # dispatch + throttle
                                with tracer.span("chunk_dispatch" if compiled
                                                 else "compile", steps=1):
                                    self.state, metrics = eng.step(
                                        self.state, xs, ys)
                                compiled = True
                                if on_card:
                                    done = torch.cuda.Event()
                                    done.record()
                                    in_flight.append(done)
                                    if len(in_flight) > MAX_IN_FLIGHT:
                                        in_flight.pop(0).synchronize()
                            if watchdog is not None:
                                # after dispatch + throttle: the throttle
                                # bounds how far the loop runs ahead of
                                # the device, so a hung device stops the
                                # beats within the window
                                watchdog.beat()
                            steps += 1
                            gstep = start_step + steps
                            examples += bs  # global examples per step
                            if straggler_detector is not None:
                                # the step's dispatch + throttle time: the
                                # k = 1 rendering of the chunk average
                                straggler_detector.observe(
                                    gstep, timer.times[-1])
                            floats = functools.cache(
                                lambda m=metrics: {kk: float(v)
                                                   for kk, v in m.items()})
                            record_step(gstep, floats)
                            if checkpoint_manager is not None and \
                                    checkpoint_every and \
                                    gstep % checkpoint_every == 0:
                                do_checkpoint(gstep)
                            if should_stop is not None:
                                # every step is a chunk boundary at k = 1;
                                # the final checkpoint runs at loop exit
                                reason = should_stop(steps)
                                if reason:
                                    preempted, stop = reason, True
                                    break
                            at_cap = (max_steps is not None
                                      and steps >= max_steps)
                            if eval_and_maybe_stop(steps - 1, at_cap):
                                break
                            if at_cap:
                                stop = True
                                break
                    else:
                        # without a chunk-boundary state consumer (a
                        # checkpoint, the target eval, should_stop) up to
                        # MAX_IN_FLIGHT chunks stay unread; with one,
                        # every chunk is read at its boundary
                        window = (MAX_IN_FLIGHT
                                  if checkpoint_manager is None
                                  and target_accuracy is None
                                  and should_stop is None else 0)
                        in_flight_chunks: list = []  # (n, t_disp, stacked)
                        t_mark = 0.0

                        def flush_chunk():
                            """Read the oldest dispatched chunk: ONE host
                            sync for its (k,)-stacked metrics, then its
                            per-step bookkeeping."""
                            nonlocal steps, examples, metrics, t_mark
                            n_chunk, t_disp, stacked = in_flight_chunks.pop(0)
                            with tracer.span("materialize", steps=n_chunk):
                                floats = {kk: v.cpu().numpy()
                                          for kk, v in stacked.items()}
                            # prefetch gauges ride the same host read
                            tracer.gauge("prefetch_depth", pf.queue_depth,
                                         starvation=pf.starvation)
                            now = time.perf_counter()
                            dt = (now - max(t_disp, t_mark)) / n_chunk
                            t_mark = now
                            if timeline is not None:
                                # chunk step time and prefetch depth at
                                # the same boundary: no extra reads
                                tl_vals = {"chunk_step_time_s": dt,
                                           "prefetch_depth": pf.queue_depth}
                                if rf_flops_step is not None and dt > 0:
                                    # --roofline: the chunk's achieved
                                    # model-FLOPs rate on the same series
                                    tl_vals["achieved_flops_per_sec"] = \
                                        rf_flops_step / dt
                                timeline.sample_many(tl_vals,
                                                     group="trainer")
                            timer.times.extend([dt] * n_chunk)
                            if straggler_detector is not None:
                                # the chunk's average step time against
                                # the running median, labelled with the
                                # chunk's last step
                                straggler_detector.observe(
                                    start_step + steps + n_chunk, dt)
                            if watchdog is not None:
                                # flush beat: device progress confirmed
                                watchdog.beat()
                            for i in range(n_chunk):
                                steps += 1
                                examples += bs
                                m = {kk: float(v[i])
                                     for kk, v in floats.items()}
                                metrics = m
                                record_step(start_step + steps, lambda m=m: m)

                        dispatched = steps
                        next_chunk = pf.take(
                            k if max_steps is None
                            else min(k, max_steps - dispatched))
                        while not stop and next_chunk:
                            chunk = next_chunk
                            t_disp = time.perf_counter()
                            with tracer.span("chunk_dispatch" if compiled
                                             else "compile",
                                             steps=len(chunk)):
                                self.state, stacked = eng.many_step(
                                    self.state, [c[0] for c in chunk],
                                    [c[1] for c in chunk])
                            if not compiled:
                                # the first chunk carries first-call costs
                                timer.compile_steps = len(chunk)
                                compiled = True
                            if watchdog is not None:
                                # a dispatch beat too: it arms the clock
                                # past the first chunk's builds and capture
                                # before the first flush
                                watchdog.beat()
                            chunk_sizes.add(len(chunk))
                            dispatched += len(chunk)
                            in_flight_chunks.append((len(chunk), t_disp,
                                                     stacked))
                            # stage chunk N+1 while the device runs chunk N
                            nxt = k if max_steps is None else min(
                                k, max_steps - dispatched)
                            next_chunk = pf.take(nxt) if nxt > 0 else []
                            while len(in_flight_chunks) > window:
                                chunk_start = steps
                                flush_chunk()
                                if window:
                                    continue
                                # the boundary: self.state is the state
                                # after the chunk just read
                                if checkpoint_manager is not None and \
                                        checkpoint_every and \
                                        (start_step + steps) \
                                        // checkpoint_every > \
                                        (start_step + chunk_start) \
                                        // checkpoint_every:
                                    # first boundary at/after the due step
                                    do_checkpoint(start_step + steps)
                                if should_stop is not None:
                                    reason = should_stop(steps)
                                    if reason:
                                        preempted, stop = reason, True
                                        break
                                at_cap = (max_steps is not None
                                          and steps >= max_steps)
                                if eval_and_maybe_stop(chunk_start, at_cap):
                                    break
                        while in_flight_chunks:
                            flush_chunk()
                        if not stop and should_stop is not None:
                            # the drained epoch end is a boundary too
                            reason = should_stop(steps)
                            if reason:
                                preempted, stop = reason, True
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
            if checkpoint_manager is not None:
                do_checkpoint(start_step + steps, final=True)
        except BaseException:
            if checkpoint_manager is not None:
                try:
                    checkpoint_manager.wait(reraise=False)
                except Exception:
                    pass
            # no buffered record outlives a raising fit
            for sink in (metrics_logger, tracer):
                try:
                    if sink is not None:
                        sink.flush()
                except Exception:
                    pass
            raise
        # --roofline: the achieved model FLOPs over the whole fit (first
        # chunk's builds and capture included) and its MFU
        rf_achieved = (rf_flops_step * steps / elapsed
                       if rf_flops_step and steps and elapsed > 0 else None)
        result = {
            "elapsed": elapsed, "steps": steps, "epochs": epochs,
            "steps_per_call": k, "prefetch_depth": prefetch,
            "chunk_sizes": sorted(chunk_sizes),
            "prefetch_starvation": pf_starvation,
            "prefetch_fill_wait_s": pf_fill_wait,
            **({"steps_per_call_clamp": {
                "requested": DEFAULT_STEPS_PER_CALL, "effective": k,
                "reason": clamp_reason}} if clamp_reason else {}),
            # checkpoint cost: training-thread seconds inside save/drain
            # calls against writer seconds hidden behind training
            **({"checkpoint_wait_s": ckpt_wait,
                "checkpoint_overlapped_s": (
                    getattr(checkpoint_manager, "overlapped_s", 0.0)
                    - ckpt_overlap0),
                "checkpoint_async": ckpt_async}
               if checkpoint_manager is not None else {}),
            # should_stop's reason when it ended the fit, None otherwise
            "preempted": preempted,
            # steps whose data position a resume could not restore (only
            # when this fit resumed with a data state; 0 = exact)
            **({"resume_replay_steps": replay_steps}
               if data_state is not None else {}),
            # step-time outlier summary (elastic/stragglers.py)
            **({"stragglers": straggler_detector.report()}
               if straggler_detector is not None else {}),
            # the batch-stream position of the LAST checkpoint written
            **({"data_state": last_data_state}
               if last_data_state is not None else {}),
            **({"watchdog_beats": watchdog.beats,
                "watchdog_stalls": watchdog.stall_episodes}
               if watchdog is not None else {}),
            "start_step": start_step, "examples": examples,
            "examples_per_sec": examples / elapsed if elapsed > 0 else 0.0,
            **({"reached_target": reached, "eval_accuracy": eval_acc,
                "eval_resolution": eval_gap}
               if target_accuracy is not None else {}),
            "step_time": timer.summary(),
            **({"grad_allreduce_bytes": grad_bytes,
                "grad_allreduce_bytes_raw": grad_bytes_raw,
                "grad_compression": codec.name,
                "grad_bucket_mb": float(getattr(codec, "bucket_mb", 0.0))}
               if grad_bytes else {}),
            "precision": eng.precision.name,
            "param_bytes_per_device": eng.param_bytes_per_device(self.state),
            "opt_state_bytes_per_device":
                eng.opt_state_bytes_per_device(self.state),
            **({"loss_scale": {
                "final_scale": ls_last_scale,
                "skipped_steps": ls_n_skipped,
                "skipped_step_list": ls_skipped_steps,
            }} if ls_active else {}),
            # the health record (health on): anomalies and the run maxima
            **({"health": {
                "on_anomaly": on_anomaly,
                "anomalies": n_anomalies,
                "anomaly_steps": anomaly_steps,
                "first_anomaly_step": first_anomaly,
                "max_grad_norm": h_max.get("grad_norm"),
                "max_update_ratio": h_max.get("update_ratio"),
                "max_loss_spike": h_max.get("loss_spike"),
            }} if health_cfg is not None else {}),
            # --roofline (only then): analytic model FLOPs a step, the
            # achieved rate and MFU over the run's devices × the peak
            # (None on an unknown card or a non-GPT model)
            **({"train_model_flops_per_step": rf_flops_step,
                "train_achieved_flops_per_sec": rf_achieved,
                "train_mfu": roofline.mfu(rf_achieved),
                "roofline_peak_table_revision": roofline.revision}
               if roofline is not None else {}),
            **{f"final_{k}": v for k, v in last_metrics.items()},
        }
        self.history.append(result)
        return result

    def evaluate(self, test_ds, batch_size: int = 100) -> dict:
        """Full-test-set eval of the trained state."""
        return self.engine.evaluate(self.state, test_ds, batch_size)
