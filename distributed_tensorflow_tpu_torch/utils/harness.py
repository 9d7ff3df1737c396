"""Experiment harness (slim port of ``utils/harness.py``): the config the
CLI fills, the setup of a data-parallel run on this process's rank, and
the run that trains, evaluates and reports.

Served here: the ``sync`` and ``allreduce`` engines (the reference's
``-m c -cs sync`` and ``-m d -ds keras``), ``async`` (``-m c -cs async``,
local SGD averaging every ``sync_every`` steps) and ``gossip`` (``-m d -ds
graph|custom``, a ring mix of degree ``degree``) with the ported models
and datasets.  The summary's test accuracy is the consensus model's:
``Engine.evaluate`` goes through ``eval_params``, the ranks' mean under
async and gossip.  A run computes the models' f32 math in full f32: TF32
is off for matmuls and convolutions while it runs (torch's default lets
cuDNN convolutions use TF32), and cuDNN is held to deterministic
algorithms with its autotuner off, so that one seed gives the same run
bitwise on the card, as it does under XLA (``_repeatable_math``).
``precision`` picks the mixed-precision
policy (``parallel/precision.py``): a non-f32 policy stores the
parameters in 16 bits and the model computes in the policy's dtype
(``_resolve_precision``).  ``attention_impl`` and ``remat`` reach the
sequence models (BERT, GPT) as in the JAX harness (``_resolve_model``).
The JAX ``ExperimentConfig``'s other fields (schedules, codecs, model
parallelism, checkpoints, telemetry, sampling, serving) are absent.
``parse_draft_config`` reads a serving draft's size, as the JAX
harness's ``--serve-draft-config`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import Any, Callable

import torch

from distributed_tensorflow_tpu_torch import models as modellib
from distributed_tensorflow_tpu_torch.data import loaders
from distributed_tensorflow_tpu_torch.engines import (
    Trainer, check_engine, create_engine)
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel import precision as precisionlib
from distributed_tensorflow_tpu_torch.utils.supervisor import ResultSink

@dataclasses.dataclass
class ExperimentConfig:
    """What the reference CLI configures (reference initializer.py:72-114),
    plus the knobs this port serves."""

    engine: str = "sync"            # sync | allreduce | async | gossip
    model: str = "mlp"
    dataset: str = "mnist"
    model_fn: Callable | None = None       # user plug-in override
    dataset_fn: Callable | None = None
    n_devices: int | None = None    # the reference's -n: ranks, one device
                                    # each (None: the process group's size,
                                    # or 1 without one)
    batch_size: int = 32            # per-worker (-b): global batch = b × n
    epochs: int = 1
    learning_rate: float = 1e-3
    grad_accum: int = 1             # microbatches per optimizer step
    sync_every: int = 10            # async: parameter-averaging period
    degree: int = 1                 # gossip: ring neighbours on each side
    seed: int = 0
    precision: str = "f32"          # f32 | bf16 | bf16-f32master |
                                    # fp16-f32master (parallel/precision.py)
    dtype: str = "float32"          # model compute dtype; a non-f32
                                    # precision sets it (_resolve_precision)
    log_every: int = 50
    steps_per_call: int | None = None  # drain chunk (None: auto, 8)
    prefetch: int = 2               # batches staged on the device ahead
    eval_batch: int = 100           # the reference's test batch
    result_path: str | None = None  # JSONL event sink
    supervisor_address: str | None = None  # the reference's port-4000 channel
    attention_impl: str = "ring"    # ring | ring_flash | ulysses |
                                    # ulysses_flash | flash: on the data-
                                    # parallel path the *flash values give
                                    # a sequence model the flash kernels,
                                    # the others leave it dense
    remat: bool = False             # activation checkpointing: store block
                                    # inputs only, recompute in backward
                                    # (sequence models)
    model_args: dict | None = None  # extra model constructor fields
    device: str | None = None       # None: the CUDA card; 'cpu' for tests


_SEQUENCE_MODELS = ("bert_tiny", "bert", "gpt", "gpt_tiny")


@dataclasses.dataclass
class _Experiment:
    """Resolved experiment: mesh, data, model, engine, global batch."""

    mesh: Any
    n: int
    train_ds: Any
    test_ds: Any
    engine: Any
    global_batch: int
    name: str


def _resolve_model(config: ExperimentConfig, num_classes: int, device):
    """Plug-in ``model_fn`` wins (and owns its dtype: a non-f32 ``dtype``
    is ignored, with a warning, as in JAX ``harness.py:820-828``); else
    the registry with ``model_args`` and the config's ``dtype`` (JAX
    ``harness.py:826-855``): ``remat``
    reaches a sequence model and is rejected for any other; ``flash``,
    ``ring_flash`` and ``ulysses_flash`` give a sequence model the flash
    kernels (without a sequence mesh the ring schedule around them is a
    no-op), while ``ring`` (the flag's default) and ``ulysses`` leave it
    dense, as they need the sequence mesh this path does not build."""
    if config.model_fn is not None:
        if modellib.resolve_dtype(config.dtype) is not torch.float32:
            warnings.warn(
                f"--dtype {config.dtype} is ignored for plug-in model_fn "
                f"models; the model_fn owns its dtype", stacklevel=2)
        return config.model_fn()
    kw = dict(config.model_args or {})
    forced = {}
    if config.remat:
        if config.model not in _SEQUENCE_MODELS:
            raise ValueError(
                f"--remat checkpoints transformer blocks; --model "
                f"{config.model} has none (sequence models: "
                f"{'/'.join(_SEQUENCE_MODELS)})")
        forced["remat"] = True
    bad = sorted(set(kw) & {"num_classes", "device", "dtype", *forced})
    if bad:
        raise ValueError(f"--model-arg {bad} is set by the harness for "
                         f"--model {config.model}")
    kw.update(forced)
    if config.model in _SEQUENCE_MODELS and config.attention_impl in (
            "flash", "ring_flash", "ulysses_flash"):
        kw["attention_impl"] = "flash"
    return modellib.create_model(config.model, num_classes=num_classes,
                                 device=device, dtype=config.dtype, **kw)


def _resolve_precision(config: ExperimentConfig) -> ExperimentConfig:
    """Validate ``precision`` and resolve the model dtype it implies (JAX
    ``harness.py:561-597``): under a non-f32 policy the model computes in
    the policy's compute dtype; ``dtype`` left at float32 follows it, a
    matching one is fine, and a conflicting one is rejected (f32 compute
    over 16-bit parameters would widen every weight again).  ``f32``
    leaves ``dtype`` as it is."""
    pol = precisionlib.make_policy(config.precision)  # typo: full menu
    if not pol.active:
        return config
    compute = pol.compute_dtype
    asked = modellib.resolve_dtype(config.dtype)
    if asked is not torch.float32 and asked is not compute:
        raise ValueError(
            f"--dtype {config.dtype} conflicts with --precision "
            f"{pol.name} (compute dtype {str(compute).split('.')[-1]}): a "
            f"non-f32 policy owns the model dtype — drop --dtype or make "
            f"them agree")
    return dataclasses.replace(config, dtype=str(compute).split(".")[-1])


def _load_data(config: ExperimentConfig):
    """(train, test) datasets.  Every rank loads the whole train split and
    keeps its rows of each global batch (``Engine.shard_batch``), so the
    batches are the JAX package's; a user ``dataset_fn`` may return a
    ``Dataset.process_shard_of`` shard instead."""
    if config.dataset_fn is not None:
        return (config.dataset_fn(config.batch_size, type="train"),
                config.dataset_fn(config.eval_batch, type="test"))
    return (loaders.load_dataset(config.dataset, split="train"),
            loaders.load_dataset(config.dataset, split="test"))


def _global_batch(config: ExperimentConfig, dp: int) -> int:
    return max(config.batch_size * dp, dp)


def _setup(config: ExperimentConfig) -> _Experiment:
    check_engine(config.engine)
    config = _resolve_precision(config)
    mesh = meshlib.create_mesh(config.n_devices, device=config.device)
    try:
        n = mesh.world_size
        train_ds, test_ds = _load_data(config)
        model = _resolve_model(config, train_ds.num_classes, mesh.device)
        # reference -b is the PER-WORKER batch: global batch = b × n
        global_batch = _global_batch(config, n)
        engine_kw: dict[str, Any] = dict(
            mesh=mesh, learning_rate=config.learning_rate,
            precision=config.precision)
        if config.engine == "async":
            engine_kw["sync_every"] = config.sync_every
        elif config.engine == "gossip":
            engine_kw["degree"] = config.degree
        if config.grad_accum > 1:
            if config.engine not in ("sync", "allreduce"):
                raise ValueError(
                    f"grad_accum is implemented by the sync/allreduce/fsdp "
                    f"engines (got engine='{config.engine}')")
            if (global_batch // n) % config.grad_accum:
                raise ValueError(
                    f"per-device batch {global_batch // n} not divisible by "
                    f"grad_accum {config.grad_accum}")
        if config.engine in ("sync", "allreduce"):
            engine_kw["grad_accum"] = config.grad_accum
        engine = create_engine(config.engine, model, **engine_kw)
    except BaseException:
        mesh.close()
        raise
    return _Experiment(mesh=mesh, n=n, train_ds=train_ds, test_ds=test_ds,
                       engine=engine, global_batch=global_batch,
                       name=config.engine)


def _quiet(_line: str) -> None:
    pass


@contextlib.contextmanager
def _repeatable_math():
    """For the run: TF32 off for matmuls and convolutions (full f32), and
    cuDNN on deterministic algorithms with its autotuner off (the default
    heuristics may pick weight-gradient algorithms that sum with atomics,
    in another order each run).  All four flags are restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved


@_repeatable_math()
def run(config: ExperimentConfig) -> dict[str, Any]:
    """Run one experiment on this rank; returns the summary dict.  Rank 0
    alone logs heartbeats, writes ``result_path`` and reports the
    start/done/results triple to the supervisor; every rank returns the
    same summary (its numbers are all-reduced)."""
    ex = _setup(config)
    try:
        rank0 = ex.mesh.rank == 0
        sink = ResultSink(
            config.result_path if rank0 else None,
            supervisor_address=config.supervisor_address if rank0 else None)
        try:
            trainer = Trainer(None, engine=ex.engine, seed=config.seed)
            sink.start()
            fit = trainer.fit(ex.train_ds, epochs=config.epochs,
                              batch_size=ex.global_batch,
                              log_every=config.log_every,
                              log_fn=print if rank0 else _quiet,
                              steps_per_call=config.steps_per_call,
                              prefetch=config.prefetch)
            sink.done(fit["elapsed"])
            ev = trainer.evaluate(ex.test_ds, batch_size=config.eval_batch)
            sink.results(ev["accuracy"], loss=ev["loss"])
            model_name = config.model if config.model_fn is None else getattr(
                config.model_fn, "__name__", "custom_model_fn")
            st = fit["step_time"]
            summary = {
                "engine": ex.name,
                "model": model_name,
                "dataset": ex.train_ds.name,
                "synthetic_data": ex.train_ds.synthetic,
                "n_devices": ex.n,
                "data_parallel": ex.n,
                "global_batch": ex.global_batch,
                "epochs": config.epochs,
                "precision": fit["precision"],
                "steps": fit["steps"],
                "steps_per_call": fit["steps_per_call"],
                "prefetch_depth": fit["prefetch_depth"],
                "elapsed_s": fit["elapsed"],
                "examples_per_sec": fit["examples_per_sec"],
                "examples_per_sec_per_device": fit["examples_per_sec"] / ex.n,
                "test_accuracy": ev["accuracy"],
                "test_loss": ev["loss"],
                # the JAX run report's keys that this fit measures
                "run_report": {
                    "steps": fit["steps"], "elapsed_s": fit["elapsed"],
                    "steps_per_call": fit["steps_per_call"],
                    "steps_per_call_clamp": fit.get("steps_per_call_clamp"),
                    "chunk_sizes": fit["chunk_sizes"],
                    "prefetch_depth": fit["prefetch_depth"],
                    "compile_s": st.get("compile_s"),
                    "step_time_p50_s": st.get("steady_p50_s"),
                    "step_time_p95_s": st.get("steady_p95_s"),
                    "step_time_mean_s": st.get("steady_mean_s"),
                    "precision": fit["precision"],
                    "param_bytes_per_device": fit["param_bytes_per_device"],
                    "opt_state_bytes_per_device":
                        fit["opt_state_bytes_per_device"],
                    "loss_scale": fit.get("loss_scale"),
                },
            }
            sink.emit("summary", **summary)
            return summary
        finally:
            sink.close()
    finally:
        ex.mesh.close()


@_repeatable_math()
def steps_to_accuracy(config: ExperimentConfig, target: float,
                      max_steps: int = 10_000,
                      eval_every: int = 50) -> dict[str, Any]:
    """Steps-to-target (the north star: steps-to-97%), counted in GLOBAL
    batches, through ``Trainer.fit`` with its adaptive eval cadence (every
    ``eval_every`` steps far from the target, every ≤ 10 within 0.05 of
    it)."""
    ex = _setup(config)
    try:
        trainer = Trainer(None, engine=ex.engine, seed=config.seed)
        steps_per_epoch = max(len(ex.train_ds) // ex.global_batch, 1)
        epochs = math.ceil(max_steps / steps_per_epoch) + 1
        t0 = time.perf_counter()
        fit = trainer.fit(
            ex.train_ds, epochs=epochs, batch_size=ex.global_batch,
            log_every=0, max_steps=max_steps, eval_ds=ex.test_ds,
            target_accuracy=target, eval_every=eval_every,
            eval_batch=config.eval_batch,
            steps_per_call=config.steps_per_call, prefetch=config.prefetch)
        return {
            "reached": bool(fit["reached_target"]),
            "steps": fit["steps"],
            "accuracy": fit["eval_accuracy"],
            "elapsed_s": time.perf_counter() - t0,
            # the gap between the crossing eval and the one before it
            "step_resolution": fit["eval_resolution"],
            "synthetic": bool(getattr(ex.train_ds, "synthetic", False)),
        }
    finally:
        ex.mesh.close()


def parse_draft_config(spec: str) -> dict[str, int] | None:
    """A speculative draft's size (JAX ``parse_draft_config``): the
    literal ``'self'`` → None (the draft is the served model with its
    weights, accept rate 1), or ``'key=int,...'`` GPT size overrides of
    hidden/layers/heads/ffn/kv_heads.  Vocabulary and max_len always come
    from the served model: proposals must be target tokens, and the draft
    mirrors every slot position."""
    if spec == "self":
        return None
    allowed = ("ffn", "heads", "hidden", "kv_heads", "layers")
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key = key.strip()
        if not eq or key not in allowed:
            raise ValueError(
                f"--serve-draft-config entries must be key=int with key "
                f"in {allowed} (or the literal 'self'); got '{part}' — "
                f"vocab/max_len inherit from the served model")
        try:
            out[key] = int(val)
        except ValueError:
            raise ValueError(
                f"--serve-draft-config value for '{key}' must be an "
                f"int, got '{val.strip()}'") from None
    if not out:
        raise ValueError(
            "--serve-draft-config needs at least one key=int override "
            "(or the literal 'self')")
    return out
