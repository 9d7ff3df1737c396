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
(``_resolve_precision``).  ``seq_parallel`` S > 1 shards the sequence
over S of the ranks (``_setup_seq_parallel``): a (data, seq) mesh of
(n / S, S) ranks, a sequence model with ring or Ulysses attention and
``SeqParallelEngine``, named ``seq_parallel[<attention>]``.
``attention_impl`` and ``remat`` reach the
sequence models (BERT, GPT) as in the JAX harness (``_resolve_model``),
and ``positional``/``kv_heads`` the GPT (``_lm_model_kw``).

The optimizer recipe is the JAX harness's (``make_lr_schedule``,
``_make_optimizer``, ``_decay_mask``): a constant, cosine or linear
learning-rate schedule with a linear warmup, AdamW's decoupled weight
decay on the matmul kernels only, and global-norm clipping before Adam,
as ``utils/optim.ScheduledAdamW``, whose schedule, clip and mask run on
the device (a chunk replayed as a CUDA graph reads the schedule at every
step).  With none of them set the engine keeps its stock Adam.

After training an LM, ``sample_tokens`` greedy-decodes continuations of
test prompts (``_sample_from_state``) and ``serve_requests`` runs a
continuous-batching window over the trained module
(``_serve_from_state``: ``SlotKVCache`` + ``ContinuousBatcher`` under an
``SLOMonitor``); every argument of either that can fail is checked before
training (``_validate_sampling``, ``_validate_serving``).  The summary of
an LM gains ``test_perplexity``.

``expert_parallel`` E > 1 shards the experts of the MoE classifier over
E of the ranks (``_setup_expert_parallel``): a (data, expert) mesh of
(n / E, E) ranks and ``ExpertParallelEngine``, named ``expert_parallel``,
with ``num_experts``, ``aux_weight``, ``router_top_k`` and
``router_z_weight``; its summary carries the overflow monitor's report.

Two or three of ``tensor_parallel``, ``seq_parallel`` and
``expert_parallel`` above 1 make a composite (``_COMBOS``, JAX
``harness.py:637-672``, with JAX's mesh orders and names): tp×sp a
(data, model, seq) mesh and ``CompositeEngine`` over the partitioned
sequence model (``composite[dp*tp*sp,<attention>]``); ep×tp a (data,
expert, model) mesh and ``ExpertParallelEngine`` over the classifier's
2-D expert layout (``expert_tp[dp*ep*tp]``); ep×sp a (data, expert,
seq) mesh and ``CompositeEngine`` over a MoE GPT or BERT
(``expert_sp[dp*ep*sp,<attention>]``), and with tp a (data, expert, seq,
model) one (``expert_tp_sp[dp*ep*tp*sp,<attention>]``).  Sampling after
any of them passes the run's mesh to ``generate`` (TP decode: the batch
over 'data', the Megatron cut over 'model', JAX ``harness.py:2179``);
serving builds a TP table on the run's mesh where its axes are a subset
of {data, model} and the slots divide by 'data' (-tp, fsdp×tp), and
otherwise (tp×sp, ep×tp, ep×tp×sp) serves the whole model replicated
(JAX ``harness.py:2462-2470``).
With the pipeline: pp×tp a (data, pipe, model) mesh and
``PipelineEngine`` over the GPT or BERT stages with the Megatron layout
(``pipeline_tp[dp*pp*tp,<schedule>]``); pp×sp a (data, pipe, seq) mesh
and GPT stages with ring or Ulysses attention over 'seq'
(``pipeline_sp[dp*pp*sp,<attention>]``), and with tp a (data, pipe, seq,
model) one (``pipeline_tp_sp[dp*pp*tp*sp,<attention>]``); pp×ep a
(data, pipe, expert[, model][, seq]) mesh and GPT (or, without 'seq',
BERT) stages whose blocks carry the routed MoE FFN with its experts cut
over 'expert' (``pipeline_ep[dp*pp*ep,<schedule>]``,
``pipeline_ep_tp[dp*pp*ep*tp]``, ``pipeline_ep_sp[dp*pp*ep*sp,
<attention>]``, ``pipeline_ep_tp_sp[dp*pp*ep*tp*sp,<attention>]``), whose
summary carries the overflow monitor's report.  ``--sample`` after the
dense ones decodes through ``PipelineEngine.generate`` on the gathered
whole model (not TP decode), and is refused after MoE stages;
``--serve`` after ``-pp`` is refused.

``checkpoint_dir`` writes checkpoints (``utils/checkpoint.py``; async by
default, ``async_checkpoint`` False for the synchronous writer) every
``checkpoint_every`` steps and at the end; ``resume`` restores the latest
one, policy-aware, and ``elastic_restore`` through ``elastic_restore``
with its data state, so the batch stream continues exactly once;
``watchdog_timeout`` arms a stall watchdog (``watchdog_abort``: exit 75
on a stall); ``max_restarts`` > 0 wraps the run in
``failure.run_with_recovery``.  Under ``cli -n N`` with N > 1 the CLI
wraps the spawn of the N ranks instead (a crashed rank leaves its peers
inside a collective, and a process group cannot be re-created inside a
rank after a peer died), and ``run`` refuses ``max_restarts`` inside a
rank of more than one.

``grad_compression`` (none | bf16 | int8) and ``grad_bucket_mb`` reach
every engine the port builds (``parallel/compression.py``,
``parallel/overlap.py``); a misspelt codec and a negative bucket are
refused before setup.  With ``grad_bucket_mb`` > 0 the run measures the
exposed-against-hidden collective split once before training
(``_probe_collective_overlap``; every rank of a group together, as the
probe holds collectives) and reports it as ``fit["collective_overlap"]``
and the run report's ``grad_collective_exposed_s``/``_hidden_s``.  The
overlap comes from the engine's gradient hooks and side stream; JAX's
``enable_overlap_flags`` sets XLA scheduler flags and has no counterpart.

``engine='fsdp'`` (``-m d -ds fsdp``) is ``FSDPEngine`` on the default
path, with ``grad_accum``.  ``tensor_parallel`` T > 1 makes a (data,
model) mesh of (n / T, T) ranks (``_setup_tensor_parallel``, named
``tensor_parallel``; under ``fsdp`` ``_setup_fsdp_tp``, named
``fsdp_tp[fsdp*tp]``) over ``_tp_model``: ``TPMLP`` for the MLP names,
else the sequence model with ``partition_model=True`` and dense
attention.

``pipeline_parallel`` S > 1 makes a (data, pipe) mesh of (n / S, S)
ranks and ``PipelineEngine`` (``_setup_pipeline_parallel``, named
``pipeline_parallel``) with ``microbatches``, ``pipeline_schedule`` and
``remat``, over the built-in MLP stages (``pipeline_hidden`` wide) or the
GPT or BERT stage families (``_pipeline_stages``); ``--sample`` then
decodes through ``PipelineEngine.generate``, and ``--precision``,
``--grad-compression``, ``--grad-bucket-mb``, ``--grad-accum`` and
``--serve`` are refused with JAX's messages.

Every ``run`` has a live tracer (``observability.Tracer``: span
aggregates for the run report, and the JSONL file under ``trace_path``),
a ``StragglerDetector`` on its step times, a ``MetricsLogger`` under
``metrics_path``, a ``Timeline`` under ``timeline`` (sampled by the fit
and the serve window) and a ``torch.profiler`` window around the fit
under ``profile_dir``; its summary's ``run_report`` is
``observability.build_run_report`` (the JAX report's keys), also emitted
as a ``run_report`` event.  A run with ``checkpoint_dir`` arms a
``LeaseManager``: SIGTERM, or ``max_steps_per_lease`` steps, ends the fit
at a chunk boundary with its final checkpoint and the reason in
``preempted``, the supervisor gets ``['preempted', reason, step]``, and a
relaunch with ``elastic_restore`` continues it bitwise; a SIGTERM also
drains the serve window.  JAX runs one process, so one flag stops every
device at one boundary; over the ranks of ``cli -n N`` a signal reaches
them at different moments, so under a signal-armed lease the ranks
agree on the stop at each boundary by one all-reduce (max) of the
signal's number (``_lease_stop``; none at one rank).

``health`` ``'on'`` turns on the engine's health layer before any state
exists (``Engine.enable_health``), and ``on_anomaly`` and ``nan_guard``
reach ``Trainer.fit``; a ``resume`` across a health toggle raises JAX's
message (the capture's step count is a checkpoint entry; the loss EMA
restarts on resume, as JAX's).  ``timeline`` or ``roofline`` arms the
program ledger (``observability.ProgramLedger``: the chunk graphs, the
kernel builds, the serve table's first calls and round graphs), whose
manifest the run report carries; ``roofline`` builds a
``observability.Roofline`` from the card's name, the run's device count
and the engine's cost model for the fit and the report, and another
from the serve table (``Roofline.for_kv``) for the batcher.
``compile_cache`` points the kernel build cache (``ops/_build.py``) at
a directory: the counterpart of XLA's persistent compilation cache.

The fleet's serve fields
(``serve_replicas``, ``serve_fault_spec``, ``serve_watchdog_s``,
``serve_hot_swap``, ``serve_disaggregate``, ``serve_routing``,
``serve_autoscale``) raise ``NotImplementedError`` at any value but their
default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import not_ported
from distributed_tensorflow_tpu_torch import models as modellib
from distributed_tensorflow_tpu_torch.data import loaders
from distributed_tensorflow_tpu_torch.engines import (
    Trainer, check_engine, create_engine)
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel import precision as precisionlib
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    SEQ_PARALLEL)
from distributed_tensorflow_tpu_torch.utils import optim
from distributed_tensorflow_tpu_torch.utils.supervisor import ResultSink


@dataclasses.dataclass
class ExperimentConfig:
    """What the reference CLI configures (reference initializer.py:72-114),
    plus the knobs this port serves."""

    engine: str = "sync"            # sync | allreduce | async | gossip |
                                    # fsdp
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
    lr_schedule: str = "constant"   # constant | cosine | linear (each with
                                    # optional linear warmup); horizon =
                                    # epochs × steps-per-epoch
    warmup_steps: int = 0           # linear LR warmup from 0 over this many
                                    # steps (0 disables)
    schedule_horizon_steps: int | None = None  # decay horizon override
                                    # (steps_to_accuracy sets max_steps)
    weight_decay: float = 0.0       # >0: AdamW decoupled weight decay
    clip_norm: float = 0.0          # >0: clip gradients to this global norm
                                    # before the optimizer update
    grad_accum: int = 1             # microbatches per optimizer step
    grad_compression: str = "none"  # gradient/parameter exchange codec:
                                    # none | bf16 | int8
                                    # (parallel/compression.py)
    grad_bucket_mb: float = 0.0     # >0: bucketed gradient collectives
                                    # reduced as the backward produces
                                    # them (parallel/overlap.py); 0: the
                                    # unbucketed exchange
    compile_cache: str | None = None  # kernel build cache directory
                                    # (ops/_build.py): repeat runs load
                                    # the libraries built there
    sync_every: int = 10            # async: parameter-averaging period
    degree: int = 1                 # gossip: ring neighbours on each side
    seed: int = 0
    precision: str = "f32"          # f32 | bf16 | bf16-f32master |
                                    # fp16-f32master (parallel/precision.py)
    dtype: str = "float32"          # model compute dtype; a non-f32
                                    # precision sets it (_resolve_precision)
    log_every: int = 50
    checkpoint_dir: str | None = None   # checkpoints go here (None: none)
    checkpoint_every: int = 0       # steps between checkpoints (0: final)
    async_checkpoint: bool = True   # background writer (False: sync)
    resume: bool = False            # restore the latest checkpoint first
    elastic_restore: bool = False   # restore through elastic_restore with
                                    # the data state (exactly-once resume)
    watchdog_timeout: float = 0.0   # >0: per-step stall budget (seconds)
    watchdog_abort: bool = False    # on a stall: exit 75 after reporting
    nan_guard: bool = True          # divergence check at log cadence
                                    # (with health on: divergence stays
                                    # fatal unless this is False)
    health: str = "off"             # 'on': per-step health stats on the
                                    # device (observability/health.py)
    on_anomaly: str = "warn"        # health anomaly policy: 'warn' records
                                    # anomaly events, 'halt' raises at the
                                    # offending step
    max_restarts: int = 0           # >0: restart from the latest
                                    # checkpoint on a crash, this many times
    max_steps_per_lease: int = 0    # >0: graceful lease drain after this
                                    # many steps (elastic/lease.py); every
                                    # checkpointed run also drains on
                                    # SIGTERM
    metrics_path: str | None = None  # per-step metrics JSONL (async sink)
    trace_path: str | None = None   # structured span/event JSONL
                                    # (observability/trace.py)
    timeline: bool = False          # gauge sampler: chunk step time,
                                    # prefetch depth, the serve window's
                                    # queue/slot/KV gauges
    timeline_interval: float = 0.05  # min seconds between samples per
                                    # gauge group (0: every boundary)
    roofline: bool = False          # analytic FLOPs/bytes, the H100's
                                    # peaks: train_mfu, serve MFU/MBU and
                                    # the report's roofline section; arms
                                    # the program ledger
    profile_dir: str | None = None  # torch.profiler Chrome trace output
    steps_per_call: int | None = None  # drain chunk (None: auto, 8)
    prefetch: int = 2               # batches staged on the device ahead
    eval_batch: int = 100           # the reference's test batch
    result_path: str | None = None  # JSONL event sink
    supervisor_address: str | None = None  # the reference's port-4000 channel
    seq_parallel: int = 1           # >1: shard sequences over this many
                                    # of the ranks (a 'seq' mesh axis)
    tensor_parallel: int = 1        # >1: Megatron-shard the model over this
                                    # many of the ranks (a 'model' axis;
                                    # fsdp × tp under engine 'fsdp')
    pipeline_parallel: int = 1      # >1: one stage per rank over this
                                    # many of the ranks (a 'pipe' axis)
    microbatches: int = 4           # pipeline microbatches per step
    pipeline_schedule: str = "gpipe"  # gpipe | 1f1b (bounded stash)
    pipeline_hidden: int = 128      # the MLP and sequence stages' width
    expert_parallel: int = 1        # >1: shard MoE experts over this many
                                    # of the ranks (an 'expert' mesh axis)
    num_experts: int = 8            # MoE expert count
    aux_weight: float = 0.01        # MoE load-balance loss weight
    router_top_k: int = 1           # MoE routing: 1 (Switch) | 2 (GShard)
    router_z_weight: float = 0.0    # MoE router z-loss weight
    attention_impl: str = "ring"    # ring | ring_flash | ulysses |
                                    # ulysses_flash (the schedules over
                                    # 'seq' when seq_parallel > 1) | flash:
                                    # on the data-parallel path the *flash
                                    # values give a sequence model the
                                    # flash kernels, the others leave it
                                    # dense
    remat: bool = False             # activation checkpointing: store block
                                    # inputs only, recompute in backward
                                    # (sequence models)
    positional: str = "learned"     # GPT positions: learned | rope
    kv_heads: int | None = None     # GPT GQA: K/V heads < query heads
    model_args: dict | None = None  # extra model constructor fields
    device: str | None = None       # None: the CUDA card; 'cpu' for tests
    sample_tokens: int = 0          # >0: after training an LM, greedy-decode
                                    # this many tokens per prompt
    sample_prompt_len: int = 8      # prompt tokens per sampled test row
    serve_requests: int = 0         # >0: after training an LM, serve this
                                    # many requests (continuous batching)
    serve_slots: int = 4            # KV slot table size
    serve_max_new: int = 16         # tokens generated per request
    serve_prompt_len: int = 8       # prompt tokens per request (test rows)
    serve_kv_dtype: str | None = None  # KV storage: float32 | bfloat16 |
                                    # int8 (None: the model's dtype)
    serve_prefill_chunk: int = 0    # >0: chunked prefill token budget
    serve_prefix_cache: int = 0     # >0: prefix-pool capacity in blocks
    serve_prefix_block: int = 16    # tokens per prefix-pool block
    serve_shared_prefix: int = 0    # >0: a seeded N-token system prompt
                                    # prepended to every request
    serve_slo_ttft: float = 2.0     # TTFT SLO target (seconds)
    serve_slo_itl: float = 0.5      # ITL SLO target (seconds, per-request
                                    # p99 gap)
    serve_queue_cap: int = 0        # >0: bounded admission (sheds excess)
    serve_draft_config: str | None = None  # speculative draft: 'self' or
                                    # 'key=int,...' GPT size overrides
    serve_draft_k: int = 4          # draft tokens proposed per verify
    serve_replicas: int = 1         # fleet (not ported)
    serve_fault_spec: str | None = None    # fleet (not ported)
    serve_watchdog_s: float = 0.0   # fleet (not ported)
    serve_hot_swap: bool = False    # fleet (not ported)
    serve_kv_layout: str = "monolithic"    # monolithic | paged
    serve_paged_block: int = 0      # paged block tokens (0: prefix block)
    serve_paged_blocks: int = 0     # paged pool capacity (0: auto-size)
    serve_disaggregate: str | None = None  # fleet (not ported)
    serve_routing: str = "least-loaded"    # fleet (not ported)
    serve_autoscale: str | None = None     # fleet (not ported)
    serve_multi_step: int | None = None    # k: fused k-step decode rounds


_SEQUENCE_MODELS = ("bert_tiny", "bert", "gpt", "gpt_tiny")
_LM_MODELS = ("gpt", "gpt_tiny")  # causal LMs: (B, L) next-token targets
# the fleet's serve fields (ROADMAP Queue 1: fleet) and their defaults
_FLEET_DEFAULTS = {"serve_replicas": 1, "serve_fault_spec": None,
                   "serve_watchdog_s": 0.0, "serve_hot_swap": False,
                   "serve_disaggregate": None,
                   "serve_routing": "least-loaded", "serve_autoscale": None}


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


def _lm_model_kw(config: ExperimentConfig) -> dict[str, Any]:
    """GPT-only model kwargs (``positional``/``kv_heads``), passed only
    when not the default, so that the other models never see them."""
    kw: dict[str, Any] = {}
    if config.model in _LM_MODELS:
        if config.positional != "learned":
            kw["positional"] = config.positional
        if config.kv_heads is not None:
            kw["kv_heads"] = config.kv_heads
    return kw


def _resolve_model(config: ExperimentConfig, num_classes: int, device,
                   attention_impl: str | None = None):
    """Plug-in ``model_fn`` wins (and owns its dtype: a non-f32 ``dtype``
    is ignored, with a warning, as in JAX ``harness.py:820-828``); else
    the registry with ``model_args``, the config's ``dtype`` and the GPT's
    ``_lm_model_kw`` (JAX ``harness.py:826-855``): ``remat``
    reaches a sequence model and is rejected for any other.  On this
    data-parallel path (``seq_parallel`` 1) ``flash``, ``ring_flash`` and
    ``ulysses_flash`` give a sequence model the flash kernels (without a
    sequence axis the schedule around them is a no-op), while ``ring``
    (the flag's default) and ``ulysses`` leave it dense; with
    ``seq_parallel`` > 1 ``ring`` and ``ulysses`` (and their flash twins)
    get the (data, seq) mesh, through ``_setup_seq_parallel``.
    ``attention_impl``, when given, is the model's as it is."""
    if config.model_fn is not None:
        if modellib.resolve_dtype(config.dtype) is not torch.float32:
            warnings.warn(
                f"--dtype {config.dtype} is ignored for plug-in model_fn "
                f"models; the model_fn owns its dtype", stacklevel=2)
        return config.model_fn()
    kw = dict(config.model_args or {})
    forced = _lm_model_kw(config)
    if config.remat:
        if config.model not in _SEQUENCE_MODELS:
            raise ValueError(
                f"--remat checkpoints transformer blocks; --model "
                f"{config.model} has none (sequence models: "
                f"{'/'.join(_SEQUENCE_MODELS)})")
        forced["remat"] = True
    if config.model in ("moe", "moe_mlp"):
        # router_top_k is a model knob: it applies under any engine (a
        # -ep 1 run still routes); router_z_weight is the expert-parallel
        # engine's (checked in _setup)
        forced["router_top_k"] = config.router_top_k
    bad = sorted(set(kw) & {"num_classes", "device", "dtype", *forced})
    if bad:
        raise ValueError(f"--model-arg {bad} is set by the harness for "
                         f"--model {config.model}")
    kw.update(forced)
    if attention_impl is not None:
        kw["attention_impl"] = attention_impl
    elif kw.get("attention_impl") in SEQ_PARALLEL:
        raise ValueError(
            f"--model-arg attention_impl={kw['attention_impl']} shards the "
            f"sequence over a 'seq' mesh axis, which a data-parallel run "
            f"does not build: pass -sp > 1 with --attention "
            f"{kw['attention_impl']}")
    elif config.model in _SEQUENCE_MODELS and config.attention_impl in (
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
    leaves ``dtype`` as it is.  The pipeline (``pipeline_parallel`` > 1)
    runs f32 only (JAX ``harness.py:581-586``)."""
    pol = precisionlib.make_policy(config.precision)  # typo: full menu
    if not pol.active:
        return config
    if config.pipeline_parallel > 1:
        raise ValueError(
            "--precision is implemented for the data-parallel and GSPMD "
            "engines (sync/async/allreduce/gossip/fsdp, -tp, -sp, -ep and "
            "their composites); the pipeline schedules (-pp) are not "
            "supported — drop the flag or train without -pp")
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


def make_lr_schedule(config: ExperimentConfig, total_steps: int):
    """Learning-rate schedule from ``lr_schedule``/``warmup_steps`` (JAX
    ``make_lr_schedule``), or None for the default (constant, no warmup):
    a function of the optimizer's count, a float32 tensor, whose first
    update reads count 0.  The decay horizon is ``total_steps``; warmup
    ramps linearly from 0 and the decay joins at ``warmup_steps``."""
    lr, warm = config.learning_rate, max(config.warmup_steps, 0)
    if config.lr_schedule not in ("constant", "cosine", "linear"):
        raise ValueError(
            f"unknown lr_schedule '{config.lr_schedule}'; "
            f"known: constant, cosine, linear")
    if config.lr_schedule == "constant" and warm == 0:
        return None
    total = max(total_steps, warm + 1)
    decay = max(total - warm, 1)
    if config.lr_schedule == "cosine":
        return optim.warmup_cosine_decay_schedule(
            init_value=0.0 if warm else lr, peak_value=lr,
            warmup_steps=warm, decay_steps=total)
    if config.lr_schedule == "linear":
        main = optim.linear_schedule(lr, 0.0, decay)
    else:  # constant after warmup
        main = optim.constant_schedule(lr)
    if warm == 0:
        return main
    return optim.join_schedules(
        [optim.linear_schedule(0.0, lr, warm), main], [warm])


def _make_optimizer(config: ExperimentConfig, train_ds, global_batch: int,
                    model: torch.nn.Module):
    """The recipe's optimizer factory (``params -> ScheduledAdamW``) over
    the run's schedule, or None: the engine's stock Adam (JAX
    ``_make_optimizer``, which returns an optax chain).  ``model`` gives
    the decay mask.  The factory serves both layouts an engine builds the
    optimizer over: the model's parameters themselves, or a master
    policy's one flat f32 master (``MasterWeights``), whose mask is the
    parameters' masks laid end to end in the same order.  ``model`` may
    be a callable returning the model (an engine that builds its module
    itself: the pipeline).

    The horizon counts global steps: ``epochs × (len(train) //
    global_batch)``, every rank loading the whole train split (a
    process-sharded dataset scales by its process count, as in JAX)."""
    if config.schedule_horizon_steps is not None:
        total = config.schedule_horizon_steps
    else:
        shard = getattr(train_ds, "process_shard", None)
        n_global = len(train_ds) * (shard[1] if shard else 1)
        total = config.epochs * max(n_global // max(global_batch, 1), 1)
    sched = make_lr_schedule(config, total)
    if sched is None and not config.weight_decay and not config.clip_norm:
        return None
    lr = sched if sched is not None else config.learning_rate
    wd, clip = config.weight_decay, config.clip_norm

    def factory(params):
        params = list(params)
        mod = model if isinstance(model, torch.nn.Module) else model()
        named = list(mod.named_parameters())
        keep = _decay_mask(mod)
        if (len(params) == len(named)
                and all(p is q for p, (_, q) in zip(params, named))):
            mask = [keep[name] for name, _ in named]
        elif (len(params) == 1
              and params[0].numel() == sum(q.numel() for _, q in named)):
            flat = params[0]
            mask = [torch.cat([
                torch.full((q.numel(),), float(keep[name]),
                           dtype=flat.dtype, device=flat.device)
                for name, q in named])]
        else:
            raise ValueError(
                "the recipe's optimizer is built over the model's "
                "parameters or over one flat master of them")
        return optim.ScheduledAdamW(params, lr, weight_decay=wd,
                                    decay_mask=mask, clip_norm=clip)

    return factory


def _decay_mask(model: torch.nn.Module) -> dict[str, bool]:
    """The standard transformer decay mask (JAX ``_decay_mask``), by
    parameter name: weight-decay matmul kernels only.  Biases and
    LayerNorm/GroupNorm scales (ndim < 2) and embedding tables (the
    ``nn.Embedding`` weights, which flax names ``embedding``; the tied
    head shares the token table) are left out.  The rank is the leaf's
    in JAX's tree: a pipeline stage's block leaf (``stacked_params``) is
    one slice of a leaf stacked over the stages, one rank more, so its
    biases and LayerNorm scales, ``(S, d)`` in JAX, are decayed there and
    here (ROADMAP Queue 3)."""
    from distributed_tensorflow_tpu_torch.models.layers import (
        VocabParallelEmbedding)

    tables = {id(m.weight) for m in model.modules()
              if isinstance(m, (torch.nn.Embedding, VocabParallelEmbedding))}
    stacked = getattr(model, "stacked_params", ())
    return {name: p.ndim + (name in stacked) >= 2 and id(p) not in tables
            for name, p in model.named_parameters()}


def _reject_flash_under_sp(config: ExperimentConfig) -> None:
    """The sequence-sharded modes take ring / ring_flash / ulysses /
    ulysses_flash; 'flash' is the single-device kernel (JAX
    ``harness.py:518-527``)."""
    if config.attention_impl == "flash":
        raise ValueError(
            "--attention flash is the single-device Pallas kernel; with "
            "--seq-parallel use ring, ring_flash, ulysses or ulysses_flash")


def _split_mesh(config: ExperimentConfig, factor: int, factor_name: str,
                second_axis: str, *more: tuple[int, str],
                engines: tuple[str, ...] = ("sync", "allreduce"),
                grad_accum_ok: bool = False):
    """The (data, <second_axis>, ...) mesh over this run's ranks: the
    named factors take their axes, in order, and the remaining ranks
    shard data (JAX ``_split_mesh``, with its messages).  ``engines``
    names the engine semantics the mode supports (fsdp × tp passes
    ('fsdp',)); ``grad_accum_ok`` marks the modes whose engine
    accumulates microbatches.  Returns (mesh, data size)."""
    if config.engine not in engines:
        why = ""
        if config.engine == "fsdp" and "pipeline" in factor_name:
            why = (" (fsdp × pipeline is rejected by design: the pipeline "
                   "schedules own params per 'pipe' stage inside a manual "
                   "shard_map axis, so ZeRO's gather-per-use collectives "
                   "cannot cross it; shard the optimizer inside each stage "
                   "with --engine sync + --grad-accum instead)")
        raise ValueError(
            f"{factor_name} supports {'/'.join(engines)} semantics only, "
            f"got engine='{config.engine}'{why}")
    if config.grad_accum > 1 and not grad_accum_ok:
        raise ValueError(
            f"grad_accum composes with sync/allreduce/fsdp, tensor_parallel, "
            f"fsdp×tp, seq_parallel, expert_parallel, and the tp×sp / ep×sp "
            f"/ ep×tp×sp composites, not with {factor_name}: the pipeline "
            f"schedules already microbatch — size their chunks with "
            f"--microbatches")
    factors = [(factor, second_axis), *more]
    total = config.n_devices or (torch.distributed.get_world_size()
                                 if torch.distributed.is_initialized()
                                 else 1)
    prod = math.prod(f for f, _ in factors)
    if total % prod != 0:
        raise ValueError(
            f"n_devices {total} not divisible by {factor_name} {prod}")
    dp = total // prod
    mesh = meshlib.create_mesh(
        total, device=config.device, shape=(dp, *[f for f, _ in factors]),
        axis_names=(meshlib.DATA_AXIS, *[a for _, a in factors]))
    return mesh, dp


def _require_token_data(train_ds, config: ExperimentConfig,
                        mode: str) -> None:
    if not np.issubdtype(train_ds.x.dtype, np.integer):
        hint = "lm_synth" if config.model in _LM_MODELS else "glue_synth"
        raise ValueError(
            f"{mode} with a sequence model needs a token dataset (integer "
            f"ids), got --dataset {config.dataset} with dtype "
            f"{train_ds.x.dtype}; use --dataset {hint}")
    if config.model in _LM_MODELS and train_ds.y.ndim < 2:
        raise ValueError(
            f"--model {config.model} is a causal LM and needs per-token "
            f"(B, L) targets, got labels of shape {train_ds.y.shape} from "
            f"--dataset {config.dataset}; use --dataset lm_synth")


def _sequence_model(config: ExperimentConfig, train_ds, mode: str, device,
                    attention_impl: str, partition_model: bool = False,
                    **extra):
    """A sequence model for a model-parallel mode (JAX
    ``_sequence_model``): a plug-in ``model_fn`` as it is; a registered
    sequence model (token data required) with the mode's attention (and
    the Megatron layout with ``partition_model``, the mode's MoE blocks
    with ``extra``: ``moe_experts``, ``moe_top_k``,
    ``partition_experts``); any other model is an error."""
    if config.model_fn is not None:
        return _resolve_model(config, train_ds.num_classes, device)
    if config.model not in _SEQUENCE_MODELS:
        raise ValueError(
            f"{mode} needs a sequence model "
            f"({'/'.join(_SEQUENCE_MODELS)}), got --model {config.model}; "
            f"pass model_fn for a custom model")
    _require_token_data(train_ds, config, mode)
    reserved = ({"attention_impl", *extra}
                | ({"partition_model"} if partition_model else set()))
    bad = sorted(reserved & set(config.model_args or {}))
    if bad:
        raise ValueError(f"--model-arg {bad} is set by the harness for "
                         f"{mode}")
    if partition_model or extra:
        config = dataclasses.replace(config, model_args={
            **(config.model_args or {}), **extra,
            **({"partition_model": True} if partition_model else {})})
    return _resolve_model(config, train_ds.num_classes, device,
                          attention_impl=attention_impl)


def _setup_seq_parallel(config: ExperimentConfig) -> _Experiment:
    """Long-context mode (JAX ``harness.py:960-990``): a (data, seq) mesh
    of (n / seq_parallel, seq_parallel) ranks, a sequence model with the
    configured ring or Ulysses attention, and ``SeqParallelEngine``.
    ``n_devices`` is still the reference's -n: the ranks in all."""
    from distributed_tensorflow_tpu_torch.engines.seq_parallel import (
        SeqParallelEngine)

    _reject_flash_under_sp(config)
    mesh, dp = _split_mesh(config, config.seq_parallel, "seq_parallel",
                           meshlib.SEQ_AXIS, grad_accum_ok=True)
    try:
        train_ds, test_ds = _load_data(config)
        model = _sequence_model(config, train_ds, "seq_parallel",
                                mesh.device, config.attention_impl)
        global_batch = _global_batch(config, dp)
        if config.grad_accum > 1 and (global_batch // dp) % config.grad_accum:
            raise ValueError(
                f"seq_parallel: per-data-shard batch {global_batch // dp} "
                f"not divisible by grad_accum {config.grad_accum}")
        engine = SeqParallelEngine(
            model, mesh=mesh, learning_rate=config.learning_rate,
            optimizer=_make_optimizer(config, train_ds, global_batch,
                                      model),
            grad_accum=config.grad_accum, precision=config.precision,
            **_codec_kw(config))
    except BaseException:
        mesh.close()
        raise
    return _Experiment(mesh=mesh, n=dp, train_ds=train_ds, test_ds=test_ds,
                       engine=engine, global_batch=global_batch,
                       name=f"seq_parallel[{config.attention_impl}]")


def _tp_model(config: ExperimentConfig, train_ds, mode: str, device):
    """The model of the (data, model)-mesh modes (JAX ``_tp_model``): the
    Megatron MLP (``TPMLP``) for the reference's default model names, or
    a partitioned sequence model with dense attention."""
    from distributed_tensorflow_tpu_torch.engines.tensor_parallel import (
        TPMLP)

    if config.model_fn is None and config.model in ("mlp", "tp_mlp",
                                                    "mnist_mlp"):
        return TPMLP(num_classes=train_ds.num_classes,
                     dtype=modellib.resolve_dtype(config.dtype),
                     device=device)
    return _sequence_model(config, train_ds, mode, device, "dense",
                           partition_model=True)


def _check_accum_divides(config: ExperimentConfig, global_batch: int,
                         mode: str) -> None:
    if config.grad_accum > 1 and global_batch % config.grad_accum:
        raise ValueError(
            f"{mode}: global batch {global_batch} not divisible by "
            f"grad_accum {config.grad_accum}")


def _setup_model_parallel(config: ExperimentConfig, mode: str,
                          engines: tuple[str, ...], name: str
                          ) -> _Experiment:
    """Megatron TP (JAX ``_setup_tensor_parallel``) or fsdp × tp (JAX
    ``_setup_fsdp_tp``): a (data, model) mesh of (n / tp, tp) ranks, the
    ``_tp_model`` and ``TensorParallelEngine`` or ``FSDPEngine``.
    Sampling and serving after training decode the partitioned model (TP
    decode)."""
    from distributed_tensorflow_tpu_torch.engines import (
        FSDPEngine, TensorParallelEngine)

    mesh, dp = _split_mesh(config, config.tensor_parallel, mode,
                           meshlib.MODEL_AXIS, engines=engines,
                           grad_accum_ok=True)
    try:
        train_ds, test_ds = _load_data(config)
        model = _tp_model(config, train_ds, mode, mesh.device)
        global_batch = _global_batch(config, dp)
        _check_accum_divides(config, global_batch, mode)
        cls = FSDPEngine if engines == ("fsdp",) else TensorParallelEngine
        engine = cls(
            model, mesh=mesh, learning_rate=config.learning_rate,
            optimizer=_make_optimizer(config, train_ds, global_batch, model),
            grad_accum=config.grad_accum, precision=config.precision,
            **_codec_kw(config))
    except BaseException:
        mesh.close()
        raise
    return _Experiment(mesh=mesh, n=dp, train_ds=train_ds, test_ds=test_ds,
                       engine=engine, global_batch=global_batch, name=name)


def _setup_tensor_parallel(config: ExperimentConfig) -> _Experiment:
    """Megatron-style TP over a (data, model) mesh."""
    return _setup_model_parallel(config, "tensor_parallel",
                                 ("sync", "allreduce"), "tensor_parallel")


def _setup_fsdp_tp(config: ExperimentConfig) -> _Experiment:
    """fsdp × tp: the model's Megatron slices take their dims, then FSDP
    cuts each leaf's largest free dim over 'data' (``fsdp_spec`` with
    ``base``): per-rank state bytes ~1/(dp·tp)."""
    return _setup_model_parallel(config, "fsdp×tensor_parallel", ("fsdp",),
                                 "fsdp_tp[fsdp*tp]")


def _check_reserved_model_args(config: ExperimentConfig, reserved,
                               where: str) -> None:
    """``--model-arg`` keys that a dedicated flag or the mode itself sets
    are rejected (JAX ``_check_reserved_model_args``)."""
    bad = sorted(set(config.model_args or {}) & set(reserved))
    if bad:
        raise ValueError(
            f"--model-arg key(s) {bad} are reserved for {where}: they are "
            f"set by a dedicated flag or by the mode itself (e.g. "
            f"--num-experts, --dtype, --kv-heads, --positional, "
            f"--attention); drop them from --model-arg")


def _composite_engine(config: ExperimentConfig, model, mesh, train_ds,
                      global_batch: int):
    """``CompositeEngine`` with the run's optimizer recipe, router
    weights, accumulation, codec and precision."""
    from distributed_tensorflow_tpu_torch.engines.composite import (
        CompositeEngine)

    return CompositeEngine(
        model, mesh=mesh, learning_rate=config.learning_rate,
        optimizer=_make_optimizer(config, train_ds, global_batch, model),
        aux_weight=config.aux_weight,
        router_z_weight=config.router_z_weight,
        grad_accum=config.grad_accum, precision=config.precision,
        **_codec_kw(config))


def _setup_composite(config: ExperimentConfig) -> _Experiment:
    """dp×tp×sp (JAX ``harness.py:1203-1233``): a (data, model, seq) mesh,
    the sequence model with the Megatron layout and the configured ring or
    Ulysses attention, and ``CompositeEngine``; a ``--model-arg
    moe_experts=N`` model makes it MoE-aware (its experts whole on every
    rank), so the router weights reach the engine."""
    mode = "tensor_parallel×seq_parallel"
    mesh, dp = _split_mesh(config, config.tensor_parallel, mode,
                           meshlib.MODEL_AXIS,
                           (config.seq_parallel, meshlib.SEQ_AXIS),
                           grad_accum_ok=True)
    try:
        train_ds, test_ds = _load_data(config)
        model = _sequence_model(config, train_ds, mode, mesh.device,
                                config.attention_impl, partition_model=True)
        global_batch = _global_batch(config, dp)
        _check_accum_divides(config, global_batch, mode)
        engine = _composite_engine(config, model, mesh, train_ds,
                                   global_batch)
    except BaseException:
        mesh.close()
        raise
    return _Experiment(mesh=mesh, n=dp, train_ds=train_ds, test_ds=test_ds,
                       engine=engine, global_batch=global_batch,
                       name=f"composite[dp*tp*sp,{config.attention_impl}]")


def _setup_expert_parallel(config: ExperimentConfig,
                           tp: int = 1) -> _Experiment:
    """MoE mode (JAX ``harness.py:1410-1464``): a (data, expert) mesh of
    (n / expert_parallel, expert_parallel) ranks, the MoE classifier
    (``--model moe``, ``moe_mlp`` or ``mlp``) or a plug-in ``model_fn``,
    and ``ExpertParallelEngine``; tokens shard over (data, expert), so
    the global batch is ``-b`` × dp × ep.  ``tp`` > 1 adds a 'model' axis,
    (data, expert, model): each expert's FFN is also Megatron-split (the
    classifier's ``partition_model``), and the tokens are replicated over
    it."""
    from distributed_tensorflow_tpu_torch.engines.expert_parallel import (
        ExpertParallelEngine)

    mode = ("expert_parallel×tensor_parallel" if tp > 1
            else "expert_parallel")
    extra = [(tp, meshlib.MODEL_AXIS)] if tp > 1 else []
    mesh, dp = _split_mesh(config, config.expert_parallel, mode,
                           meshlib.EXPERT_AXIS, *extra, grad_accum_ok=True)
    try:
        train_ds, test_ds = _load_data(config)
        if config.model_fn is not None:
            model = config.model_fn()
        elif config.model in ("moe", "moe_mlp", "mlp"):
            _check_reserved_model_args(
                config, {"num_classes", "num_experts", "partition_experts",
                         "partition_model", "router_top_k", "dtype"}, mode)
            model = modellib.create_model(
                "moe", num_classes=train_ds.num_classes,
                **(config.model_args or {}),
                num_experts=config.num_experts, partition_experts=True,
                partition_model=tp > 1, router_top_k=config.router_top_k,
                dtype=config.dtype, device=mesh.device)
        else:
            raise ValueError(
                f"{mode} needs the MoE model (got --model {config.model}); "
                f"custom MoEs pass a model_fn whose experts are "
                f"models.moe.MoELayer modules")
        # a 'model' axis replicates the tokens: the global batch scales
        # with the token shards only
        n_token_shards = dp * config.expert_parallel
        global_batch = _global_batch(config, n_token_shards)
        _check_accum_divides(config, global_batch, mode)
        engine = ExpertParallelEngine(
            model, mesh=mesh, learning_rate=config.learning_rate,
            optimizer=_make_optimizer(config, train_ds, global_batch, model),
            aux_weight=config.aux_weight,
            router_z_weight=config.router_z_weight,
            grad_accum=config.grad_accum, precision=config.precision,
            **_codec_kw(config))
    except BaseException:
        mesh.close()
        raise
    return _Experiment(mesh=mesh, n=dp, train_ds=train_ds, test_ds=test_ds,
                       engine=engine, global_batch=global_batch,
                       name="expert_tp[dp*ep*tp]" if tp > 1 else mode)


def _setup_expert_tp(config: ExperimentConfig) -> _Experiment:
    """dp×ep×tp: ``_setup_expert_parallel(tp=...)``."""
    return _setup_expert_parallel(config, tp=config.tensor_parallel)


def _setup_expert_sp(config: ExperimentConfig, tp: int = 1) -> _Experiment:
    """dp×ep×sp (JAX ``harness.py:1523-1574``): a (data, expert, seq)
    mesh, a GPT or BERT with MoE-FFN blocks (``--num-experts``,
    ``--router-top-k``, ``partition_experts``) and ring or Ulysses
    attention, under ``CompositeEngine``.  ``tp`` > 1 adds a 'model' axis
    last, (data, expert, seq, model): the attention and embeddings
    Megatron-cut and every expert's FFN too (the 2-D layout)."""
    mode = ("expert_parallel×tensor_parallel×seq_parallel" if tp > 1
            else "expert_parallel×seq_parallel")
    if config.model not in _SEQUENCE_MODELS:
        raise ValueError(
            f"{mode} routes a transformer's FFN blocks (moe_experts on "
            f"models/gpt.py or models/bert.py); got --model {config.model} "
            f"— use --model gpt (--dataset lm_synth) or --model bert_tiny "
            f"(--dataset glue_synth)")
    _reject_flash_under_sp(config)
    if config.num_experts % config.expert_parallel:
        raise ValueError(
            f"num_experts {config.num_experts} not divisible by "
            f"expert_parallel {config.expert_parallel}")
    extra = [(tp, meshlib.MODEL_AXIS)] if tp > 1 else []
    mesh, dp = _split_mesh(config, config.expert_parallel, mode,
                           meshlib.EXPERT_AXIS,
                           (config.seq_parallel, meshlib.SEQ_AXIS), *extra,
                           grad_accum_ok=True)
    try:
        train_ds, test_ds = _load_data(config)
        model = _sequence_model(
            config, train_ds, mode, mesh.device, config.attention_impl,
            partition_model=tp > 1, moe_experts=config.num_experts,
            moe_top_k=config.router_top_k, partition_experts=True)
        global_batch = _global_batch(config, dp)
        _check_accum_divides(config, global_batch, mode)
        engine = _composite_engine(config, model, mesh, train_ds,
                                   global_batch)
    except BaseException:
        mesh.close()
        raise
    impl = config.attention_impl
    return _Experiment(mesh=mesh, n=dp, train_ds=train_ds, test_ds=test_ds,
                       engine=engine, global_batch=global_batch,
                       name=(f"expert_tp_sp[dp*ep*tp*sp,{impl}]" if tp > 1
                             else f"expert_sp[dp*ep*sp,{impl}]"))


def _setup_expert_tp_sp(config: ExperimentConfig) -> _Experiment:
    """dp×ep×tp×sp: ``_setup_expert_sp(tp=...)``."""
    return _setup_expert_sp(config, tp=config.tensor_parallel)


def _reject_model_args(config: ExperimentConfig, mode: str) -> None:
    """The built-in MLP stages are sized by ``--pipeline-hidden``, not
    ``--model-arg`` (JAX ``_reject_model_args``)."""
    if config.model_args:
        raise ValueError(
            f"--model-arg does not reach {mode} stage modules; size them "
            f"with --pipeline-hidden (got {sorted(config.model_args)})")


_STAGE_MODEL_ARGS = ("heads", "ffn", "layers_per_stage")
# the overflow monitor's advised remediation must be reachable from the
# CLI on pp×ep runs
_STAGE_MOE_ARGS = ("moe_capacity_factor",)


def _stage_model_args(config: ExperimentConfig, mode: str,
                      moe: bool = False) -> dict:
    """The ``--model-arg`` keys the GPT and BERT stage families take
    (JAX ``_stage_model_args``); MoE stages (pp×ep) take
    ``moe_capacity_factor`` too.  The width is ``--pipeline-hidden``."""
    allowed = _STAGE_MODEL_ARGS + (_STAGE_MOE_ARGS if moe else ())
    extra = dict(config.model_args or {})
    bad = sorted(set(extra) - set(allowed))
    if bad:
        raise ValueError(
            f"--model-arg key(s) {bad} do not reach {mode} stage modules; "
            f"stages accept {'/'.join(allowed)} via --model-arg, "
            f"width via --pipeline-hidden, and K/V heads / positional "
            f"encoding via --kv-heads / --positional")
    return extra


def _pipeline_stages(config: ExperimentConfig, train_ds, test_ds, mode: str,
                     device, partition_model: bool = False,
                     attention_impl: str = "dense",
                     seq_axis: str | None = None, moe: bool = False):
    """(embed, block, head) of the GPT or BERT stage family (JAX
    ``_pipeline_stages``): ``--pipeline-hidden`` wide, sized by
    ``--model-arg heads/ffn/layers_per_stage``, ``max_len`` the data's
    sequence length; the BERT vocabulary covers both splits (an id past
    the table would fail, where flax's Embed clamps it).
    ``partition_model`` gives them the Megatron layout (pp×tp);
    ``attention_impl`` and ``seq_axis`` make the GPT stages
    sequence-parallel (pp×sp); ``moe`` makes each block's FFN a routed
    MoE of ``--num-experts`` and ``--router-top-k`` with its experts cut
    over 'expert' (pp×ep)."""
    _require_token_data(train_ds, config, mode)
    dtype = modellib.resolve_dtype(config.dtype)
    extra = _stage_model_args(config, mode, moe=moe)
    if moe:
        extra.update(moe_experts=config.num_experts,
                     moe_top_k=config.router_top_k, partition_experts=True)
    if config.model in _LM_MODELS:
        from distributed_tensorflow_tpu_torch.models.gpt import (
            gpt_pipeline_stages)

        return gpt_pipeline_stages(
            vocab_size=train_ds.num_classes, hidden=config.pipeline_hidden,
            max_len=train_ds.x.shape[1], partition_model=partition_model,
            positional=config.positional, kv_heads=config.kv_heads,
            attention_impl=attention_impl, seq_axis=seq_axis, dtype=dtype,
            device=device, **extra)
    from distributed_tensorflow_tpu_torch.models.bert import (
        bert_pipeline_stages)

    return bert_pipeline_stages(
        num_classes=train_ds.num_classes,
        vocab_size=int(max(train_ds.x.max(), test_ds.x.max())) + 1,
        hidden=config.pipeline_hidden, max_len=train_ds.x.shape[1],
        partition_model=partition_model, dtype=dtype, device=device,
        **extra)


def _pipeline_experiment(config: ExperimentConfig, name: str, mesh,
                         dp: int, stages_fn, **engine_kw) -> _Experiment:
    """``PipelineEngine`` on ``mesh`` over ``stages_fn(train_ds,
    test_ds)`` (None: the built-in MLP stages), with ``microbatches``,
    ``pipeline_schedule``, ``remat`` and ``engine_kw``; the mesh is closed
    if anything fails."""
    from distributed_tensorflow_tpu_torch.engines.pipeline import (
        PipelineEngine)

    try:
        train_ds, test_ds = _load_data(config)
        stages = stages_fn(train_ds, test_ds)
        global_batch = _global_batch(config, dp)
        if (global_batch // dp) % config.microbatches:
            raise ValueError(
                f"per-data-shard batch {global_batch // dp} not "
                f"divisible by microbatches {config.microbatches}")
        engine = PipelineEngine(
            num_classes=train_ds.num_classes, hidden=config.pipeline_hidden,
            microbatches=config.microbatches, mesh=mesh,
            learning_rate=config.learning_rate,
            optimizer=_make_optimizer(config, train_ds, global_batch,
                                      lambda: engine.model),
            dtype=modellib.resolve_dtype(config.dtype), stages=stages,
            schedule=config.pipeline_schedule, remat=config.remat,
            **engine_kw)
    except BaseException:
        mesh.close()
        raise
    return _Experiment(mesh=mesh, n=dp, train_ds=train_ds, test_ds=test_ds,
                       engine=engine, global_batch=global_batch, name=name)


def _setup_pipeline_parallel(config: ExperimentConfig) -> _Experiment:
    """GPipe or 1F1B (JAX ``harness.py:1236-1277``): a (data, pipe) mesh
    of (n / pipeline_parallel, pipeline_parallel) ranks and
    ``PipelineEngine`` over the built-in MLP stages (``--model mlp``,
    sized by ``--pipeline-hidden`` alone) or a sequence model's stage
    family."""
    mode = "pipeline_parallel"
    mesh, dp = _split_mesh(config, config.pipeline_parallel, mode,
                           meshlib.PIPE_AXIS)

    def stages(train_ds, test_ds):
        if config.model in _SEQUENCE_MODELS and config.model_fn is None:
            return _pipeline_stages(config, train_ds, test_ds, mode,
                                    mesh.device)
        if config.model_fn is not None or config.model not in (
                "mlp", "mnist_mlp", "pipeline_mlp"):
            raise ValueError(
                f"pipeline_parallel ships stages for mlp and "
                f"{'/'.join(_SEQUENCE_MODELS)} (got --model {config.model}); "
                f"custom models pass stages=(embed, block, head) to "
                f"PipelineEngine directly")
        _reject_model_args(config, mode)
        return None

    return _pipeline_experiment(config, mode, mesh, dp, stages)


def _setup_pipeline_tp(config: ExperimentConfig) -> _Experiment:
    """dp×pp×tp (JAX ``harness.py:1280-1315``): a (data, pipe, model)
    mesh and ``PipelineEngine`` over the GPT or BERT stages with the
    Megatron layout and dense attention; GPipe or 1F1B."""
    mode = "pipeline_parallel×tensor_parallel"
    mesh, dp = _split_mesh(config, config.pipeline_parallel, mode,
                           meshlib.PIPE_AXIS,
                           (config.tensor_parallel, meshlib.MODEL_AXIS))

    def stages(train_ds, test_ds):
        if config.model not in _SEQUENCE_MODELS or \
                config.model_fn is not None:
            raise ValueError(
                f"pipeline×tensor parallelism ships TP-annotated stages for "
                f"{'/'.join(_SEQUENCE_MODELS)} (got --model {config.model}); "
                f"custom models pass stages=(embed, block, head) with "
                f"with_partitioning('model', ...) annotations to "
                f"PipelineEngine")
        return _pipeline_stages(config, train_ds, test_ds, mode, mesh.device,
                                partition_model=True)

    return _pipeline_experiment(
        config, f"pipeline_tp[dp*pp*tp,{config.pipeline_schedule}]", mesh,
        dp, stages)


def _setup_pipeline_sp(config: ExperimentConfig, tp: int = 1) -> _Experiment:
    """dp×pp×sp (JAX ``harness.py:1467-1512``): a (data, pipe, seq) mesh
    and ``PipelineEngine`` over GPT stages whose ring or Ulysses
    attention runs over 'seq'.  ``tp`` > 1 adds a 'model' axis last,
    (data, pipe, seq, model), and the stages' Megatron layout."""
    mode = ("pipeline_parallel×tensor_parallel×seq_parallel" if tp > 1
            else "pipeline_parallel×seq_parallel")
    if config.model not in _LM_MODELS or config.model_fn is not None:
        raise ValueError(
            f"{mode} ships GPT decoder stages only "
            f"(got --model {config.model}); custom models pass seq-aware "
            f"stages to PipelineEngine directly")
    _reject_flash_under_sp(config)
    extra = [(tp, meshlib.MODEL_AXIS)] if tp > 1 else []
    mesh, dp = _split_mesh(config, config.pipeline_parallel, mode,
                           meshlib.PIPE_AXIS,
                           (config.seq_parallel, meshlib.SEQ_AXIS), *extra)
    impl = config.attention_impl

    def stages(train_ds, test_ds):
        return _pipeline_stages(config, train_ds, test_ds, mode, mesh.device,
                                partition_model=tp > 1, attention_impl=impl,
                                seq_axis=meshlib.SEQ_AXIS)

    return _pipeline_experiment(
        config, (f"pipeline_tp_sp[dp*pp*tp*sp,{impl}]" if tp > 1
                 else f"pipeline_sp[dp*pp*sp,{impl}]"), mesh, dp, stages)


def _setup_pipeline_tp_sp(config: ExperimentConfig) -> _Experiment:
    """dp×pp×tp×sp: ``_setup_pipeline_sp(tp=...)``."""
    return _setup_pipeline_sp(config, tp=config.tensor_parallel)


def _setup_pipeline_ep(config: ExperimentConfig, tp: int = 1,
                       sp: int = 1) -> _Experiment:
    """dp×pp×ep (JAX ``harness.py:1318-1390``): a (data, pipe, expert)
    mesh and ``PipelineEngine`` (GPipe) over GPT or BERT stages whose
    blocks carry the routed MoE FFN, its experts cut over 'expert'; the
    batch shards over 'data' only.  ``tp`` > 1 adds a 'model' axis and
    the stages' Megatron layout with the 2-D expert layout; ``sp`` > 1 a
    'seq' axis last and GPT stages with ring or Ulysses attention, (data,
    pipe, expert[, model], seq).  Dense attention unless sp > 1, as in
    JAX."""
    mode = "pipeline_parallel×expert_parallel" + (
        "×tensor_parallel" if tp > 1 else "") + (
        "×seq_parallel" if sp > 1 else "")
    lm_only = sp > 1  # a seq-sharded carry cannot serve a [CLS] head
    family = _LM_MODELS if lm_only else _SEQUENCE_MODELS
    if config.model not in family or config.model_fn is not None:
        raise ValueError(
            f"{mode} ships MoE-FFN stages for {'/'.join(family)} "
            f"(got --model {config.model}); custom models pass stages "
            f"whose block carries moe_experts/partition_experts "
            f"(models/moe.py MoELayer) to PipelineEngine")
    if sp > 1:
        _reject_flash_under_sp(config)
    if config.num_experts % config.expert_parallel:
        raise ValueError(
            f"num_experts {config.num_experts} not divisible by "
            f"expert_parallel {config.expert_parallel}")
    extra = [(config.expert_parallel, meshlib.EXPERT_AXIS)]
    if tp > 1:
        extra.append((tp, meshlib.MODEL_AXIS))
    if sp > 1:
        extra.append((sp, meshlib.SEQ_AXIS))
    mesh, dp = _split_mesh(config, config.pipeline_parallel, mode,
                           meshlib.PIPE_AXIS, *extra)
    impl = config.attention_impl

    def stages(train_ds, test_ds):
        return _pipeline_stages(
            config, train_ds, test_ds, mode, mesh.device, moe=True,
            partition_model=tp > 1,
            attention_impl=impl if sp > 1 else "dense",
            seq_axis=meshlib.SEQ_AXIS if sp > 1 else None)

    tag = (f"pipeline_ep_tp_sp[dp*pp*ep*tp*sp,{impl}]" if tp > 1 and sp > 1
           else "pipeline_ep_tp[dp*pp*ep*tp]" if tp > 1
           else f"pipeline_ep_sp[dp*pp*ep*sp,{impl}]" if sp > 1
           else f"pipeline_ep[dp*pp*ep,{config.pipeline_schedule}]")
    return _pipeline_experiment(config, tag, mesh, dp, stages,
                                aux_weight=config.aux_weight,
                                router_z_weight=config.router_z_weight)


def _setup_pipeline_ep_tp(config: ExperimentConfig) -> _Experiment:
    """dp×pp×ep×tp: ``_setup_pipeline_ep(tp=...)``."""
    return _setup_pipeline_ep(config, tp=config.tensor_parallel)


def _setup_pipeline_ep_sp(config: ExperimentConfig) -> _Experiment:
    """dp×pp×ep×sp: ``_setup_pipeline_ep(sp=...)``."""
    return _setup_pipeline_ep(config, sp=config.seq_parallel)


def _setup_pipeline_ep_tp_sp(config: ExperimentConfig) -> _Experiment:
    """dp×pp×ep×tp×sp, a 5-D mesh: ``_setup_pipeline_ep(tp=..., sp=...)``."""
    return _setup_pipeline_ep(config, tp=config.tensor_parallel,
                              sp=config.seq_parallel)


def _codec_kw(config: ExperimentConfig) -> dict[str, Any]:
    """The codec settings every engine takes."""
    return dict(grad_compression=config.grad_compression,
                grad_bucket_mb=config.grad_bucket_mb)


def _validate_grad_bucket(config: ExperimentConfig) -> None:
    """Reject a negative ``--grad-bucket-mb``, and any under the pipeline
    schedules (JAX ``harness.py:537-558``)."""
    if not config.grad_bucket_mb:
        return
    if config.grad_bucket_mb < 0:
        raise ValueError(
            f"--grad-bucket-mb must be >= 0 (0 disables bucketing), "
            f"got {config.grad_bucket_mb}")
    if config.pipeline_parallel > 1:
        raise ValueError(
            "--grad-bucket-mb is implemented for the data-parallel "
            "and GSPMD engines (sync/async/allreduce/gossip/fsdp, -tp, "
            "-sp, -ep and their composites); the pipeline schedules "
            "(-pp) are not supported — drop the flag or train "
            "without -pp")


def check_codec_config(config: ExperimentConfig) -> None:
    """A misspelt codec fails here, not inside an engine's constructor
    (JAX ``harness.py:617-634``), as does a codec or a bucket size under
    the pipeline schedules, and a negative bucket size."""
    if config.grad_compression != "none":
        from distributed_tensorflow_tpu_torch.parallel import compression

        compression.make_codec(config.grad_compression)
        if config.pipeline_parallel > 1:
            raise ValueError(
                "--grad-compression is implemented for the data-parallel "
                "and GSPMD engines (sync/async/allreduce/gossip/fsdp, -tp, "
                "-sp, -ep and their composites); the pipeline schedules "
                "(-pp) are not supported yet — drop the flag or train "
                "without -pp")
    _validate_grad_bucket(config)


def _parallel_factors(config: ExperimentConfig) -> list[str]:
    return [f for f in ("seq_parallel", "tensor_parallel",
                        "pipeline_parallel", "expert_parallel")
            if getattr(config, f) > 1]


def check_parallel_factors(config: ExperimentConfig) -> None:
    """The checks of the model-parallel factors that hold before any rank
    is spawned (every one alone and every composite of them is served:
    ``_COMBOS``).  ``num_experts`` must split over ``expert_parallel``
    (JAX ``harness.py:1340-1343, 1428-1431, 1537-1540``), and
    ``router_z_weight`` needs a MoE-aware engine, the -ep paths (pp×ep
    among them) or a MoE tp×sp composite (JAX ``harness.py:606-616``).
    The CLI calls it before it spawns ranks."""
    # the models each -ep path routes (the pipeline's MoE stages are the
    # sequence families'; it refuses the others first, in JAX's words)
    moe_model = (config.model in ("moe", "moe_mlp", "mlp")
                 and config.pipeline_parallel <= 1) or (
        config.model in _SEQUENCE_MODELS and (
            config.seq_parallel > 1 or config.pipeline_parallel > 1))
    if (config.expert_parallel > 1 and config.model_fn is None
            and moe_model and config.num_experts % config.expert_parallel):
        raise ValueError(
            f"num_experts {config.num_experts} not divisible by "
            f"expert_parallel {config.expert_parallel}")
    # the z-loss is applied by the MoE-aware engines: the -ep paths, and
    # the tp×sp composite when the model carries MoE blocks
    composite_moe = (config.tensor_parallel > 1 and config.seq_parallel > 1
                     and bool((config.model_args or {}).get("moe_experts")))
    if (config.router_z_weight and config.expert_parallel <= 1
            and not composite_moe):
        raise ValueError(
            "--router-z-weight is applied by the MoE-aware engines; "
            "without --expert-parallel > 1 (or a tp×sp composite with "
            "--model-arg moe_experts=N) it would be silently ignored")


def _setup(config: ExperimentConfig) -> _Experiment:
    check_engine(config.engine)
    check_codec_config(config)
    config = _resolve_precision(config)
    if config.sample_tokens:
        # family checks only here; shapes are checked post-setup in
        # _validate_sampling
        if config.model_fn is None and config.model not in _LM_MODELS:
            raise ValueError(
                f"--sample decodes autoregressively and needs a causal LM "
                f"({'/'.join(_LM_MODELS)}), got --model {config.model}")
    check_parallel_factors(config)
    multi = frozenset(_parallel_factors(config))
    if len(multi) > 1:
        return _COMBOS[multi](config)
    if config.seq_parallel > 1:
        return _setup_seq_parallel(config)
    if config.tensor_parallel > 1:
        if config.engine == "fsdp":
            return _setup_fsdp_tp(config)
        return _setup_tensor_parallel(config)
    if config.pipeline_parallel > 1:
        return _setup_pipeline_parallel(config)
    if config.expert_parallel > 1:
        return _setup_expert_parallel(config)
    mesh = meshlib.create_mesh(config.n_devices, device=config.device)
    try:
        n = mesh.world_size
        train_ds, test_ds = _load_data(config)
        model = _resolve_model(config, train_ds.num_classes, mesh.device)
        # reference -b is the PER-WORKER batch: global batch = b × n
        global_batch = _global_batch(config, n)
        engine_kw: dict[str, Any] = dict(
            mesh=mesh, learning_rate=config.learning_rate,
            optimizer=_make_optimizer(config, train_ds, global_batch,
                                      model),
            precision=config.precision, **_codec_kw(config))
        if config.engine == "async":
            engine_kw["sync_every"] = config.sync_every
        elif config.engine == "gossip":
            engine_kw["degree"] = config.degree
        if config.grad_accum > 1:
            if config.engine not in ("sync", "allreduce", "fsdp"):
                raise ValueError(
                    f"grad_accum is implemented by the sync/allreduce/fsdp "
                    f"engines (got engine='{config.engine}')")
            if (global_batch // n) % config.grad_accum:
                raise ValueError(
                    f"per-device batch {global_batch // n} not divisible by "
                    f"grad_accum {config.grad_accum}")
        if config.engine in ("sync", "allreduce", "fsdp"):
            engine_kw["grad_accum"] = config.grad_accum
        engine = create_engine(config.engine, model, **engine_kw)
    except BaseException:
        mesh.close()
        raise
    return _Experiment(mesh=mesh, n=n, train_ds=train_ds, test_ds=test_ds,
                       engine=engine, global_batch=global_batch,
                       name=config.engine)


# the composites of the model-parallel factors (JAX harness.py:649-672)
_COMBOS = {
    frozenset({"seq_parallel", "tensor_parallel"}): _setup_composite,
    frozenset({"pipeline_parallel", "tensor_parallel"}): _setup_pipeline_tp,
    frozenset({"pipeline_parallel", "seq_parallel"}): _setup_pipeline_sp,
    frozenset({"pipeline_parallel", "tensor_parallel", "seq_parallel"}):
        _setup_pipeline_tp_sp,
    frozenset({"expert_parallel", "tensor_parallel"}): _setup_expert_tp,
    frozenset({"expert_parallel", "seq_parallel"}): _setup_expert_sp,
    frozenset({"expert_parallel", "tensor_parallel", "seq_parallel"}):
        _setup_expert_tp_sp,
    frozenset({"pipeline_parallel", "expert_parallel"}): _setup_pipeline_ep,
    frozenset({"pipeline_parallel", "expert_parallel", "tensor_parallel"}):
        _setup_pipeline_ep_tp,
    frozenset({"pipeline_parallel", "expert_parallel", "seq_parallel"}):
        _setup_pipeline_ep_sp,
    frozenset({"pipeline_parallel", "expert_parallel", "tensor_parallel",
               "seq_parallel"}): _setup_pipeline_ep_tp_sp,
}


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


def _check_recovery_config(config: ExperimentConfig) -> None:
    """The checkpoint, resume, lease, watchdog and timeline flags that
    cannot work, before anything is set up (JAX's messages)."""
    if config.watchdog_abort and config.watchdog_timeout <= 0:
        raise ValueError("watchdog_abort requires watchdog_timeout > 0 "
                         "(nothing would ever detect the stall)")
    if config.timeline_interval < 0:
        raise ValueError(f"--timeline-interval must be >= 0 seconds "
                         f"(0 = sample at every boundary), got "
                         f"{config.timeline_interval}")
    if config.resume and not config.checkpoint_dir:
        raise ValueError("--resume requires --checkpoint-dir")
    if config.elastic_restore and not config.checkpoint_dir:
        raise ValueError("--elastic-restore requires --checkpoint-dir")
    if config.checkpoint_every and not config.checkpoint_dir:
        raise ValueError("--checkpoint-every requires --checkpoint-dir "
                         "(no checkpoints would be written otherwise)")
    if config.checkpoint_every < 0:
        raise ValueError(f"--checkpoint-every must be >= 0, got "
                         f"{config.checkpoint_every}")
    if config.max_steps_per_lease < 0:
        raise ValueError(f"--max-steps-per-lease must be >= 0, got "
                         f"{config.max_steps_per_lease}")
    if config.max_steps_per_lease and not config.checkpoint_dir:
        raise ValueError("--max-steps-per-lease requires --checkpoint-dir "
                         "(the lease drain's final checkpoint needs "
                         "somewhere to go)")


def _restore(config: ExperimentConfig, ex: _Experiment, trainer, ckpt_mgr,
             sink) -> dict:
    """``--resume``/``--elastic-restore``: the latest checkpoint into a
    fresh state of the engine, policy-aware (a checkpoint of the same
    ``--precision`` restores directly, an f32 one adopts into a master
    policy); returns the accounting the summary carries."""
    out = {"data_state": None, "preemption_lost_s": None,
           "restored_step": None}
    if ckpt_mgr.latest_step() is None:
        flag = "--elastic-restore" if config.elastic_restore else "--resume"
        print(f"warning: {flag} set but no checkpoint found under "
              f"{config.checkpoint_dir}; training from scratch")
        return out
    template = ex.engine.init_state(
        torch.Generator().manual_seed(config.seed), ex.train_ds.x[:1])
    try:
        if config.elastic_restore:
            # the restore with its sidecar: the data state for the
            # exactly-once resume ({} when the checkpoint has none →
            # replay accounting) and the save wall time
            from distributed_tensorflow_tpu_torch import elastic

            trainer.state, extra = elastic.elastic_restore(
                ckpt_mgr, ex.engine, template)
            out["data_state"] = (extra or {}).get("data_state") or {}
            out["preemption_lost_s"] = elastic.preemption_lost_s(extra)
        else:
            trainer.state = precisionlib.restore_into_policy(
                ckpt_mgr, template, ex.engine.precision)
    except Exception as e:
        # the commonest mismatch is a --health toggle across the resume:
        # the health capture's step count is a checkpoint entry
        raise ValueError(
            f"--resume could not restore the checkpoint under "
            f"{config.checkpoint_dir} into this run's state layout "
            f"(--health {config.health}, --precision {config.precision}).  "
            f"If the checkpointed run used a different --health setting, "
            f"the optimizer tree differs (the health capture slots live in "
            f"it) — resume with the original setting.  An f32 checkpoint "
            f"restores into a master --precision policy automatically; "
            f"other precision crossings need the original policy.  "
            f"Original error: {type(e).__name__}: {e}") from e
    out["restored_step"] = ckpt_mgr.latest_step()
    sink.emit("resumed", step=out["restored_step"],
              elastic=config.elastic_restore,
              **({"preemption_lost_s": out["preemption_lost_s"]}
                 if config.elastic_restore else {}))
    return out


@_repeatable_math()
def run(config: ExperimentConfig) -> dict[str, Any]:
    """Run one experiment on this rank; returns the summary dict.  Rank 0
    alone logs heartbeats, writes ``result_path`` and reports the
    start/done/results triple to the supervisor; every rank returns the
    same summary (its numbers are all-reduced).  After the evaluation an
    LM's summary gains ``test_perplexity``, ``sample_tokens`` adds
    ``sample_prompts``/``samples`` and ``serve_requests`` the ``serve``
    section with ``serve_exit_policy`` (1, with a warning, when a request
    went unserved).

    With ``max_restarts > 0`` the run is wrapped in checkpoint-resume
    crash recovery (``failure.run_with_recovery``) — in one process only:
    inside a rank of a group of more than one it raises (``cli -n N``
    wraps the spawn)."""
    if config.max_restarts > 0:
        import torch.distributed as dist

        from distributed_tensorflow_tpu_torch.utils.failure import (
            run_with_recovery)

        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(
                "max_restarts inside a rank of a multi-rank group: a "
                "crashed peer leaves the group unusable, so recovery "
                "wraps the launch of every rank (cli -n N "
                "--max-restarts), not each rank's run")
        return run_with_recovery(
            dataclasses.replace(config, max_restarts=0),
            max_restarts=config.max_restarts, run_fn=run)
    return _run(config)


def _probe_collective_overlap(ex: _Experiment, tracer) -> dict | None:
    """The one-time exposed-against-hidden split of a
    ``--grad-bucket-mb`` run (``overlap.probe_engine_overlap``, JAX
    ``harness.py:2047-2086``) on the first training batch, spanned and
    evented as ``collective_overlap`` on ``tracer``; None when the engine
    has no probe (SP, EP, async and gossip: JAX's have none) or the probe
    failed, and a failed probe never ends the run.  Under ``-n N`` the
    ranks are processes and the probe holds collectives, so every rank
    runs it together (JAX skips it only on multi-host jobs)."""
    from distributed_tensorflow_tpu_torch.parallel import overlap

    result = error = None
    with tracer.span("collective_overlap", probe=True):
        try:
            batch = next(iter(ex.train_ds.batches(ex.global_batch,
                                                  shuffle=False)), None)
            if batch is None:
                error = "dataset yielded no probe batch"
            else:
                xs, ys = ex.engine.shard_batch(batch[0], batch[1])
                result = overlap.probe_engine_overlap(
                    ex.engine, xs, ys, sample_x=ex.train_ds.x[:1])
                if result is None:
                    error = "engine has no overlap probe"
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
            print(f"warning: collective overlap probe failed: {error}",
                  file=sys.stderr)
    if result is None:
        tracer.event("collective_overlap", supported=False, error=error)
        return None
    tracer.event("collective_overlap", **result)
    return result


def _lease_stop(lease, mesh):
    """The lease's ``should_stop`` for this rank.  JAX runs one process,
    where one signal flag stops every device at the same boundary; the
    ranks of ``cli -n N`` are processes that a SIGTERM reaches at
    different moments, and a rank stopping a chunk before its peers would
    leave them in their next collective.  So under a signal-armed lease
    over more than one rank each consultation is a vote: one all-reduce
    (max) of the signal number this rank has seen.  A signal any rank saw
    stops every rank at this boundary with the same reason (and the same
    ``lease.report()``); a signal that lands after the vote waits for the
    next boundary.  The step budget needs no vote (every rank counts the
    same steps).  At one rank, or off the main thread (no handler), it is
    ``lease.should_stop`` itself: no collective."""
    if mesh.world_size == 1 or not lease.installed:
        return lease.should_stop
    import torch.distributed as dist

    def agreed(steps_done: int) -> str | None:
        vote = torch.tensor([lease.preempt_signal or 0], dtype=torch.int64,
                            device=mesh.device)
        dist.all_reduce(vote, op=dist.ReduceOp.MAX)
        signum = int(vote.item())
        if signum:
            lease.preempt_signal = signum
            return lease.should_stop(steps_done)
        budget = lease.max_steps_per_lease
        if budget and steps_done >= budget:
            return f"max_steps_per_lease:{budget}"
        return None

    return agreed


def _run(config: ExperimentConfig) -> dict[str, Any]:
    from distributed_tensorflow_tpu_torch.elastic import (
        LeaseManager, StragglerDetector)
    from distributed_tensorflow_tpu_torch.observability import (
        ProgramLedger, Timeline, Tracer, build_run_report)
    from distributed_tensorflow_tpu_torch.utils.metrics import (
        MetricsLogger, profile)

    from distributed_tensorflow_tpu_torch.ops import _build

    _reject_fleet(config)
    _check_recovery_config(config)
    if config.compile_cache:
        # before any kernel is built: the run's libraries load from (or
        # build into) this directory
        _build.set_build_dir(config.compile_cache)
    ex = _setup(config)
    try:
        # the health layer before any state exists (the probe's, the
        # resume template's, the fit's)
        if config.health not in ("off", "on"):
            raise ValueError(
                f"--health must be 'off' or 'on', got '{config.health}'")
        if config.health == "on":
            ex.engine.enable_health()
        if config.sample_tokens:
            _validate_sampling(config, ex, ex.test_ds)
        if config.serve_requests:
            # like sampling: every argument that can fail is checked
            # before the run spends its training budget
            _validate_serving(config, ex, ex.test_ds)
        rank0 = ex.mesh.rank == 0
        sink = ResultSink(
            config.result_path if rank0 else None,
            supervisor_address=config.supervisor_address if rank0 else None)
        # the tracer is always live: file-backed under --trace, its span
        # aggregates otherwise (the run report reads them either way);
        # every rank traces into its own file
        trace_path = config.trace_path
        if trace_path and ex.mesh.world_size > 1 and not rank0:
            trace_path = f"{trace_path}.rank{ex.mesh.rank}"
        tracer = Tracer(path=trace_path, process_index=ex.mesh.rank)
        # every rank logs (and guards) its steps; rank 0 writes the file
        metrics_logger = (MetricsLogger(config.metrics_path if rank0
                                        else None,
                                        log_every=max(1, config.log_every))
                          if config.metrics_path else None)
        timeline = (Timeline(interval_s=config.timeline_interval)
                    if config.timeline else None)
        # --timeline or --roofline arms the program ledger: the engine's
        # chunk graphs, the kernel builds and the serve table record there
        ledger = (ProgramLedger() if config.timeline or config.roofline
                  else None)
        ex.engine.ledger = ledger
        total = (ex.n * config.seq_parallel * config.tensor_parallel
                 * config.pipeline_parallel * config.expert_parallel)
        roofline = _roofline(config, ex, total) if config.roofline else None
        ckpt_mgr = watchdog = lease = None
        # before any state of the run exists: the probe's throwaway state
        # reinitializes the engine's module
        overlap_probe = (_probe_collective_overlap(ex, tracer)
                         if config.grad_bucket_mb else None)
        try:
            trainer = Trainer(None, engine=ex.engine, seed=config.seed)
            resumed = {"data_state": None, "preemption_lost_s": None,
                       "restored_step": None}
            if config.checkpoint_dir:
                from distributed_tensorflow_tpu_torch.utils.checkpoint import (
                    AsyncCheckpointManager, CheckpointManager)

                # either manager sweeps the tmp_step_* a crashed write
                # left, so a resume only sees complete checkpoints
                ckpt_mgr = (AsyncCheckpointManager(config.checkpoint_dir)
                            if config.async_checkpoint
                            else CheckpointManager(config.checkpoint_dir))
                if config.resume or config.elastic_restore:
                    resumed = _restore(config, ex, trainer, ckpt_mgr, sink)
                # every checkpointed run arms the graceful SIGTERM drain;
                # --max-steps-per-lease adds the step budget
                lease = LeaseManager(
                    max_steps_per_lease=config.max_steps_per_lease).install()
            straggler = StragglerDetector(tracer=tracer)
            if config.watchdog_timeout > 0:
                from distributed_tensorflow_tpu_torch.utils.failure import (
                    Watchdog)

                def _on_stall(elapsed: float) -> None:
                    sink.emit("stall", elapsed=elapsed)
                    if config.watchdog_abort:
                        # the step loop is wedged where no exception
                        # reaches it: exit so a supervisor relaunches
                        # with --resume (EX_TEMPFAIL); os._exit skips
                        # every finally, so drain the sinks first
                        if metrics_logger is not None:
                            metrics_logger.close()
                        tracer.close()
                        sink.close()
                        os._exit(75)

                watchdog = Watchdog(timeout=config.watchdog_timeout,
                                    on_stall=_on_stall)
            sink.start()
            try:
                with profile(config.profile_dir, tracer=tracer), (
                        _build.watch_builds(ledger) if ledger is not None
                        else contextlib.nullcontext()):
                    fit = trainer.fit(
                        ex.train_ds, epochs=config.epochs,
                        batch_size=ex.global_batch,
                        log_every=config.log_every,
                        log_fn=print if rank0 else _quiet,
                        checkpoint_manager=ckpt_mgr,
                        checkpoint_every=config.checkpoint_every,
                        metrics_logger=metrics_logger, watchdog=watchdog,
                        steps_per_call=config.steps_per_call,
                        prefetch=config.prefetch, tracer=tracer,
                        should_stop=(_lease_stop(lease, ex.mesh)
                                     if lease is not None else None),
                        data_state=resumed["data_state"],
                        straggler_detector=straggler, timeline=timeline,
                        nan_guard=config.nan_guard,
                        on_anomaly=config.on_anomaly, roofline=roofline)
            finally:
                if watchdog is not None:
                    watchdog.close()
                if lease is not None and not config.serve_requests:
                    # nothing after the fit consults the lease without a
                    # serve window, and a still-armed handler would
                    # swallow a SIGTERM during the evaluation and report
                    lease.uninstall()
            if config.grad_bucket_mb:
                # None: the engine has no probe or it failed (not a
                # measured 0)
                fit["collective_overlap"] = overlap_probe
            if config.elastic_restore:
                fit["preemption_lost_s"] = resumed["preemption_lost_s"]
                fit["restored_step"] = resumed["restored_step"]
            if lease is not None:
                fit["lease"] = lease.report()
            if fit.get("preempted"):
                # the drain notice: a planned ['preempted', reason, step]
                # instead of a dead socket
                sink.preempted(fit["preempted"],
                               fit.get("start_step", 0) + fit["steps"])
            sink.done(fit["elapsed"])
            with tracer.span("eval", final=True):
                ev = trainer.evaluate(ex.test_ds,
                                      batch_size=config.eval_batch)
            sink.results(ev["accuracy"], loss=ev["loss"])
            model_name = config.model if config.model_fn is None else getattr(
                config.model_fn, "__name__", "custom_model_fn")
            summary = {
                "engine": ex.name,
                "model": model_name,
                "dataset": ex.train_ds.name,
                "synthetic_data": ex.train_ds.synthetic,
                "n_devices": total,
                "data_parallel": ex.n,
                "seq_parallel": config.seq_parallel,
                "tensor_parallel": config.tensor_parallel,
                "pipeline_parallel": config.pipeline_parallel,
                "expert_parallel": config.expert_parallel,
                "num_experts": (config.num_experts
                                if config.expert_parallel > 1 else None),
                "microbatches": (config.microbatches
                                 if config.pipeline_parallel > 1 else None),
                "global_batch": ex.global_batch,
                "epochs": config.epochs,
                "precision": fit["precision"],
                "steps": fit["steps"],
                # the lease's reason when it ended the fit, None on a
                # normal finish: relaunch with --elastic-restore
                "preempted": fit.get("preempted"),
                "steps_per_call": fit["steps_per_call"],
                "prefetch_depth": fit["prefetch_depth"],
                "elapsed_s": fit["elapsed"],
                "examples_per_sec": fit["examples_per_sec"],
                "examples_per_sec_per_device":
                    fit["examples_per_sec"] / total,
                "test_accuracy": ev["accuracy"],
                "test_loss": ev["loss"],
                # next-token cross-entropy exponentiated: the LM quality
                # number (exp of a classification loss means nothing)
                **({"test_perplexity": math.exp(min(ev["loss"], 80.0))}
                   if config.model in _LM_MODELS else {}),
            }
            # an expert-parallel run reports the router-health watch
            # (sustained capacity overflow warns during training)
            monitor = getattr(ex.engine, "overflow_monitor", None)
            if monitor is not None:
                summary.update(monitor.report())
            if config.sample_tokens:
                summary.update(_sample_from_state(config, ex, trainer.state,
                                                  ex.test_ds))
            serve_sec = None
            if config.serve_requests:
                # the serve window drains on the lease's SIGNAL alone
                # (the budget counts training steps)
                serve_stop = (_lease_stop(lease, ex.mesh)
                              if lease is not None else None)
                with (_build.watch_builds(ledger) if ledger is not None
                      else contextlib.nullcontext()):
                    serve_sec = _serve_from_state(
                        config, ex, trainer.state, ex.test_ds,
                        tracer=tracer,
                        should_stop=(None if serve_stop is None else
                                     (lambda _iters: serve_stop(0))),
                        timeline=timeline, ledger=ledger,
                        roofline=roofline, total_devices=total)
                summary["serve"] = serve_sec
                # a window that lost requests must not bury it in the
                # summary: a warning and a flag to gate on (0 = clean)
                unserved = serve_sec.get("unserved_requests")
                summary["serve_exit_policy"] = 1 if unserved else 0
                if unserved:
                    reasons = [f"unserved_requests={unserved}"]
                    tracer.event("serve_warning", reasons=reasons,
                                 preempted=serve_sec.get("preempted"))
                    sink.emit("serve_warning", reasons=reasons,
                              preempted=serve_sec.get("preempted"))
                    print(f"warning: serve window degraded "
                          f"({', '.join(reasons)}); serve_exit_policy=1",
                          file=sys.stderr)
            if metrics_logger is not None:
                # drained first: stats() mid-drain would read as loss
                metrics_logger.flush()
            if timeline is not None:
                # the sampled series as bulk timeline_series events
                timeline.emit(tracer)
            report = build_run_report(fit, watchdog=watchdog,
                                      metrics_logger=metrics_logger,
                                      tracer=tracer, serve=serve_sec,
                                      timeline=timeline, ledger=ledger,
                                      roofline=roofline)
            summary["run_report"] = report
            sink.emit("run_report", **report)
            sink.emit("summary", **summary)
            return summary
        finally:
            if lease is not None:
                # the previous SIGTERM disposition back: a later run in
                # this process must not drain into this run's lease
                lease.uninstall()
            if ckpt_mgr is not None:
                # drain + join the writer on ANY exit: a restart must never
                # begin its restore with a write of this run in flight
                # (reraise=False: fit's final drain surfaced writer errors,
                # and an exception path must keep its own error)
                ckpt_mgr.close(reraise=False)
            if metrics_logger is not None:
                metrics_logger.close()
            tracer.close()
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
    it).  A schedule's horizon is ``max_steps`` unless the config sets
    one: the loop runs far past ``epochs``."""
    if config.schedule_horizon_steps is None:
        config = dataclasses.replace(config,
                                     schedule_horizon_steps=max_steps)
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


def _reject_fleet(config: ExperimentConfig) -> None:
    """The fleet's serve fields at any value but their default raise
    (ROADMAP Queue 1: fleet), before anything is set up."""
    for name, default in _FLEET_DEFAULTS.items():
        if getattr(config, name) != default:
            not_ported(f"--{name.replace('_', '-').removesuffix('-s')} "
                       f"(serving fleet)", "fleet")


def _is_pipeline(engine) -> bool:
    """A pipeline engine has no monolithic model: its samples and serving
    branch on it (JAX ``_is_pipeline``)."""
    from distributed_tensorflow_tpu_torch.engines.pipeline import (
        PipelineEngine)

    return isinstance(engine, PipelineEngine)


def _gpt_model(ex: _Experiment):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    model = ex.engine.model
    return model if isinstance(model, GPTLM) else None


def _validate_sampling(config: ExperimentConfig, ex: _Experiment,
                       test_ds) -> None:
    """Every ``sample_tokens`` failure that can be known is raised before
    training (JAX ``_validate_sampling``): a raise after it would waste
    the run."""
    if config.sample_tokens < 0:
        raise ValueError(
            f"--sample must be positive, got {config.sample_tokens}")
    if _is_pipeline(ex.engine):
        # the pipeline samples through its fixed-length decode
        # (PipelineEngine.generate): GPT stages only
        from distributed_tensorflow_tpu_torch.models.gpt import GPTPipeEmbed

        if not isinstance(ex.engine.embed, GPTPipeEmbed):
            raise ValueError(
                f"--sample under --pipeline-parallel needs GPT decoder "
                f"stages (vocab-head output); this run's embed stage is "
                f"{type(ex.engine.embed).__name__}")
        if ex.engine.moe:
            raise ValueError(
                "--sample is unavailable for MoE pipeline stages "
                "(-pp with --num-experts): expert routing's capacity "
                "depends on every buffer position, so the fixed-length "
                "decode would not be the true greedy continuation — "
                "sample a dense-FFN pipeline run, or train MoE without "
                "-pp and use the KV-cache sampler")
        max_len = ex.engine.embed.max_len
    else:
        model = _gpt_model(ex)
        if model is None:
            raise ValueError(
                f"--sample requires the GPT causal LM; the resolved model "
                f"is {type(ex.engine.model).__name__}")
        max_len = model.max_len
    plen = config.sample_prompt_len
    if plen < 1 or plen > test_ds.x.shape[1]:
        raise ValueError(
            f"--sample-prompt-len {plen} outside the test sequences' "
            f"length {test_ds.x.shape[1]}")
    if plen + config.sample_tokens > max_len:
        raise ValueError(
            f"--sample-prompt-len {plen} + --sample {config.sample_tokens} "
            f"exceeds the model's capacity max_len={max_len}")
    n_prompts = ex.n
    if len(test_ds.x) < n_prompts:
        raise ValueError(
            f"--sample takes one prompt per data shard ({n_prompts}), but "
            f"the test split has only {len(test_ds.x)} rows")


def _sample_from_state(config: ExperimentConfig, ex: _Experiment, state,
                       test_ds) -> dict[str, Any]:
    """``sample_tokens`` N: greedy-decode N tokens per prompt from the
    trained model (``models.gpt.generate``, the KV-cache sampler), one
    prompt of ``sample_prompt_len`` test tokens per data shard, as JAX takes
    them (a pipeline decodes them through ``PipelineEngine.generate``).
    Over more than one rank ``generate`` takes the run's mesh, as JAX's
    does (``harness.py:2179``): each data rank decodes its prompts (a MoE
    model every prompt) and every rank returns them all; a model cut over
    'model' decodes Megatron-cut (TP decode).  The parameters are the
    engine's ``eval_params`` (the consensus under async and gossip, the
    experts gathered under EP and the composites).  Greedy, so the
    continuation is a function of the parameters.  Arguments were checked
    before training."""
    from distributed_tensorflow_tpu_torch.models.gpt import generate

    prompts = np.asarray(test_ds.x[:ex.n, :config.sample_prompt_len],
                         dtype=np.int32)
    if _is_pipeline(ex.engine):
        # prompt and continuation: kept to the continuation, the samples'
        # one schema (JAX harness.py:2167-2175)
        full = ex.engine.generate(state, prompts, config.sample_tokens)
        return {"sample_prompts": prompts.tolist(),
                "samples": full[:, config.sample_prompt_len:].tolist()}
    toks = generate(ex.engine.eval_params(state), None, prompts,
                    config.sample_tokens, greedy=True,
                    device=ex.engine.device,
                    mesh=ex.mesh if ex.mesh.world_size > 1 else None)
    return {"sample_prompts": prompts.tolist(),
            "samples": toks.cpu().tolist()}


def _resolve_serve_kv_dtype(name: str):
    """``serve_kv_dtype``: a float dtype name (``models.resolve_dtype``)
    or ``'int8'``, the quantized table."""
    if name == "int8":
        return "int8"
    try:
        return modellib.resolve_dtype(name)
    except KeyError:
        raise ValueError(
            f"--serve-kv-dtype '{name}' unknown: float32/bfloat16/"
            f"float16 (and aliases) or int8") from None


def _validate_serving(config: ExperimentConfig, ex: _Experiment,
                      test_ds) -> None:
    """Every ``serve_requests`` failure that can be known is raised before
    training (JAX ``_validate_serving``; its fleet checks are ``run``'s
    ``_reject_fleet`` here)."""
    if config.serve_requests < 0:
        raise ValueError(
            f"--serve must be positive, got {config.serve_requests}")
    if config.serve_slots < 1:
        raise ValueError(
            f"--serve-slots must be positive, got {config.serve_slots}")
    if config.serve_max_new < 1:
        raise ValueError(
            f"--serve-max-new must be positive, got {config.serve_max_new}")
    if _is_pipeline(ex.engine):
        raise ValueError(
            "--serve needs flat GPTLM params for the slot KV cache; a "
            "pipeline engine's stage params are pipe-stacked — train "
            "without -pp (or restore the checkpoint into a non-pipeline "
            "layout) to serve")
    model = _gpt_model(ex)
    if model is None:
        raise ValueError(
            f"--serve requires the GPT causal LM; the resolved model is "
            f"{type(ex.engine.model).__name__}")
    if config.serve_prefill_chunk < 0:
        raise ValueError(
            f"--serve-prefill-chunk must be >= 0 (0 = monolithic "
            f"prefill), got {config.serve_prefill_chunk}")
    if config.serve_prefix_cache < 0:
        raise ValueError(
            f"--serve-prefix-cache must be >= 0 (0 = off), got "
            f"{config.serve_prefix_cache}")
    if config.serve_prefix_block < 1:
        raise ValueError(
            f"--serve-prefix-block must be positive, got "
            f"{config.serve_prefix_block}")
    if config.serve_shared_prefix < 0:
        raise ValueError(
            f"--serve-shared-prefix must be >= 0, got "
            f"{config.serve_shared_prefix}")
    if config.serve_slo_ttft <= 0 or config.serve_slo_itl <= 0:
        raise ValueError(
            f"--serve-slo-ttft/--serve-slo-itl must be positive seconds, "
            f"got {config.serve_slo_ttft}/{config.serve_slo_itl}")
    if config.serve_queue_cap < 0:
        raise ValueError(
            f"--serve-queue-cap must be >= 0 (0 = unbounded admission), "
            f"got {config.serve_queue_cap}")
    if config.serve_draft_k < 1:
        raise ValueError(
            f"--serve-draft-k must be positive, got "
            f"{config.serve_draft_k}")
    if config.serve_draft_config is not None:
        parse_draft_config(config.serve_draft_config)
    if config.serve_kv_dtype:
        _resolve_serve_kv_dtype(config.serve_kv_dtype)
    if config.serve_kv_layout not in ("monolithic", "paged"):
        raise ValueError(
            f"--serve-kv-layout must be 'monolithic' or 'paged', got "
            f"{config.serve_kv_layout!r}")
    if config.serve_paged_block < 0 or config.serve_paged_blocks < 0:
        raise ValueError(
            f"--serve-paged-block/--serve-paged-blocks must be >= 0, got "
            f"{config.serve_paged_block}/{config.serve_paged_blocks}")
    if config.serve_kv_layout != "paged" and (config.serve_paged_block
                                              or config.serve_paged_blocks):
        raise ValueError(
            "--serve-paged-block/--serve-paged-blocks need "
            "--serve-kv-layout paged")
    if config.serve_kv_layout == "paged":
        # the block must tile max_len, and with the prefix pool on it
        # must be the pool's block (hits alias physical blocks)
        block = config.serve_paged_block or config.serve_prefix_block
        if model.max_len % block:
            raise ValueError(
                f"--serve-paged-block {block} must divide the model's "
                f"max_len={model.max_len}")
        if (config.serve_prefix_cache and config.serve_paged_block
                and config.serve_paged_block != config.serve_prefix_block):
            raise ValueError(
                f"--serve-paged-block ({config.serve_paged_block}) must "
                f"equal --serve-prefix-block "
                f"({config.serve_prefix_block}) when the prefix pool is "
                f"on: pool hits alias physical blocks")
    if config.serve_multi_step is not None and config.serve_multi_step < 1:
        raise ValueError(
            f"--serve-multi-step must be >= 1 fused decode iterations "
            f"per dispatch, got {config.serve_multi_step}")
    plen = config.serve_prompt_len
    if plen < 1 or plen > test_ds.x.shape[1]:
        raise ValueError(
            f"--serve-prompt-len {plen} outside the test sequences' "
            f"length {test_ds.x.shape[1]}")
    total_prompt = plen + config.serve_shared_prefix
    if total_prompt + config.serve_max_new > model.max_len:
        raise ValueError(
            f"--serve-shared-prefix {config.serve_shared_prefix} + "
            f"--serve-prompt-len {plen} + --serve-max-new "
            f"{config.serve_max_new} exceeds the model's capacity "
            f"max_len={model.max_len}")


def _serve_mesh(config: ExperimentConfig, ex: _Experiment):
    """The mesh the serve table takes (JAX ``harness.py:2462-2470``): the
    run's, where it has more than one rank, its axes are a subset of
    {data, model} and ``serve_slots`` divides by 'data'; else None
    (replicated)."""
    mesh = ex.mesh
    if (mesh.world_size > 1
            and set(mesh.axis_names) <= {meshlib.DATA_AXIS,
                                         meshlib.MODEL_AXIS}
            and config.serve_slots
            % mesh.shape.get(meshlib.DATA_AXIS, 1) == 0):
        return mesh
    return None


def _roofline(config: ExperimentConfig, ex: _Experiment, total: int):
    """``--roofline``: the card's peaks (looked up by its name; None on
    the CPU or an unknown card), the run's device count and the engine's
    analytic cost model (None for a non-GPT model), in the model's
    compute dtype (JAX ``harness.py:1783-1800``)."""
    from distributed_tensorflow_tpu_torch.observability.roofline import (
        Roofline, _dtype_key, device_peaks)

    dev = ex.engine.device
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return Roofline(device_peaks(kind), total, ex.engine.roofline_model(),
                    _dtype_key(getattr(ex.engine.model, "dtype",
                                       "float32")))


def _serve_from_state(config: ExperimentConfig, ex: _Experiment, state,
                      test_ds, tracer=None, should_stop=None,
                      timeline=None, ledger=None, roofline=None,
                      total_devices: int = 1) -> dict[str, Any]:
    """``serve_requests`` N: a continuous-batching window over the trained
    model (``SlotKVCache`` + ``ContinuousBatcher``, JAX
    ``_serve_from_state``); returns the run report's ``serve`` section
    (``observability.serve_section``).

    The table is built over the engine's ``eval_params`` (the consensus
    under async and gossip), whose decode runs without dropout, on this
    rank's device.  JAX's rule (``harness.py:2462-2470``) picks the layout:
    where the run's mesh has no axis but 'data' and 'model' and the slots
    divide by 'data', the table takes the mesh (``_serve_mesh``: after -tp
    and fsdp×tp a TP table, the model's Megatron cut kept); otherwise
    (tp×sp, ep×tp, ep×tp×sp) it serves the whole model, replicated: a bound
    model's unbound twin (``GPTLM.unbound``) holding its gathered leaves,
    as the pipeline's twins are built.  A run of one rank serves without a
    mesh, as in JAX (-tp 1 trains on the sync path, so ``cli.main`` reaches
    a TP table only over more than one rank).  The draft table takes the
    same mesh (JAX ``:2556``).  Every rank drives its table alike, so each
    makes the same host decisions.  Prompts are test rows
    (``serve_prompt_len`` tokens each, wrapping past the split), behind a
    seeded shared prefix of ``serve_shared_prefix`` tokens; every arrival
    is at 0, so the queue drains as slots free.  Greedy decode on the wall
    clock, under an ``SLOMonitor`` (``serve_slo_ttft``/``serve_slo_itl``),
    so the section carries ``serve_goodput_under_slo`` and ``slo``.  A
    draft of ``'key=int,...'`` sizes is a fresh GPT drawn from
    ``torch.Generator().manual_seed(seed)``: flax's initialization cannot
    be reproduced, so its accept rate is the port's own, while greedy
    acceptance keeps the streams those of plain decode.  ``tracer`` spans
    the window as ``serve`` and reaches the batcher (its request, prefill
    and decode spans); ``should_stop`` is the lease's drain and
    ``timeline`` the gauge sampler (JAX ``harness.py:2646-2657``).
    ``ledger`` reaches the target table; with ``roofline`` the batcher
    gets one rebuilt from that table (``Roofline.for_kv``: its storage
    dtype and layout), on the same card and ``total_devices``."""
    from distributed_tensorflow_tpu_torch.observability import (
        NULL_TRACER, SLOMonitor, serve_section)
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, Request, SlotKVCache)

    model = ex.engine.eval_params(state)
    device = ex.engine.device
    mesh = _serve_mesh(config, ex)
    if mesh is None and model.tp_mesh is not None:
        # the whole model, replicated: the unbound twin holding the
        # gathered leaves (a collective: every rank calls it)
        twin = model.unbound()
        twin.load_state_dict(ex.engine.full_state_dict(state))
        model = twin
    kv_kwargs: dict[str, Any] = dict(
        kv_dtype=(_resolve_serve_kv_dtype(config.serve_kv_dtype)
                  if config.serve_kv_dtype else None),
        prefix_cache_blocks=config.serve_prefix_cache,
        prefix_block=config.serve_prefix_block, device=device, mesh=mesh,
        ledger=ledger)
    if config.serve_kv_layout == "paged":
        kv_kwargs.update(kv_layout="paged",
                         paged_blocks=config.serve_paged_blocks,
                         paged_block=config.serve_paged_block)
    kv = SlotKVCache(model, None, config.serve_slots, **kv_kwargs)
    serve_roofline = None
    if roofline is not None:
        from distributed_tensorflow_tpu_torch.observability.roofline import (
            Roofline)

        serve_roofline = Roofline.for_kv(
            kv, roofline.peaks.device_kind if roofline.peaks else None,
            total_devices)
    draft_kv = None
    if config.serve_draft_config:
        overrides = parse_draft_config(config.serve_draft_config)
        if overrides is None:
            draft = model
        else:
            draft = modellib.create_model(
                "gpt", num_classes=int(model.vocab_size),
                max_len=int(model.max_len), dropout_rate=0.0,
                dtype=model.dtype, device=device, **overrides)
            draft.reset_parameters(
                torch.Generator().manual_seed(config.seed))
        draft_kv = SlotKVCache(draft, None, config.serve_slots,
                               device=device, mesh=mesh)
    rows = np.asarray(test_ds.x, np.int32)
    plen = config.serve_prompt_len
    shared = np.zeros(0, np.int32)
    if config.serve_shared_prefix:
        shared = np.random.default_rng(config.seed).integers(
            0, int(model.vocab_size),
            config.serve_shared_prefix).astype(np.int32)
    requests = [
        Request(rid=i,
                prompt=np.concatenate([shared, rows[i % len(rows), :plen]]),
                max_new_tokens=config.serve_max_new, arrival_s=0.0)
        for i in range(config.serve_requests)]
    batcher_kwargs: dict[str, Any] = {}
    if config.serve_multi_step is not None:
        batcher_kwargs.update(multi_step=config.serve_multi_step)
    if timeline is not None:
        batcher_kwargs.update(timeline=timeline)
    if serve_roofline is not None:
        batcher_kwargs.update(roofline=serve_roofline)
    tracer = tracer if tracer is not None else NULL_TRACER
    with tracer.span("serve", requests=config.serve_requests,
                     slots=config.serve_slots):
        summary = ContinuousBatcher(
            kv, tracer=tracer, prefill_chunk=config.serve_prefill_chunk,
            slo=SLOMonitor(config.serve_slo_ttft, config.serve_slo_itl),
            queue_cap=config.serve_queue_cap, should_stop=should_stop,
            draft_kv=draft_kv, draft_k=config.serve_draft_k,
            **batcher_kwargs).run(requests)
    return serve_section(summary, ex.n, tracer=tracer)
