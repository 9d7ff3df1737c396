"""CLI/launcher, flag-compatible with the reference's initializer.py (port
of ``cli.py``).

Reference surface (reference initializer.py:72-114):
  -m/--mode {c,centralized,d,decentralized}   -cs {sync,async}
  -ds {keras,graph,custom}   -n N   -b B   -tt {server,worker}   -ti I
  -sa ADDR   -ca {y,n}

Mapping to engines (``select_engine``, as the JAX CLI maps them):

  -m c  -cs sync    → sync engine       (ported)
  -m d  -ds keras   → allreduce engine  (ported: the same engine)
  -m t/tpu_pod      → sync engine       (ported)
  -m c  -cs async   → async engine      (ported; --sync-every)
  -m d  -ds graph   → gossip engine     (ported; -d/--degree)
  -m d  -ds custom  → gossip engine     (ported; -d/--degree)
  -m d  -ds fsdp    → fsdp engine       (ported: ZeRO-3 sharding)

``-n N`` runs N ranks, one device each, as the reference runs one process
per node (reference initializer.py:134-145): N > 1 spawns N processes
over a free localhost port (``torch.multiprocessing.spawn``); N = 1 runs
in this process, still through a process group of size 1, so the
gradient all-reduce runs on NCCL on the card and on gloo on the CPU.
``-b`` is the per-worker batch, so the global batch is b × n.  ``-ca`` is
accepted and ignored.  ``-tt/-ti/-sa`` become ``init_process_group``
coordinates for a run across machines: the server is process 0, worker i
is process i + 1; a process that already belongs to a process group (a
launcher's) runs as its rank.  ``--device cpu`` runs on the CPU (gloo);
the default is the CUDA card, and without one the run raises.  Only rank
0 prints the summary and reports to the supervisor.  The models' f32 math
runs in full f32 (the harness turns TF32 off for the run); ``--precision``
picks a mixed-precision policy (``parallel/precision.py``).
``-sp S`` shards each sequence over S of the ranks (a (data, seq) mesh
of (N / S, S) ranks; ``--attention ring|ring_flash|ulysses|ulysses_flash``
picks the schedule); ``-ep E`` shards the experts of ``--model moe`` over
E of the ranks (a (data, expert) mesh of (N / E, E) ranks, with
``--num-experts``, ``--aux-weight``, ``--router-top-k`` and
``--router-z-weight``); ``-tp T`` shards the model Megatron-style over T
of the ranks (a (data, model) mesh of (N / T, T) ranks; the MLP names
train ``TPMLP``, a sequence model its ``partition_model`` layout with
dense attention), and under ``-m d -ds fsdp`` makes fsdp × tp; ``-pp P``
pipelines the model over P of the ranks (a (data, pipe) mesh of (N / P,
P) ranks, ``--microbatches``, ``--pipeline-schedule gpipe|1f1b``, and
``--pipeline-hidden`` the stages' width: the built-in MLP stages for
``--model mlp``, the GPT's or BERT's stage families).  Two or more of
``-tp``, ``-sp``, ``-ep`` and ``-pp`` make a composite (``-tp × -sp``,
``-ep × -tp``, ``-ep × -sp``, ``-ep × -tp × -sp``, ``-pp × -tp``, ``-pp
× -sp``, ``-pp × -tp × -sp``, and ``-pp × -ep`` with or without ``-tp``
and ``-sp``: ``harness._COMBOS``); under ``-pp`` with ``-ep`` the GPT's
or BERT's stage blocks carry the routed MoE FFN (``--num-experts``,
``--router-top-k``, ``--aux-weight``, ``--router-z-weight``).
``--lr-schedule``/``--warmup-steps``/``--weight-decay``/``--clip-norm``
build the optimizer recipe, ``--positional``/``--kv-heads`` reach the GPT,
and after training a GPT ``--sample N`` decodes test prompts and ``--serve
N`` serves a window of requests (``--serve-*``), after a run with a
'model' axis too (TP decode: ``--sample`` over the run's mesh, ``--serve``
on a table cut over 'model' after ``-tp`` and fsdp×tp, on the whole
model after the other ``-tp`` composites); the fleet's serve flags parse
and raise.  ``--checkpoint-dir D`` writes checkpoints
(``--checkpoint-every``, ``--async-checkpoint``), ``--resume`` and
``--elastic-restore`` continue from the latest, ``--watchdog-timeout``
and ``--watchdog-abort`` watch for stalls, and ``--max-restarts N``
restarts a crashed run from its latest checkpoint (with ``-n`` > 1 the
spawn of every rank is relaunched).  A checkpointed run drains on SIGTERM
or after ``--max-steps-per-lease`` steps (the final checkpoint, the
reason in ``preempted``; ``--elastic-restore`` continues it), the
launcher of ``-n`` > 1 ranks forwarding the signal to them.
``--metrics-path``, ``--trace``, ``--timeline`` (``--timeline-interval``)
and ``--profile-dir`` write per-step metrics, a span trace, gauge series
and a ``torch.profiler`` trace, none of which changes a loss or a token.  ``--grad-compression
{none,bf16,int8}`` sends the gradient (async, gossip: parameter) exchange
through a codec, and ``--grad-bucket-mb MB`` reduces it in ~MB buckets as
the backward pass produces them (``parallel/overlap.py``).

    python -m distributed_tensorflow_tpu_torch.cli -m c -cs sync -n 1 -b 32 \\
        --model cnn --dataset mnist
    python -m distributed_tensorflow_tpu_torch.cli -m c -cs sync -n 1 -b 8 \\
        --model gpt --dataset lm_synth --attention flash --sample 8 \\
        --serve 8 --serve-kv-layout paged
    python -m distributed_tensorflow_tpu_torch.cli --device cpu -n 4 -sp 2 \\
        -b 4 --model gpt_tiny --dataset lm_synth --attention ring_flash
    python -m distributed_tensorflow_tpu_torch.cli --device cpu -n 4 -ep 2 \\
        --model moe --dataset synthetic
    python -m distributed_tensorflow_tpu_torch.cli --device cpu -m d \\
        -ds fsdp -n 4 -tp 2 --model mlp --dataset synthetic
    python -m distributed_tensorflow_tpu_torch.cli --device cpu -tp 2 -n 4 \\
        -b 4 --model gpt_tiny --dataset lm_synth --sample 4 --serve 4 \\
        --serve-kv-layout paged
    python -m distributed_tensorflow_tpu_torch.cli --device cpu -pp 2 -n 4 \\
        --microbatches 2 --model mlp --dataset synthetic
    python -m distributed_tensorflow_tpu_torch.cli --device cpu -n 8 -pp 2 \\
        -ep 2 --microbatches 2 --pipeline-hidden 32 -b 4 --model gpt \\
        --dataset lm_synth --num-experts 4
    python -m distributed_tensorflow_tpu_torch.cli --device cpu -n 1 -e 2 \\
        --model mlp --dataset synthetic --checkpoint-dir /tmp/ck \\
        --checkpoint-every 100 --max-restarts 1
    python -m distributed_tensorflow_tpu_torch.cli -m c -cs sync -n 1 -b 8 \
        --model gpt --dataset lm_synth --attention flash \
        --grad-compression int8 --grad-bucket-mb 4
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import tempfile
import threading

import torch

from distributed_tensorflow_tpu_torch.engines import check_engine
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.utils import failure
from distributed_tensorflow_tpu_torch.utils.harness import (
    ExperimentConfig, _reject_flash_under_sp, check_codec_config,
    check_parallel_factors, run)

def parse_model_args(pairs: list[str]) -> dict:
    """KEY=VALUE list → kwargs dict with literal-ish value parsing."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise argparse.ArgumentTypeError(
                f"--model-arg expects KEY=VALUE, got '{pair}'")
        k, v = pair.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            for cast in (int, float):
                try:
                    out[k] = cast(v)
                    break
                except ValueError:
                    continue
            else:
                out[k] = v
    return out


def str2bool(v: str) -> bool:
    """Parity with the reference's str2bool (reference initializer.py:59-67)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_tensorflow_tpu_torch",
        description="data-parallel training on torch.distributed "
                    "(reference-flag compatible)")
    p.add_argument("-m", "--mode", default="tpu_pod",
                   choices=["c", "centralized", "d", "decentralized", "t",
                            "tpu_pod"])
    p.add_argument("-cs", "--centralized_strategy", default="sync",
                   choices=["sync", "async"])
    p.add_argument("-ds", "--decentralized_strategy", default="keras",
                   choices=["keras", "graph", "custom", "sync", "fsdp"])
    p.add_argument("-n", "--number_nodes", type=int, default=None,
                   help="ranks, one device each (default: every visible "
                        "CUDA card; 1 with --device cpu)")
    p.add_argument("-b", "--batch_size", type=int, default=32,
                   help="per-worker batch; global batch = b × n")
    p.add_argument("-tt", "--task_type", default=None,
                   choices=["server", "worker"],
                   help="multi-machine role (server == process 0)")
    p.add_argument("-ti", "--task_index", type=int, default=0)
    p.add_argument("-sa", "--server_address", default=None,
                   help="process 0's address host:port for a multi-machine "
                        "run")
    p.add_argument("-ca", "--cpu_affinity", type=str2bool, nargs="?",
                   const=True, default=False,
                   help="accepted for compatibility; no-op")
    p.add_argument("--model", default="mlp", help="registered model name "
                   "(mlp|cnn|resnet20|gpt|bert_tiny|moe)")
    p.add_argument("--dataset", default="mnist",
                   help="mnist|fashion_mnist|cifar10|synthetic|glue_synth|"
                        "lm_synth")
    p.add_argument("-e", "--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine", "linear"],
                   help="LR schedule over epochs × steps-per-epoch; combine "
                        "with --warmup-steps for a linear ramp from 0")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear LR warmup steps (0 disables)")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help=">0: AdamW decoupled weight decay (matmul kernels "
                        "only: no biases, norms or embedding tables)")
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help=">0: clip gradients to this global norm before the "
                        "update")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches accumulated per optimizer step")
    p.add_argument("--sync-every", type=int, default=10,
                   help="async engine: parameter-averaging period")
    p.add_argument("-d", "--degree", type=int, default=1,
                   help="gossip neighbor degree (the reference's "
                        "commented-out -d flag, initializer.py:90-92)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-machine: total process count")
    p.add_argument("-sp", "--seq-parallel", type=int, default=1,
                   help="shard sequences over this many of the -n ranks "
                        "(long-context mode; requires a sequence model, "
                        "e.g. --model bert_tiny or gpt)")
    p.add_argument("-tp", "--tensor-parallel", type=int, default=1,
                   help="tensor parallelism: shard the model Megatron-style "
                        "over this many of the -n ranks (a (data, model) "
                        "mesh); with -m d -ds fsdp, fsdp×tp")
    p.add_argument("-pp", "--pipeline-parallel", type=int, default=1,
                   help="shard model stages over this many devices "
                        "(GPipe-style microbatched pipeline)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches per step (bubble = (S-1)/(M+S-1))")
    p.add_argument("--pipeline-schedule", default="gpipe",
                   choices=["gpipe", "1f1b"],
                   help="gpipe: all-fwd-then-all-bwd (AD through the scan); "
                        "1f1b: interleaved fwd/bwd with a fixed S-slot "
                        "activation stash (PipeDream-flush)")
    p.add_argument("--pipeline-hidden", type=int, default=128,
                   help="pipeline stage hidden width")
    p.add_argument("-ep", "--expert-parallel", type=int, default=1,
                   help="shard MoE experts over this many devices "
                        "(GShard/Switch-style EP; --model moe)")
    p.add_argument("--num-experts", type=int, default=8,
                   help="MoE expert count (must divide by -ep)")
    p.add_argument("--aux-weight", type=float, default=0.01,
                   help="MoE load-balance auxiliary loss weight")
    p.add_argument("--router-top-k", type=int, default=1, choices=[1, 2],
                   help="MoE routing: 1 = Switch top-1, 2 = GShard top-2 "
                        "(renormalized gates, priority capacity positions)")
    p.add_argument("--router-z-weight", type=float, default=0.0,
                   help="MoE router z-loss weight (0 disables; ~1e-3 "
                        "stabilizes router logits on long runs)")
    p.add_argument("--attention", default="ring",
                   choices=["ring", "ring_flash", "ulysses", "ulysses_flash",
                            "flash"],
                   help="attention strategy: ring/ring_flash/ulysses/"
                        "ulysses_flash shard the sequence over -sp devices "
                        "(the *_flash variants run the flash kernels as the "
                        "local math inside the ring / Ulysses schedule); "
                        "flash = the single-device flash kernels (sequence "
                        "models).  Without -sp the *_flash values run the "
                        "flash kernels and ring/ulysses leave the model "
                        "dense")
    p.add_argument("--positional", default="learned",
                   choices=["learned", "rope"],
                   help="GPT position encoding: learned table | RoPE "
                        "(rotary, no table: q/k rotated by position)")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="GPT grouped-query attention: K/V head count "
                        "(< heads; 1 = multi-query).  Shrinks the decode "
                        "KV cache by heads/kv_heads")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing: store each transformer "
                        "block's input only, recompute the block in "
                        "backward (~K x less activation memory for ~1/3 "
                        "more FLOPs).  The long-context memory lever.  "
                        "Sequence models only")
    _serve_flags(p)
    p.add_argument("--model-arg", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="extra model constructor field (repeatable)")
    p.add_argument("--precision", default="f32",
                   choices=["f32", "bf16", "bf16-f32master",
                            "fp16-f32master"],
                   help="end-to-end mixed-precision policy "
                        "(parallel/precision.py): parameter storage, "
                        "compute and gradient-reduce dtypes.  bf16: "
                        "parameters and optimizer state in bfloat16.  "
                        "bf16-f32master: bfloat16 parameters with a "
                        "float32 master copy in the optimizer.  "
                        "fp16-f32master: float16 + master + dynamic loss "
                        "scaling (sync/allreduce, fsdp and -tp)")
    p.add_argument("--grad-compression", default="none",
                   choices=["none", "bf16", "int8"],
                   help="compress the cross-rank gradient/parameter "
                        "exchange (parallel/compression.py): bf16 halves "
                        "the collective wire bytes (the exchange runs in "
                        "bf16, widened after), int8 quarters them "
                        "(per-leaf scale + stochastic rounding, f32 "
                        "master values kept); none is the plain exchange. "
                        " Sync, async, gossip, fsdp, -tp, -sp and -ep (the "
                        "last four as an encode/decode after the exact "
                        "reduce)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="kernel build cache directory: the hand-written "
                        "CUDA kernels (ops/_build.py) are built with nvcc "
                        "into DIR and loaded from there by repeat runs.  "
                        "XLA's persistent compilation cache has no other "
                        "torch counterpart: the port compiles nothing else")
    p.add_argument("--grad-bucket-mb", type=float, default=0.0,
                   metavar="MB",
                   help="communication/compute overlap: cut the gradients "
                        "into ~MB buckets in reverse parameter order "
                        "(parallel/overlap.py) and reduce each, through "
                        "--grad-compression's codec, as soon as the "
                        "backward pass has produced it: post-accumulate "
                        "hooks, on a side stream on the card (no XLA "
                        "scheduler flags; with --grad-accum K > 1 each "
                        "microbatch's buckets are reduced as its backward "
                        "produces them).  ~4 recommended; 0 (default) is "
                        "the unbucketed exchange.  The run measures and "
                        "reports the exposed-vs-hidden collective split "
                        "(grad_collective_exposed_s)")
    p.add_argument("--dtype", default="float32",
                   help="model compute dtype (float32|bfloat16|float16); "
                        "a non-f32 --precision sets it")
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="drain chunk: steps dispatched back to back per "
                        "host read (default auto: 8)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches staged on the device ahead of the step")
    p.add_argument("--result-path", default=None,
                   help="JSONL event sink path")
    p.add_argument("--supervisor", default=None, metavar="HOST[:PORT]",
                   help="report the reference's start/done/results triple "
                        "to a supervisor socket (port defaults to 4000)")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="enable TrainState checkpointing to this directory")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between checkpoints (0: final only)")
    p.add_argument("--async-checkpoint", default="on", choices=["on", "off"],
                   dest="async_checkpoint",
                   help="'on' (default): checkpoint saves cost the training "
                        "thread only a snapshot — the device→host copy "
                        "completes, and the atomic write and retention sweep "
                        "run, on a background writer thread, overlapped with "
                        "the next training chunks (at most one save in "
                        "flight; writer errors re-raise at the next "
                        "checkpoint).  'off': the synchronous "
                        "blocking-save path, bit-for-bit — same on-disk "
                        "format, restorable either way")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint before training")
    p.add_argument("--elastic-restore", action="store_true",
                   help="elastic resume (elastic/reshard.py): restore the "
                        "latest checkpoint onto THIS run's ranks — the "
                        "engines whose ranks hold one state onto any rank "
                        "count, local SGD and gossip onto the count that "
                        "wrote them — continue the exact batch "
                        "sequence from the checkpoint's data state "
                        "(exactly-once resume; a checkpoint without one "
                        "restarts the stream with a resume_replay_steps "
                        "warning), and report preemption_lost_s / "
                        "resume_replay_steps in the run report")
    p.add_argument("--watchdog-timeout", type=float, default=0.0,
                   help=">0: detect a stalled step loop (no progress for this "
                        "many seconds PER STEP) and emit a 'stall' event — "
                        "the reference deadlocks silently instead.  Under "
                        "--steps-per-call k the loop beats once per chunk "
                        "and the stall budget scales to k × this value")
    p.add_argument("--watchdog-abort", action="store_true",
                   help="on stall, exit(75) after reporting so a supervisor "
                        "can relaunch with --resume (a wedged CUDA runtime "
                        "cannot be recovered in-process)")
    p.add_argument("--health", default="off", choices=["off", "on"],
                   help="per-step numeric training-health stats, computed "
                        "on the device inside the step (inside a replayed "
                        "chunk too) and stacked through the trajectory "
                        "like the loss: global grad norm, param norm, "
                        "update norm and ratio, non-finite parameter "
                        "count, loss-spike score vs a running EMA "
                        "(observability/health.py).  They ride "
                        "--metrics-path records and feed --on-anomaly; "
                        "'off' (default) runs the step without them")
    p.add_argument("--on-anomaly", default="warn", choices=["warn", "halt"],
                   dest="on_anomaly",
                   help="with --health on: response to a per-step health "
                        "anomaly (non-finite params/grads, update-ratio "
                        "ceiling, loss spike) — 'warn' records structured "
                        "anomaly trace events and a health summary, "
                        "'halt' additionally stops at the offending step. "
                        " Subsumes the loss-only nan guard")
    p.add_argument("--no-nan-guard", action="store_true",
                   help="disable the fatal divergence (NaN/inf) response: "
                        "without --health, skips the legacy loss-only "
                        "check; with --health on + --on-anomaly warn, "
                        "downgrades nonfinite anomalies (which stay fatal "
                        "by default) to record-and-continue")
    p.add_argument("--max-steps-per-lease", type=int, default=0,
                   metavar="N",
                   help="graceful lease drain (elastic/lease.py): stop at "
                        "the first chunk boundary at/after N steps, write "
                        "the final checkpoint (data state included) and "
                        "exit with a structured `preempted` report "
                        "section — relaunch with --elastic-restore to "
                        "continue.  Checkpointed runs also drain on "
                        "SIGTERM (the scheduler's preemption notice) "
                        "whether or not N is set; with -n N > 1 the "
                        "launcher forwards SIGTERM to its ranks and they "
                        "agree on the stop.  Requires --checkpoint-dir")
    p.add_argument("--metrics-path", "--metrics", default=None,
                   dest="metrics_path",
                   help="per-step metrics JSONL path (async crash-durable "
                        "sink; records ride the chunked drain, so this "
                        "does not downshift --steps-per-call)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="structured trace-span JSONL path: a monotonic-"
                        "clock timeline of compile/chunk_dispatch/"
                        "materialize/checkpoint/eval spans plus prefetch "
                        "gauges, with run/host/process ids (other ranks "
                        "write PATH.rankN); span names are also "
                        "torch.profiler regions (in the --profile-dir "
                        "trace) and NVTX ranges")
    p.add_argument("--timeline", action="store_true",
                   help="time-series gauge sampler: chunk step time and "
                        "prefetch depth during training, queue depth / "
                        "slots / KV blocks during --serve, sampled at "
                        "existing loop boundaries (bounded rings, "
                        "self-measured overhead); the run report's "
                        "'timeline' section and bulk timeline_series "
                        "events in the --trace file.  Host-side only: it "
                        "reads no device value the loops do not already "
                        "read")
    p.add_argument("--timeline-interval", type=float, default=0.05,
                   metavar="SECONDS",
                   help="minimum seconds between --timeline samples per "
                        "gauge group (default 0.05; 0 = record every "
                        "boundary crossing)")
    p.add_argument("--roofline", action="store_true",
                   help="roofline efficiency accounting: an analytic model "
                        "FLOPs/bytes cost model and the card's data-sheet "
                        "peaks (the H100 SXM: 989 TFLOP/s bf16/fp16, 67 "
                        "f32 on the CUDA cores, 3.35 TB/s HBM) → train_mfu "
                        "in the run report, serve_prefill_mfu / "
                        "serve_decode_mbu on the serve summary, and a "
                        "per-program attribution table in the run report "
                        "('roofline' section; renders offline via the "
                        "port's `analyze roofline`).  On an unknown card "
                        "utilizations report null — a peak is never "
                        "invented.  Host-side only; arms the program "
                        "ledger")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the fit "
                        "(CPU and CUDA activity) here")
    p.add_argument("--max-restarts", type=int, default=0,
                   help=">0: on crash, restart from the latest checkpoint up "
                        "to N times (requires --checkpoint-dir + "
                        "--checkpoint-every); with -n N > 1 the N ranks are "
                        "relaunched together")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (NCCL) or cpu (gloo)")
    return p


def _serve_flags(p: argparse.ArgumentParser) -> None:
    """--sample and the --serve window's flags (the JAX CLI's).  The
    fleet's flags parse, and raise NotImplementedError at any value but
    their default (ROADMAP Queue 1: fleet)."""
    p.add_argument("--sample", type=int, default=0, metavar="N",
                   help="after training a GPT LM, greedy-decode N tokens "
                        "per prompt from the final parameters (KV-cache "
                        "sampler) and record prompts and continuations "
                        "in the summary")
    p.add_argument("--sample-prompt-len", type=int, default=8,
                   help="prompt tokens taken from the test split per "
                        "sampled row (--sample)")
    p.add_argument("--serve", type=int, default=0, metavar="N",
                   help="after training a GPT LM, serve N requests through "
                        "the slot KV cache and the continuous batcher "
                        "(serving/); the summary gains a 'serve' section "
                        "(requests/s per chip, TTFT/ITL percentiles, "
                        "goodput under the SLO)")
    p.add_argument("--serve-slots", type=int, default=4,
                   help="--serve: KV slot table size (requests decoded "
                        "at once)")
    p.add_argument("--serve-max-new", type=int, default=16,
                   help="--serve: tokens generated per request")
    p.add_argument("--serve-prompt-len", type=int, default=8,
                   help="--serve: prompt tokens taken from the test split "
                        "per request")
    p.add_argument("--serve-kv-dtype", default=None,
                   choices=["float32", "f32", "bfloat16", "bf16", "int8"],
                   help="--serve: KV table storage dtype (default: the "
                        "model's dtype).  bfloat16 halves the KV bytes "
                        "per slot; int8 halves them again (int8 K/V with "
                        "one f32 scale per written vector)")
    p.add_argument("--serve-draft-config", default=None, metavar="SPEC",
                   help="--serve: speculative decoding with a draft GPT "
                        "proposing --serve-draft-k tokens per live slot; "
                        "greedy acceptance keeps the streams those of "
                        "plain decode.  SPEC is 'self' (the served model) "
                        "or 'hidden=64,layers=1,...' GPT size overrides "
                        "(vocab/max_len inherited, weights drawn from "
                        "--seed)")
    p.add_argument("--serve-draft-k", type=int, default=4, metavar="K",
                   help="--serve-draft-config: draft tokens proposed per "
                        "verify round")
    p.add_argument("--serve-prefill-chunk", type=int, default=0,
                   metavar="T",
                   help="--serve: chunked prefill token budget: admissions "
                        "prefill in chunks of at most T tokens, one chunk "
                        "per decode iteration.  0 = monolithic prefill")
    p.add_argument("--serve-prefix-cache", type=int, default=0,
                   metavar="BLOCKS",
                   help="--serve: prefix-cache pool capacity in KV blocks "
                        "(block-granular prompt prefix reuse, LRU).  "
                        "0 = off")
    p.add_argument("--serve-prefix-block", type=int, default=16,
                   metavar="T",
                   help="--serve: tokens per prefix-cache block")
    p.add_argument("--serve-kv-layout", default="monolithic",
                   choices=["monolithic", "paged"],
                   help="--serve: KV storage layout.  'paged': one "
                        "refcounted physical block pool with per-slot "
                        "block tables (prefix hits alias blocks, "
                        "copy-on-write) read by the paged attention "
                        "kernel at every decode step")
    p.add_argument("--serve-paged-block", type=int, default=0,
                   metavar="T",
                   help="--serve-kv-layout paged: tokens per physical "
                        "block.  0 inherits --serve-prefix-block; with "
                        "the prefix pool on the two must agree")
    p.add_argument("--serve-paged-blocks", type=int, default=0,
                   metavar="N",
                   help="--serve-kv-layout paged: block pool capacity.  "
                        "0 sizes it so that it never runs out; a smaller "
                        "pool defers admissions")
    p.add_argument("--serve-shared-prefix", type=int, default=0,
                   metavar="T",
                   help="--serve: prepend a fixed T-token synthetic system "
                        "prompt to every request (seeded by --seed)")
    p.add_argument("--serve-slo-ttft", type=float, default=2.0,
                   metavar="S",
                   help="--serve: TTFT SLO target in seconds; a request is "
                        "goodput only when it meets this and the ITL "
                        "target (serve_goodput_under_slo)")
    p.add_argument("--serve-slo-itl", type=float, default=0.5,
                   metavar="S",
                   help="--serve: inter-token-latency SLO target in "
                        "seconds, judged at each request's own p99 gap")
    p.add_argument("--serve-queue-cap", type=int, default=0, metavar="N",
                   help="--serve: bounded admission: cap the arrived but "
                        "unadmitted backlog at N requests and shed the "
                        "excess (0 = admit everything)")
    p.add_argument("--serve-multi-step", type=int, default=None,
                   metavar="K",
                   help="--serve: fuse K decode iterations into one "
                        "dispatch (one CUDA graph replay on the card), "
                        "pipelined one round ahead; greedy streams are "
                        "those of K = 1")
    fleet = " (serving fleet: not ported, raises)"
    p.add_argument("--serve-replicas", type=int, default=1, metavar="N",
                   help="--serve: replicas behind a router" + fleet)
    p.add_argument("--serve-fault-spec", default=None, metavar="SPEC",
                   help="--serve: seeded fault injection" + fleet)
    p.add_argument("--serve-watchdog", type=float, default=0.0,
                   metavar="S", help="--serve: replica watchdog" + fleet)
    p.add_argument("--serve-hot-swap", action="store_true",
                   help="--serve: weight hot-swap drill" + fleet)
    p.add_argument("--serve-disaggregate", default=None, metavar="P:D",
                   help="--serve: prefill/decode replicas" + fleet)
    p.add_argument("--serve-routing", default="least-loaded",
                   choices=("least-loaded", "affinity"),
                   help="--serve: fleet routing policy" + fleet)
    p.add_argument("--serve-autoscale", default=None, metavar="MIN:MAX",
                   help="--serve: replica autoscaling" + fleet)


def select_engine(args: argparse.Namespace) -> str:
    if args.mode in ("c", "centralized"):
        return "sync" if args.centralized_strategy == "sync" else "async"
    if args.mode in ("d", "decentralized"):
        if args.decentralized_strategy in ("graph", "custom"):
            return "gossip"
        if args.decentralized_strategy in ("sync", "fsdp"):
            return args.decentralized_strategy
        return "allreduce"
    return "sync"  # tpu_pod


def _rank_main(rank: int, world: int, port: int, config: ExperimentConfig,
               out_path: str) -> None:
    """One spawned rank: join the group, run, and (rank 0) leave the
    summary in ``out_path`` for the launcher."""
    if config.device == "cpu":
        # CPU ranks share the host's cores: without a share each, every
        # rank's intra-op pool takes them all and the ranks thrash
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    meshlib.init_process_group(config.device, world, rank,
                               f"tcp://127.0.0.1:{port}")
    try:
        summary = run(config)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(summary, f)


@contextlib.contextmanager
def _forwarding_sigterm(processes):
    """While the block runs, a SIGTERM to this process is sent on to each
    live process of ``processes`` (the spawned ranks, whose leases drain
    on it); the previous disposition is back after.  Off the main thread
    (no handler can be set there) it does nothing."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def forward(signum, _frame):
        for p in processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    prev = signal.signal(signal.SIGTERM, forward)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def _spawn(config: ExperimentConfig, n: int) -> dict:
    """Run ``config`` on ``n`` spawned ranks; returns rank 0's summary.  A
    rank that diverged (``TrainingDiverged``) raises it here, so crash
    recovery does not restart into the same NaN; any other failed rank
    raises the spawn's error.  With ``checkpoint_dir`` (where each rank
    arms its lease) a SIGTERM to the launcher reaches every rank."""
    meshlib.check_device_count(n, config.device)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "summary.json")
        try:
            ctx = torch.multiprocessing.spawn(
                _rank_main, args=(n, meshlib.free_port(), config, out_path),
                nprocs=n, join=False)
            with (_forwarding_sigterm(ctx.processes) if config.checkpoint_dir
                  else contextlib.nullcontext()):
                while not ctx.join():
                    pass
        except torch.multiprocessing.ProcessRaisedException as e:
            if "TrainingDiverged" in str(e) or "AnomalyDetected" in str(e):
                raise failure.TrainingDiverged(
                    f"a rank diverged:\n{e}") from e
            raise
        with open(out_path) as f:
            return json.load(f)


def main(argv: list[str] | None = None, *, model_fn=None,
         dataset_fn=None) -> dict:
    """CLI entry; prints one JSON summary line and returns the summary.
    ``model_fn``/``dataset_fn`` are the reference's plug-in contract: when
    given they override ``--model``/``--dataset`` (with ``-n`` > 1 they
    must pickle, for the spawned ranks)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        model_args = parse_model_args(args.model_arg)
    except argparse.ArgumentTypeError as bad:
        parser.error(str(bad))
    if (args.task_type is None) != (args.server_address is None):
        parser.error("-tt/--task_type and -sa/--server_address must be "
                     "given together for a multi-host run")
    engine = select_engine(args)
    check_engine(engine)   # before any rank is spawned
    device = None if args.device == "cuda" else "cpu"
    config = ExperimentConfig(
        engine=engine, model=args.model, dataset=args.dataset,
        model_fn=model_fn, dataset_fn=dataset_fn,
        n_devices=args.number_nodes, batch_size=args.batch_size,
        seq_parallel=args.seq_parallel,
        tensor_parallel=args.tensor_parallel,
        pipeline_parallel=args.pipeline_parallel,
        microbatches=args.microbatches,
        pipeline_schedule=args.pipeline_schedule,
        pipeline_hidden=args.pipeline_hidden,
        expert_parallel=args.expert_parallel,
        num_experts=args.num_experts, aux_weight=args.aux_weight,
        router_top_k=args.router_top_k,
        router_z_weight=args.router_z_weight,
        epochs=args.epochs, learning_rate=args.lr,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay, clip_norm=args.clip_norm,
        grad_accum=args.grad_accum, sync_every=args.sync_every,
        degree=args.degree, seed=args.seed, precision=args.precision,
        grad_compression=args.grad_compression,
        grad_bucket_mb=args.grad_bucket_mb,
        dtype=args.dtype, attention_impl=args.attention, remat=args.remat,
        positional=args.positional, kv_heads=args.kv_heads,
        log_every=args.log_every, steps_per_call=args.steps_per_call,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        async_checkpoint=args.async_checkpoint == "on",
        resume=args.resume, elastic_restore=args.elastic_restore,
        watchdog_timeout=args.watchdog_timeout,
        watchdog_abort=args.watchdog_abort, max_restarts=args.max_restarts,
        nan_guard=not args.no_nan_guard, health=args.health,
        on_anomaly=args.on_anomaly, roofline=args.roofline,
        compile_cache=args.compile_cache,
        max_steps_per_lease=args.max_steps_per_lease,
        metrics_path=args.metrics_path, trace_path=args.trace,
        timeline=args.timeline, timeline_interval=args.timeline_interval,
        profile_dir=args.profile_dir,
        prefetch=args.prefetch, result_path=args.result_path,
        supervisor_address=args.supervisor, model_args=model_args,
        device=device, sample_tokens=args.sample,
        sample_prompt_len=args.sample_prompt_len,
        serve_requests=args.serve, serve_slots=args.serve_slots,
        serve_max_new=args.serve_max_new,
        serve_prompt_len=args.serve_prompt_len,
        serve_kv_dtype=args.serve_kv_dtype,
        serve_prefill_chunk=args.serve_prefill_chunk,
        serve_prefix_cache=args.serve_prefix_cache,
        serve_prefix_block=args.serve_prefix_block,
        serve_shared_prefix=args.serve_shared_prefix,
        serve_slo_ttft=args.serve_slo_ttft,
        serve_slo_itl=args.serve_slo_itl,
        serve_queue_cap=args.serve_queue_cap,
        serve_draft_config=args.serve_draft_config,
        serve_draft_k=args.serve_draft_k,
        serve_replicas=args.serve_replicas,
        serve_fault_spec=args.serve_fault_spec,
        serve_hot_swap=args.serve_hot_swap,
        serve_watchdog_s=args.serve_watchdog,
        serve_kv_layout=args.serve_kv_layout,
        serve_paged_block=args.serve_paged_block,
        serve_paged_blocks=args.serve_paged_blocks,
        serve_disaggregate=args.serve_disaggregate,
        serve_routing=args.serve_routing,
        serve_autoscale=args.serve_autoscale,
        serve_multi_step=args.serve_multi_step)
    # before any rank is spawned
    check_codec_config(config)
    check_parallel_factors(config)
    if config.seq_parallel > 1:
        _reject_flash_under_sp(config)
    if args.task_type is not None:
        # one process per machine in the group; rank 0 is the server
        if args.num_processes is None:
            parser.error("a multi-host run needs --num-processes")
        meshlib.multihost_initialize(
            coordinator_address=args.server_address,
            num_processes=args.num_processes,
            process_id=(args.task_index + 1 if args.task_type == "worker"
                        else 0),
            device=device)
    if torch.distributed.is_initialized():
        # this process is a rank of a group already: run as that rank
        summary = run(config)
        if torch.distributed.get_rank() != 0:
            return summary
    else:
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run "
                               "on the CPU")
        n = args.number_nodes or (1 if device == "cpu"
                                  else meshlib.device_count())
        config = dataclasses.replace(config, n_devices=n)
        if n > 1 and config.max_restarts > 0:
            # recovery wraps the spawn: a crashed rank leaves its peers in
            # a collective, so every rank is relaunched together
            summary = failure.run_with_recovery(
                dataclasses.replace(config, max_restarts=0),
                max_restarts=config.max_restarts,
                run_fn=lambda c: _spawn(c, n))
        else:
            summary = _spawn(config, n) if n > 1 else run(config)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
