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
  -m d  -ds fsdp    → fsdp engine       (not ported: raises)

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

    python -m distributed_tensorflow_tpu_torch.cli -m c -cs sync -n 1 -b 32 \\
        --model cnn --dataset mnist
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from distributed_tensorflow_tpu_torch.engines import check_engine
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.utils.harness import (
    ExperimentConfig, run)

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
                   "(mlp|cnn|resnet20|gpt|bert_tiny)")
    p.add_argument("--dataset", default="mnist",
                   help="mnist|fashion_mnist|cifar10|synthetic|glue_synth|"
                        "lm_synth")
    p.add_argument("-e", "--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches accumulated per optimizer step")
    p.add_argument("--sync-every", type=int, default=10,
                   help="async engine: parameter-averaging period")
    p.add_argument("-d", "--degree", type=int, default=1,
                   help="gossip neighbor degree (the reference's "
                        "commented-out -d flag, initializer.py:90-92)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-machine: total process count")
    p.add_argument("--attention", default="ring",
                   choices=["ring", "ring_flash", "ulysses", "ulysses_flash",
                            "flash"],
                   help="attention strategy: ring/ring_flash/ulysses/"
                        "ulysses_flash shard the sequence over -sp devices "
                        "(the *_flash variants run the flash kernels as the "
                        "local math inside the ring / Ulysses schedule); "
                        "flash = the single-device flash kernels (sequence "
                        "models).  Without sequence parallelism (not ported) "
                        "the *_flash values run the flash kernels and ring/"
                        "ulysses leave the model dense")
    p.add_argument("--remat", action="store_true",
                   help="activation checkpointing: store each transformer "
                        "block's input only, recompute the block in "
                        "backward (~K x less activation memory for ~1/3 "
                        "more FLOPs).  The long-context memory lever.  "
                        "Sequence models only")
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
                        "scaling (sync/allreduce only)")
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
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (NCCL) or cpu (gloo)")
    return p


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


def _spawn(config: ExperimentConfig, n: int) -> dict:
    meshlib.check_device_count(n, config.device)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "summary.json")
        torch.multiprocessing.spawn(
            _rank_main, args=(n, meshlib.free_port(), config, out_path),
            nprocs=n, join=True)
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
        epochs=args.epochs, learning_rate=args.lr,
        grad_accum=args.grad_accum, sync_every=args.sync_every,
        degree=args.degree, seed=args.seed, precision=args.precision,
        dtype=args.dtype, attention_impl=args.attention, remat=args.remat,
        log_every=args.log_every, steps_per_call=args.steps_per_call,
        prefetch=args.prefetch, result_path=args.result_path,
        supervisor_address=args.supervisor, model_args=model_args,
        device=device)
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
        summary = _spawn(config, n) if n > 1 else run(config)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
