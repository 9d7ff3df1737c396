"""What a chunk of one step costs against the Trainer's one-step drain.

    python3 tools/drain_k1.py [--steps 256] [--device cuda|cpu]

``Trainer.fit`` has two drains.  At ``steps_per_call`` 1 it dispatches
each step with ``Engine.step``, throttles on a CUDA event ``MAX_IN_FLIGHT``
steps back and reads the metrics only at the log cadence.  At k > 1 it
dispatches chunks with ``Engine.many_step``, which stacks each metric on
the device, and reads every chunk's stack once; with a target accuracy
it reads each chunk right after its dispatch (no chunk may run past an
eval).  This script runs the per-step work of each drain on the same
batches, staged by ``DevicePrefetch`` as the Trainer stages them, for
the reference's MNIST CNN and MLP at batch 32 on a 1-rank process group
(NCCL on the card), f32 with TF32 off:

* ``steps``: the one-step drain, no metric read;
* ``chunk1``: chunks of one step, up to ``MAX_IN_FLIGHT`` unread;
* ``chunk1_w0``: chunks of one step, each read after its dispatch.

Each variant trains one epoch (``--steps`` steps) from the same fresh
state, in the order steps, chunk1, chunk1_w0, chunk1_w0, chunk1, steps,
after one unmeasured warm-up epoch per model.  One JSON line per run
gives its wall ms per step (first dispatch to the end of the last
step); the line before the last is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from distributed_tensorflow_tpu_torch.data import (  # noqa: E402
    DevicePrefetch, load_dataset)
from distributed_tensorflow_tpu_torch.engines import SyncEngine  # noqa: E402
from distributed_tensorflow_tpu_torch.engines.allreduce import (  # noqa: E402
    MAX_IN_FLIGHT)
from distributed_tensorflow_tpu_torch.models import create_model  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.mesh import (  # noqa: E402
    create_mesh)

BATCH = 32
ORDER = ("steps", "chunk1", "chunk1_w0", "chunk1_w0", "chunk1", "steps")


def _epoch(eng, ds, variant: str, steps: int) -> float:
    """One epoch of ``variant``; wall seconds per step."""
    state = eng.init_state(torch.Generator().manual_seed(0), ds.x[:1])
    on_card = eng.device.type == "cuda"
    pf = DevicePrefetch(
        ds.batches(BATCH, shuffle=True, seed=0, drop_remainder=True),
        lambda b: eng.shard_batch(b[0], b[1]), depth=2, device=eng.device)
    done = 0
    t0 = time.perf_counter()
    try:
        if variant == "steps":
            in_flight = []
            for xs, ys in pf:
                state, metrics = eng.step(state, xs, ys)
                if on_card:
                    ev = torch.cuda.Event()
                    ev.record()
                    in_flight.append(ev)
                    if len(in_flight) > MAX_IN_FLIGHT:
                        in_flight.pop(0).synchronize()
                done += 1
                if done == steps:
                    break
            last = {k: float(v) for k, v in metrics.items()}
        else:
            window = MAX_IN_FLIGHT if variant == "chunk1" else 0
            unread, last = [], {}
            while done < steps:
                chunk = pf.take(1)
                if not chunk:
                    break
                state, stacked = eng.many_step(
                    state, [chunk[0][0]], [chunk[0][1]])
                unread.append(stacked)
                done += 1
                while len(unread) > window:
                    floats = {k: v.cpu().numpy()
                              for k, v in unread.pop(0).items()}
                    last = {k: float(v[0]) for k, v in floats.items()}
            while unread:
                floats = {k: v.cpu().numpy() for k, v in unread.pop(0).items()}
                last = {k: float(v[0]) for k, v in floats.items()}
        if on_card:
            torch.cuda.synchronize(eng.device)
    finally:
        pf.close()
    assert done == steps and all(map(math.isfinite, last.values())), (
        done, last)
    return (time.perf_counter() - t0) / done


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("drain_k1: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = load_dataset("mnist")
    mesh = create_mesh(1, device=args.device)
    try:
        for name in ("cnn", "mlp"):
            eng = SyncEngine(create_model(name, device=mesh.device),
                             mesh=mesh)
            _epoch(eng, ds, "steps", args.steps)          # warm-up
            runs = []
            for variant in ORDER:
                ms = _epoch(eng, ds, variant, args.steps) * 1e3
                runs.append(ms)
                print(json.dumps({"model": name, "variant": variant,
                                  "steps": args.steps, "ms_per_step": ms}))
            print(json.dumps({"model": name, "mean_ms_per_step": {
                v: sum(m for u, m in zip(ORDER, runs) if u == v) / 2
                for v in dict.fromkeys(ORDER)}}))
    finally:
        mesh.close()
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
