"""Device time of the f32 flash backward on each route, on the card.

    python3 tools/flash_f32_timing.py [--iters 50]

Times the f32 dQ and dK/dV kernels of ``ops/flash_attention.py`` on both
of their routes -- ``tc32`` (3xTF32 on the tensor cores,
``csrc/flash_attention_f32_sm90.cu``) and ``simt`` (CUDA cores,
``csrc/flash_attention.cu``) -- and PyTorch's f32
``scaled_dot_product_attention`` backward (dQ, dK and dV in one call) on
the same inputs, at the two shapes the port runs them at: the training
slice (B=8, L=1024, H=8, D=64, causal) and BERT-tiny's (B=32, L=128, H=2,
D=64, all-valid key mask).  Each time is CUDA events around ``--iters``
calls queued behind a device-side spin (``torch.cuda._sleep``) that
outlasts their enqueueing, so that the card runs them back to back and
the host's launch cost stays out of the window; the routes are timed in
the order tc32, simt, SDPA, SDPA, simt, tc32 (the mean of each pair is
reported), so that the card's clock and neighbours weigh on each alike.
One JSON line per shape; the line before the last is the card's name and
power limit, the last ``{"ok": true}``.  Needs the card;
``chip_smoke.py`` records the profiler's device times of the same
kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = {"slice": dict(b=8, lq=1024, h=8, d=64, causal=True, masked=False),
          "bert": dict(b=32, lq=128, h=2, d=64, causal=False, masked=True)}


def _events_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin twice as long as their enqueueing took."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1e7 / start.elapsed_time(end)
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(2 * enqueue_ms * cycles_per_ms) + 1)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_shape(b, lq, h, d, causal, masked, iters):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, lq, h, d)).astype(np.float32)).cuda() for _ in range(4))
    mask = torch.ones(b, lq, device="cuda") if masked else None
    scale = d ** -0.5
    out, lse = fa._fwd_reference(q, k, v, mask, scale, causal)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, mask, do, lse.contiguous(), delta, scale, causal)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    attn = None if mask is None else (mask > 0)[:, None, None, :]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn, is_causal=causal)
    dot = do.transpose(1, 2)
    fns = {
        "tc32": lambda: (fa._dq_cuda(*args, route="tc32"),
                         fa._dkv_cuda(*args, route="tc32")),
        "tc32_dq": lambda: fa._dq_cuda(*args, route="tc32"),
        "tc32_dkv": lambda: fa._dkv_cuda(*args, route="tc32"),
        "simt": lambda: (fa._dq_cuda(*args, route="simt"),
                         fa._dkv_cuda(*args, route="simt")),
        "sdpa_efficient": lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True)}
    order = list(fns) + list(fns)[::-1]
    times: dict[str, list[float]] = {n: [] for n in fns}
    for name in order:
        times[name].append(_events_ms(fns[name], iters))
    return {n: sum(t) / len(t) for n, t in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_timing: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=50)
    iters = parser.parse_args().iters
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, shape in SHAPES.items():
        ms = time_shape(**shape, iters=iters)
        print(json.dumps({"shape": name, **shape, "ms": ms}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
