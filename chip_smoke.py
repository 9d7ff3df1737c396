"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device  — torch/CUDA versions, the card's name and power limit;
2. build   — nvcc builds every kernel of the serving path from the sources
             in this checkout (``ops/csrc/*.cu``);
3. kernels — each kernel against its plain PyTorch version on the card, on
             seeded inputs, with the stated tolerances; the decode shape of
             the serving path is timed beside its bound and a library call;
4. serve   — the paged-KV GPT server at the full width of the repo's serve
             bench (vocab 16384, hidden 512, 8 layers, 8 heads, ffn 2048,
             max_len 144, bf16, 8 slots, block 8), random weights from a
             seed, answering 16 seeded requests through
             ``SlotKVCache(..., kv_layout="paged")`` and
             ``ContinuousBatcher.run``; the launch counts show the decode
             steps went through the kernel, and the first decode step's
             logits are held against the gather read.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

F32_TOL = dict(rtol=1e-5, atol=2e-5)   # as tests/test_serving_paged_kernel.py
# bf16 output: kernel and plain version both accumulate in f32 and round
# once to bf16, so they may differ by one bf16 rounding (relative 2^-8)
BF16_TOL = dict(rtol=8e-3, atol=8e-3)
# first decode step's logits, fused read vs gather read, bf16 model: the
# two attention reads round differently to bf16 and the difference passes
# through 8 layers; logits have unit scale at this init
LOGIT_ATOL = 0.1
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def _device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _paged_case(seed, *, s=8, l_q=1, h=8, kvh=8, d=64, blk=8, mb=18,
                q_dtype=torch.float32, kv_dtype=torch.float32,
                pos=None, alias=False, dev="cuda"):
    """Seeded pools + a permuted block table on ``dev`` (numpy draws)."""
    rng = np.random.default_rng(seed)
    n = s * mb + 1
    q = torch.from_numpy(rng.standard_normal((s, l_q, h, d)).astype(
        np.float32)).to(dev, q_dtype)
    ks = vs = None
    if kv_dtype == torch.int8:
        kp = torch.from_numpy(rng.integers(-127, 128, (n, blk, kvh, d))
                              .astype(np.int8)).to(dev)
        vp = torch.from_numpy(rng.integers(-127, 128, (n, blk, kvh, d))
                              .astype(np.int8)).to(dev)
        ks = torch.from_numpy((rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127.0)
                              .astype(np.float32)).to(dev)
        vs = torch.from_numpy((rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127.0)
                              .astype(np.float32)).to(dev)
    else:
        kp = torch.from_numpy(rng.standard_normal((n, blk, kvh, d)).astype(
            np.float32)).to(dev, kv_dtype)
        vp = torch.from_numpy(rng.standard_normal((n, blk, kvh, d)).astype(
            np.float32)).to(dev, kv_dtype)
    bt = rng.permutation(n)[:s * mb].reshape(s, mb).astype(np.int32)
    if alias:
        bt[1::2] = bt[0::2]
    if pos is None:
        pos = rng.integers(16, mb * blk - l_q + 1, s)
    pos = np.asarray(pos, np.int32)
    if alias:
        pos[1::2] = pos[0::2]
        q[1::2] = q[0::2]
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos).to(dev), ks, vs)


def _bound_ms(q, kp, pos, ks) -> tuple[float, str]:
    """Least time for the work this run's data needs (tables that alias
    no block): the keys each slot sees (``pos + l_q`` K and V rows, and
    their scales) and the table entries that map them read once,
    q/positions read once, out written once — against the HBM rate; the
    QK and PV products of every unmasked (row, key) pair against the peak
    rate for the input type.  The larger of the two bounds it."""
    s, l_q, h, d = q.shape
    _, blk, kvh, _ = kp.shape
    keys = pos.cpu().numpy().astype(np.int64) + l_q    # per slot
    kv_row = kvh * d * kp.element_size() + (kvh * 4 if ks is not None
                                            else 0)
    nbytes = (2 * int(keys.sum()) * kv_row
              + 2 * q.numel() * q.element_size()
              + int((-(-keys // blk)).sum()) * 4 + pos.numel() * 4)
    # query row l of a slot sees keys 0..pos+l
    pairs = float((l_q * (keys - l_q) + l_q * (l_q + 1) // 2).sum())
    flops = 4.0 * h * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS.get(q.dtype, PEAK_FLOPS[torch.float32]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase() -> dict:
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    cases = {
        "decode_bench_bf16": (dict(q_dtype=torch.bfloat16,
                                   kv_dtype=torch.bfloat16), BF16_TOL),
        "gqa_f32": (dict(h=8, kvh=2), F32_TOL),
        "verify_lq5_gqa_f32": (dict(h=8, kvh=2, l_q=5), F32_TOL),
        "int8_scales": (dict(h=8, kvh=2, kv_dtype=torch.int8), F32_TOL),
        "mha_f32": (dict(), F32_TOL),
        "aliased_tables_bf16": (dict(q_dtype=torch.bfloat16,
                                     kv_dtype=torch.bfloat16, alias=True),
                                BF16_TOL),
        "block_edges_f32": (dict(pos=[0, 7, 8, 15, 16, 63, 64, 143]),
                            F32_TOL),
        "head_dim_256_f32": (dict(d=256, h=4, kvh=4, mb=4), F32_TOL),
        # 80 folded rows x head_dim 128: 93 KB of dynamic shared memory
        "large_group_smem_f32": (dict(h=32, kvh=2, l_q=5, d=128), F32_TOL),
    }
    errs = {}
    for i, (name, (kw, tol)) in enumerate(cases.items()):
        q, kp, vp, bt, pos, ks, vs = _paged_case(100 + i, **kw)
        out = pa.paged_attention(q, kp, vp, bt, pos, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        ref = pa.paged_attention_reference(q, kp, vp, bt, pos,
                                           k_scale=ks, v_scale=vs)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        if kw.get("alias"):
            assert torch.equal(out[0::2], out[1::2]), "aliased rows differ"
        errs[name] = float((out.float() - ref.float()).abs().max())
        print(f"[kernel] {name}: max_abs_err={errs[name]:.3e} ok")

    # the serving path's decode shape, timed
    q, kp, vp, bt, pos, _, _ = _paged_case(
        7, q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16)
    s, l_q, h, d = q.shape
    kernel_ms = _time_ms(lambda: pa.paged_attention(q, kp, vp, bt, pos))
    plain_ms = _time_ms(lambda: pa.paged_attention_reference(
        q, kp, vp, bt, pos))
    # library yardstick: one scaled_dot_product_attention call over the
    # table gathered beforehand (the gather is not in the timed call)
    mb, blk = bt.shape[1], kp.shape[1]
    keys = kp[bt.long()].reshape(s, mb * blk, h, d).transpose(1, 2)
    vals = vp[bt.long()].reshape(s, mb * blk, h, d).transpose(1, 2)
    mask = (torch.arange(mb * blk, device="cuda")[None, None, None, :]
            <= pos.long()[:, None, None, None])
    qt = q.transpose(1, 2)
    library_ms = _time_ms(lambda: torch.nn.functional.
                          scaled_dot_product_attention(qt, keys, vals,
                                                       attn_mask=mask))
    bound_ms, bound_by = _bound_ms(q, kp, pos, None)
    print(f"[kernel] decode S={s} H=KVH={h} D={d} blk={blk} MB={mb} bf16: "
          f"kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f} bound_ms={bound_ms:.6f} "
          f"({bound_by})")
    return {"name": "paged_attention", "route": "cuda",
            "source": "distributed_tensorflow_tpu_torch/ops/csrc/"
                      "paged_attention.cu",
            "replaces": "distributed_tensorflow_tpu/ops/paged_attention.py:257",
            "max_abs_err": errs["decode_bench_bf16"], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def serve_phase(gpu: str) -> int:
    """Full-width paged serving window; returns the kernel launches made
    by the main path."""
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, Request, SlotKVCache)

    layers, slots, block, vocab = 8, 8, 8, 16384
    model = create_model("gpt", num_classes=vocab, hidden=512,
                         layers=layers, heads=8, ffn=2048,
                         max_len=16 + 64 + 64, dropout_rate=0.0,
                         dtype="bfloat16")
    model.reset_parameters(torch.Generator().manual_seed(0))
    kv = SlotKVCache(model, None, slots, kv_layout="paged",
                     paged_block=block)
    rng = np.random.default_rng(0)
    requests = [Request(rid=i,
                        prompt=rng.integers(0, vocab, int(rng.integers(16, 65)))
                        .astype(np.int32),
                        max_new_tokens=int(rng.integers(32, 65)))
                for i in range(16)]
    batcher = ContinuousBatcher(kv, prefill_chunk=16)
    batcher.run(requests[:2])                 # warm-up window (allocator)
    torch.cuda.synchronize()

    pa.paged_attention.launches = 0
    summary = batcher.run(requests)
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches

    assert summary["completed"] == len(requests), summary["completed"]
    for r in summary["results"]:
        req = requests[r.rid]
        assert len(r.tokens) == req.max_new_tokens, (r.rid, len(r.tokens))
        assert all(0 <= t < vocab for t in r.tokens)
    iters = summary["decode_iterations"]
    assert launches == layers * iters, (launches, layers, iters)
    assert kv.blocks_in_use == 0, kv.blocks_in_use
    print(f"[serve] {gpu}: completed={summary['completed']} "
          f"decode_iterations={iters} kernel_launches={launches} "
          f"serve_tokens_per_sec={summary['serve_tokens_per_sec']:.3f} "
          f"ttft_p50_s={summary['serve_ttft_p50_s']:.5f} "
          f"itl_p50_s={summary['serve_itl_p50_s']:.6f} "
          f"itl_p95_s={summary['serve_itl_p95_s']:.6f} "
          f"elapsed_s={summary['elapsed_s']:.4f}")

    # first decode step's logits: fused table vs a gather twin holding the
    # same prompts (prefill writes identical pools on both)
    twin = SlotKVCache(model, None, slots, kv_layout="paged",
                       paged_block=block, paged_fused=False)
    for table in (kv, twin):
        for req in requests[:slots]:
            table.insert(req.prompt)
    fused = kv.decode_logits()
    gather = twin.decode_logits()
    torch.cuda.synchronize()
    assert fused.shape == (slots, vocab) and bool(fused.isfinite().all())
    err = float((fused - gather).abs().max())
    agree = int((fused.argmax(-1) == gather.argmax(-1)).sum())
    print(f"[serve] first decode step fused vs gather logits: "
          f"max_abs_err={err:.4e} (bound {LOGIT_ATOL}), "
          f"greedy agreement {agree}/{slots}, "
          f"logit scale {float(gather.abs().max()):.3f}")
    assert err <= LOGIT_ATOL, err
    print(f"[serve] device_phase_s={json.dumps(summary['device_phase_s'])} "
          f"prefill_chunks={summary['prefill_chunks']}")
    _profile_decode(kv)
    return launches


def _profile_decode(kv, steps: int = 16) -> None:
    """Where a decode step's time goes: ``steps`` decode iterations of the
    full table timed on the host clock, then the same again under
    ``torch.profiler`` for the device kernels' own time — the device's
    busy share of an unprofiled step, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        kv.advance()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            kv.advance()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / steps, e.count / steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print("[profile] no device time in the trace: not measured")
        return
    paged_us = sum(r[0] for r in rows if "paged_attention" in r[2])
    print(f"[profile] decode step (8 active slots): wall_ms="
          f"{wall_us / 1e3:.4f} device_busy_ms={busy_us / 1e3:.4f} "
          f"busy_share={busy_us / wall_us:.4f} "
          f"paged_attention_ms={paged_us / 1e3:.4f} "
          f"paged_attention_share_of_device={paged_us / busy_us:.4f} "
          f"kernels_per_step={sum(r[1] for r in rows):.1f}")
    for dev_us, count, key in rows[:8]:
        print(f"[profile]   {dev_us:9.2f} us/step x{count:<6.1f} {key[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 parity on the card
    torch.backends.cudnn.allow_tf32 = False
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    gpu = _device_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    pa.build()
    print(f"[build] paged_attention.cu built in "
          f"{_build.build_seconds['paged_attention']:.2f}s "
          f"(phase {time.perf_counter() - t0:.2f}s)")
    row = kernel_phase()
    row["launches"] = serve_phase(gpu)
    print(gpu)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
