"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device  — torch/CUDA versions, the card's name and power limit;
2. build   — nvcc builds every kernel from the sources in this checkout
             (``ops/csrc/*.cu``), one nvcc per source, all started together,
             and prints ptxas's registers and spills of the tensor-core
             flash kernels and the paged kernels;
3. kernels — each kernel against its plain PyTorch version on the card, on
             seeded inputs, with the stated tolerances: the paged decode
             kernel (split-key flash-decoding) at the split count it picks
             and at forced counts 1, 2, 4 and one table entry per split;
             the flash-attention kernels of both routes — f32 cases on the
             SIMT kernels (forward, dQ, dK/dV), their bf16 twins on the
             tensor-core kernels (``tc``) — and the block primitives;
4. serve   — the GPT server at the full width of the repo's serve bench
             (vocab 16384, hidden 512, 8 layers, 8 heads, ffn 2048, max_len
             144, bf16, 8 slots), random weights from a seed, answering
             ``bench.py --serve``'s default trace (32 requests, a shared
             16-token prefix, prefill chunk 16, a 128-block prefix pool of
             8-token blocks) through ``SlotKVCache`` and
             ``ContinuousBatcher.run`` in three windows: M, the monolithic
             table (no paged launch); P, the paged table with the
             zero-copy pool (one kernel launch per layer per decode
             iteration, copy-on-write); Q, window P with int8 pools (every
             launch on the kernel's int8 route).  Then first-decode-step
             logits of the paged fused read against the gather read and
             against the monolithic table, of a warm prefix pool against a
             cold one, the cursor mode (``generate``) against the
             monolithic prefill and ``generate``'s greedy streams against
             the table's, a seeded 0.8-temperature window run twice, and
             where a decode step's device time goes (``torch.profiler``):
             paged, paged on int8 pools, monolithic;
5. train   — the GPT of ``bench.py --lm`` (vocab 16384, hidden 512, 8
             layers, 8 heads, ffn 2048, sequence 1024, bf16, dropout 0,
             flash attention), random weights from a seed, trained for two
             epochs of 64 seeded rows at batch 8 (16 steps) by
             ``Trainer(model, engine=SyncEngine(model)).fit`` and evaluated
             by ``Trainer.evaluate``; the launch counts show every
             attention forward and backward went through the kernels of
             the ``tc`` route, and one step is held against a
             dense-attention twin; then where a train step's device time
             goes;
6. timings — the main paths' kernels at their shapes beside their bounds,
             the plain versions and a library call: each one's device time
             per launch from ``torch.profiler`` (``ms``) and the
             event-window time per call with the host's cost
             (``call_ms``); the paged kernel also at a 4096-token context,
             with a sweep of split counts at both shapes, and on int8 pools at
             the decode shape.  Last, so that
             no profiler session precedes the serve and train windows.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# f32 flash gradients: the bounds of tests/test_flash_attention.py (tile
# and online-softmax reassociation against one dense pass); bf16 gradients
# are held to BF16_TOL: the kernels sum in f32 and round once to bf16
FLASH_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the tensor-core route (bf16, head dim a multiple of 16 up to 128) rounds
# each P (and dS) to bf16 before its product and each output to bf16
# again: a rounding of a term moves an output by at most 2^-9 (bf16's unit
# roundoff) of that term, so outputs are held element-wise to
# 2^-8 (|want| + sum of |terms|) + 1e-5 (a bound on |want| alone fails
# where large terms cancel), and to a relative Frobenius error under 1e-2.
# lse stays f32 on both routes (F32_TOL).
TC_RTOL, TC_ATOL, TC_FROBENIUS = 2.0 ** -8, 1e-5, 1e-2
# one train step of the bf16 flash model against its dense-attention twin
# (same weights, same batch): the dense path rounds scores, softmax and
# P·V to bf16 where the kernels keep f32, in each of 8 layers.  Loss: 0.2%
# of its ~9.7; each parameter's gradient: 10% relative (Frobenius norm).
# The attention key biases are not compared: their gradient is zero in
# exact arithmetic (a per-row score shift leaves the softmax unchanged),
# so both sides hold rounding noise.
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_RTOL = 1e-1
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
LM = dict(vocab=16384, hidden=512, layers=8, heads=8, ffn=2048,
          seq=1024, batch=8)


def _device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_windows(fn, iters: int, warmup: int, windows: int = 3):
    """(median ms of ``windows`` timed windows, their spread: (max - min)
    / median)."""
    times = sorted(_time_ms(fn, iters, warmup) for _ in range(windows))
    mid = times[len(times) // 2]
    return mid, (times[-1] - times[0]) / mid


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


def _device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time per call of ``fn``: the self device time of every
    kernel ``iters`` calls launch, from ``torch.profiler``, over ``iters``
    (the host's cost between launches is not in it)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(r[0] for r in _device_rows(prof, iters))
    if not us:
        raise RuntimeError("the profiler saw no device time")
    return us / 1e3


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


def _paged_timed(q, kp, vp, bt, pos, splits_list, ks=None, vs=None) -> dict:
    """Device ms per call of the kernel at each split count (None = the
    count ``_splits`` picks), the plain version and the library yardstick,
    the event-window ms per call of each, and the bound.  ``ks``/``vs``:
    the scales of int8 pools."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    s, l_q, h, d = q.shape
    mb, blk = bt.shape[1], kp.shape[1]
    sc = dict(k_scale=ks, v_scale=vs)
    sweep = {sp: _device_ms(lambda sp=sp: pa._paged_cuda(
        q, kp, vp, bt, pos, splits=sp, **sc)) for sp in splits_list}
    kernel = lambda: pa.paged_attention(  # noqa: E731
        q, kp, vp, bt, pos, **sc)
    plain = lambda: pa.paged_attention_reference(  # noqa: E731
        q, kp, vp, bt, pos, **sc)
    # library yardstick: one scaled_dot_product_attention call over the
    # table gathered (and dequantized) beforehand, not in the timed call
    keys = kp[bt.long()].reshape(s, mb * blk, h, d)
    vals = vp[bt.long()].reshape(s, mb * blk, h, d)
    if ks is not None:
        keys = (keys.float() * ks[bt.long()].reshape(s, mb * blk, h, 1)
                ).to(q.dtype)
        vals = (vals.float() * vs[bt.long()].reshape(s, mb * blk, h, 1)
                ).to(q.dtype)
    keys, vals = keys.transpose(1, 2), vals.transpose(1, 2)
    mask = (torch.arange(mb * blk, device="cuda")[None, None, None, :]
            <= pos.long()[:, None, None, None])
    qt = q.transpose(1, 2)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731,E501
        qt, keys, vals, attn_mask=mask)
    bound_ms, bound_by = _bound_ms(q, kp, pos, ks)
    return {"splits": pa._splits(s, kp.shape[2], mb, blk),
            "ms": _device_ms(kernel), "call_ms": _time_ms(kernel),
            "plain_ms": _device_ms(plain, iters=10),
            "plain_call_ms": _time_ms(plain, iters=20, warmup=3),
            "library_ms": _device_ms(library),
            "library_call_ms": _time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "sweep": {str(sp): t for sp, t in sweep.items()}}


def paged_check_phase() -> dict:
    """The paged kernel against its plain version on ten seeded cases at
    every split count; returns each case's max abs error."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    cases = {
        "decode_bench_bf16": (dict(q_dtype=torch.bfloat16,
                                   kv_dtype=torch.bfloat16), BF16_TOL),
        "gqa_f32": (dict(h=8, kvh=2), F32_TOL),
        "verify_lq5_gqa_f32": (dict(h=8, kvh=2, l_q=5), F32_TOL),
        "int8_scales": (dict(h=8, kvh=2, kv_dtype=torch.int8), F32_TOL),
        # window Q's decode shape: bf16 queries over int8 pools
        "decode_int8_bf16": (dict(q_dtype=torch.bfloat16,
                                  kv_dtype=torch.int8), BF16_TOL),
        "mha_f32": (dict(), F32_TOL),
        "aliased_tables_bf16": (dict(q_dtype=torch.bfloat16,
                                     kv_dtype=torch.bfloat16, alias=True),
                                BF16_TOL),
        "block_edges_f32": (dict(pos=[0, 7, 8, 15, 16, 63, 64, 143]),
                            F32_TOL),
        "head_dim_256_f32": (dict(d=256, h=4, kvh=4, mb=4), F32_TOL),
        # 80 folded rows x head_dim 128: 95 KB of dynamic shared memory
        "large_group_smem_f32": (dict(h=32, kvh=2, l_q=5, d=128), F32_TOL),
    }
    errs = {}
    for i, (name, (kw, tol)) in enumerate(cases.items()):
        q, kp, vp, bt, pos, ks, vs = _paged_case(100 + i, **kw)
        ref = pa.paged_attention_reference(q, kp, vp, bt, pos,
                                           k_scale=ks, v_scale=vs)
        mb = bt.shape[1]
        # the wrapper's own split count, then forced counts up to one
        # table entry per split
        for sp in (None, 1, 2, 4, mb):
            out = pa._paged_cuda(q, kp, vp, bt, pos, k_scale=ks, v_scale=vs,
                                 splits=sp)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), **tol,
                                       msg=f"{name} splits={sp}")
            if kw.get("alias"):
                assert torch.equal(out[0::2], out[1::2]), "aliased rows differ"
            err = float((out.float() - ref.float()).abs().max())
            errs[name] = max(errs.get(name, 0.0), err)
        print(f"[kernel] {name}: max_abs_err={errs[name]:.3e} at splits "
              f"default/1/2/4/{mb} ok")
    return errs


def paged_timing_phase(errs) -> dict:
    """The paged kernel timed at the serve decode shape and at a long
    context, with a sweep of split counts; returns the kernel's row."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    sweep = (1, 2, 4, 8, 16, 32, 64)
    # the serving path's decode shape
    q, kp, vp, bt, pos, _, _ = _paged_case(
        7, q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16)
    dec = _paged_timed(q, kp, vp, bt, pos, sweep)
    # a long context: 4096-token tables, positions in [3584, 4095]
    long_pos = np.random.default_rng(8).integers(3584, 4096, 8)
    q, kp, vp, bt, pos, _, _ = _paged_case(
        8, blk=16, mb=256, q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
        pos=long_pos)
    out = pa.paged_attention(q, kp, vp, bt, pos)
    ref = pa.paged_attention_reference(q, kp, vp, bt, pos)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    lng = _paged_timed(q, kp, vp, bt, pos, sweep)
    del q, kp, vp, bt, pos, out, ref
    # window Q's decode shape: int8 pools with f32 scales
    q, kp, vp, bt, pos, ks, vs = _paged_case(
        9, q_dtype=torch.bfloat16, kv_dtype=torch.int8)
    i8 = _paged_timed(q, kp, vp, bt, pos, (1, 2, 4, 8), ks, vs)
    del q, kp, vp, bt, pos, ks, vs
    for label, t in (("decode S=8 H=KVH=8 D=64 blk=8 MB=18 bf16", dec),
                     ("decode S=8 H=KVH=8 D=64 blk=8 MB=18 bf16 q, int8 "
                      "pools + f32 scales", i8),
                     ("long context S=8 H=KVH=8 D=64 blk=16 MB=256 pos "
                      "3584-4095 bf16", lng)):
        print(f"[kernel] {label}: device ms per call: kernel={t['ms']:.5f} "
              f"(splits={t['splits']}) plain={t['plain_ms']:.5f} "
              f"library={t['library_ms']:.5f}; call ms: "
              f"kernel={t['call_ms']:.5f} plain={t['plain_call_ms']:.5f} "
              f"library={t['library_call_ms']:.5f}; bound_ms="
              f"{t['bound_ms']:.6f} ({t['bound_by']}), kernel/bound="
              f"{t['ms'] / t['bound_ms']:.2f}")
        print(f"[kernel] {label}: split sweep (device ms per call): "
              + " ".join(f"{sp}:{ms:.5f}" for sp, ms in t["sweep"].items()))
    return {"name": "paged_attention", "route": "cuda",
            "source": "distributed_tensorflow_tpu_torch/ops/csrc/"
                      "paged_attention.cu",
            "replaces": "distributed_tensorflow_tpu/ops/paged_attention.py:257",
            "max_abs_err": errs["decode_bench_bf16"],
            **{k: dec[k] for k in ("ms", "call_ms", "plain_ms",
                                   "plain_call_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_call_ms",
                                   "splits")},
            "split_sweep": dec["sweep"],
            "long_context": {k: lng[k] for k in (
                "ms", "call_ms", "splits", "bound_ms", "bound_by",
                "plain_ms", "library_ms", "sweep")},
            "int8": {"max_abs_err": errs["decode_int8_bf16"],
                     **{k: i8[k] for k in (
                         "ms", "call_ms", "splits", "bound_ms", "bound_by",
                         "plain_ms", "library_ms", "sweep")}}}


def _flash_case(seed, *, b, lq, h, d, dtype=torch.float32, lk=None,
                masked=False, dead_row=False):
    """Seeded q, k, v, dO and key mask on the card (numpy draws)."""
    rng = np.random.default_rng(seed)
    lk = lk or lq

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dtype)

    q, k, v, do = draw(b, lq, h, d), draw(b, lk, h, d), draw(b, lk, h, d), \
        draw(b, lq, h, d)
    mask = None
    if masked or dead_row:
        m = (rng.uniform(size=(b, lk)) > 0.3 if masked
             else np.ones((b, lk), bool))
        m[:, 0] = True
        if dead_row:
            m[-1] = False            # the last batch row has no valid key
        mask = torch.from_numpy(m.astype(np.float32)).cuda()
    return q, k, v, do, mask


def _flash_bound_ms(kind, q, k, causal) -> tuple[float, str]:
    """Least time for one kernel's work on these inputs: each input read
    once and each output written once at the HBM rate, against the products
    of the unmasked (causal) pairs at the peak rate for the input type —
    QKᵀ and PV (fwd: 4·D per pair), QKᵀ, dO·Vᵀ and dS·K (dq: 6·D), QKᵀ,
    dO·Vᵀ, Pᵀ·dO and dSᵀ·Q (dkv: 8·D).  The larger of the two bounds it."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    tensor = q.numel() * q.element_size()       # q, k, v, dO alike (Lq=Lk)
    row = b * h * lq * 4                        # lse or delta, f32
    tensors, rows, per_pair = {"fwd": (4, 1, 4), "dq": (5, 2, 6),
                               "dkv": (6, 2, 8)}[kind]
    nbytes = tensors * tensor + rows * row
    qpos = np.arange(lq)
    pairs = b * h * float((np.minimum(qpos + 1, lk) if causal
                           else np.full(lq, lk)).sum())
    flops = float(per_pair * d) * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _close_tc(name, got, want, terms):
    """The tensor-core tolerance (TC_*); returns (max abs err, relative
    Frobenius err)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = float((err / (TC_RTOL * (want.abs() + terms) + TC_ATOL)).max())
    frob = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert worst <= 1.0 and frob < TC_FROBENIUS, (name, worst, frob)
    return float(err.max()), frob


def _check_flash(name, case, causal, route) -> dict:
    """Forward, dQ and dK/dV kernels against the plain versions; the
    backward gets the plain forward's lse and Δ = rowsum(dO·O).  The
    launch counters show the kernels of ``route`` ran."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, mask = case
    scale = q.shape[-1] ** -0.5
    assert fa._route(q.dtype, q.shape[-1]) == route, (name, route)
    before = _flash_counts()
    out, lse = fa._fwd_cuda(q, k, v, mask, scale, causal)
    ref_out, ref_lse = fa._fwd_reference(q, k, v, mask, scale, causal)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    grads = fa._bwd_cuda(q, k, v, mask, do, ref_lse.contiguous(), delta,
                         scale, causal)
    torch.cuda.synchronize()
    tc = int(route == "tc")
    assert _flash_counts() == {
        "fwd": before["fwd"] + 1, "dq": before["dq"] + 1,
        "dkv": before["dkv"] + 1, "fwd_tc": before["fwd_tc"] + tc,
        "dq_tc": before["dq_tc"] + tc,
        "dkv_tc": before["dkv_tc"] + tc}, (name, route)
    refs = fa._bwd_reference(q, k, v, mask, do, ref_lse, delta, scale,
                             causal)
    torch.testing.assert_close(lse, ref_lse, **F32_TOL)
    errs = {"lse": float((lse - ref_lse).abs().max())}
    f32 = q.dtype == torch.float32
    if route == "tc":
        terms = fa._term_sums(q, k, v, mask, do, ref_lse, delta, scale,
                              causal)
        for n, got, want, t in (("out", out, ref_out, terms[0]),
                                ("dq", grads[0], refs[0], terms[3]),
                                ("dk", grads[1], refs[1], terms[1]),
                                ("dv", grads[2], refs[2], terms[2])):
            errs[n], errs[f"{n}_frobenius"] = _close_tc(f"{name} {n}", got,
                                                        want, t)
    else:
        torch.testing.assert_close(out.float(), ref_out.float(),
                                   **(F32_TOL if f32 else BF16_TOL))
        errs["out"] = float((out.float() - ref_out.float()).abs().max())
        for g, w, n in zip(grads, refs, ("dq", "dk", "dv")):
            torch.testing.assert_close(g.float(), w, msg=f"{name} {n}",
                                       **(FLASH_GRAD_TOL if f32
                                          else BF16_TOL))
            errs[n] = float((g.float() - w).abs().max())
    print(f"[flash] {name} ({route}): " + " ".join(
        f"{n}_{'rel' if n.endswith('frobenius') else 'max_abs_err'}={e:.3e}"
        for n, e in errs.items()) + " ok")
    return errs


def _check_flash_blocks() -> None:
    """``flash_fwd_block``/``flash_bwd_block`` over a two-block split of
    the keys, given the full rows' lse and Δ: each block against the plain
    versions, and the blocks merged against the whole."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    q, k, v, do, _ = _flash_case(30, b=2, lq=512, h=4, d=64)
    scale = 64 ** -0.5
    full_out, lse = fa._fwd_reference(q, k, v, None, scale, False)
    delta = (do * full_out).sum(-1).transpose(1, 2).contiguous()
    full = fa._bwd_reference(q, k, v, None, do, lse, delta, scale, False)
    ones = torch.ones(2, 256, device="cuda")
    merged, dq, dks, dvs = 0.0, 0.0, [], []
    for half in (slice(0, 256), slice(256, 512)):
        kb, vb = k[:, half].contiguous(), v[:, half].contiguous()
        out_b, lse_b = fa.flash_fwd_block(q, kb, vb, ones, scale=scale)
        want_out, want_lse = fa._fwd_reference(q, kb, vb, ones, scale, False)
        torch.testing.assert_close(out_b, want_out, **F32_TOL)
        torch.testing.assert_close(lse_b, want_lse, **F32_TOL)
        grads = fa.flash_bwd_block(q, kb, vb, ones, do, lse, delta,
                                   scale=scale)
        want = fa._bwd_reference(q, kb, vb, ones, do, lse, delta, scale,
                                 False)
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, **FLASH_GRAD_TOL)
        merged = merged + torch.exp(lse_b - lse).transpose(1, 2)[
            ..., None] * out_b
        dq = dq + grads[0]
        dks.append(grads[1])
        dvs.append(grads[2])
    torch.testing.assert_close(merged, full_out, **F32_TOL)
    for g, w in zip((dq, torch.cat(dks, 1), torch.cat(dvs, 1)), full):
        torch.testing.assert_close(g, w, **FLASH_GRAD_TOL)
    print(f"[flash] block primitives, two-block split: merged out "
          f"max_abs_err={float((merged - full_out).abs().max()):.3e}, "
          f"dq {float((dq - full[0]).abs().max()):.3e} ok")


def _sdpa_backend():
    """The first SDPA backend that takes the slice's causal bf16 shape, in
    the order flash, cuDNN, memory-efficient."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q = torch.zeros(1, 1, 128, 64, device="cuda", dtype=torch.bfloat16)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel(backend):
                torch.nn.functional.scaled_dot_product_attention(
                    q, q, q, is_causal=True)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes the slice's shape")


def flash_check_phase() -> dict:
    """The flash kernels of both routes against their plain versions on
    seeded cases; returns each case's errors."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    cases = {"slice_bf16_causal": (dict(b=8, lq=1024, h=8, d=64,
                                         dtype=bf16), True, "tc")}
    for name, kw, causal in (
            ("ragged_l1000", dict(b=2, lq=1000, h=4, d=64), True),
            ("key_mask", dict(b=2, lq=512, h=4, d=64, masked=True), False),
            ("cross_96x160", dict(b=2, lq=96, lk=160, h=4, d=64), False),
            ("head_dim_128", dict(b=1, lq=384, h=2, d=128), True),
            ("head_dim_256", dict(b=1, lq=384, h=2, d=256), True),
            ("no_valid_key_row", dict(b=2, lq=256, h=2, d=64,
                                      dead_row=True), False)):
        cases[f"{name}_f32"] = (kw, causal, "simt")
        # the bf16 twin: the tc route where it takes the head dim
        cases[f"{name}_bf16"] = (dict(kw, dtype=bf16), causal,
                                 fa._route(bf16, kw["d"]))
    errs = {}
    for i, (name, (kw, causal, route)) in enumerate(cases.items()):
        case = _flash_case(20 + i, **kw)
        errs[name] = _check_flash(name, case, causal, route)
        if kw.get("dead_row"):
            q, k, v, _, mask = case
            out = fa.flash_attention(q, k, v, kv_mask=mask)
            mean_v = v[-1].float().mean(0, keepdim=True).expand_as(out[-1])
            if route == "tc":
                _close_tc(f"{name} mean of V", out[-1], mean_v,
                          v[-1].float().abs().mean(0, keepdim=True))
            else:
                torch.testing.assert_close(out[-1], mean_v, **F32_TOL)
    _check_flash_blocks()
    return errs


def flash_timing_phase(errs) -> list[dict]:
    """The flash kernels timed at the training slice's shape; returns
    their rows."""
    from torch.nn.attention import sdpa_kernel

    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    # the training slice's shape, timed: device ms per launch from the
    # profiler; beside it the event-window ms per call (median of three
    # windows of back-to-back calls, host cost included)
    q, k, v, do, _ = _flash_case(7, b=8, lq=1024, h=8, d=64, dtype=bf16)
    scale = 64 ** -0.5
    out, lse = fa._fwd_cuda(q, k, v, None, scale, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, None, do, lse, delta, scale, True)
    timed = {
        "fwd": lambda: fa._fwd_cuda(q, k, v, None, scale, True),
        "dq": lambda: fa._dq_cuda(*args),
        "dkv": lambda: fa._dkv_cuda(*args),
        # the SIMT kernels on the same bf16 inputs: the design the tc
        # route replaced on this path
        "fwd_simt": lambda: fa._fwd_cuda(q, k, v, None, scale, True,
                                         route="simt"),
        "dq_simt": lambda: fa._dq_cuda(*args, route="simt"),
        "dkv_simt": lambda: fa._dkv_cuda(*args, route="simt")}
    dev = {n: _device_ms(fn) for n, fn in timed.items()}
    call = {n: _time_windows(fn, iters=50, warmup=5) for n, fn in timed.items()}
    plain_fwd = lambda: fa._fwd_reference(q, k, v, None, scale, True)  # noqa: E731,E501
    # the plain backward computes dq, dk and dv in one function: its time
    # stands in both backward rows
    plain_bwd = lambda: fa._bwd_reference(*args)  # noqa: E731
    plain = {"fwd": (_device_ms(plain_fwd, iters=10, warmup=2),
                     _time_windows(plain_fwd, iters=10, warmup=2)[0]),
             "bwd": (_device_ms(plain_bwd, iters=10, warmup=2),
                     _time_windows(plain_bwd, iters=10, warmup=2)[0])}
    # library yardstick, used nowhere in the port: one SDPA call under a
    # named backend, and the autograd backward of that call (dq, dk, dv)
    backend = _sdpa_backend()
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dot = do.transpose(1, 2)
    lib_fwd_fn = lambda: sdpa(qt, kt, vt, is_causal=True)  # noqa: E731
    with sdpa_kernel(backend):
        lib_fwd = (_device_ms(lib_fwd_fn),
                   *_time_windows(lib_fwd_fn, iters=50, warmup=5))
        o = sdpa(qt, kt, vt, is_causal=True)
    lib_bwd_fn = lambda: torch.autograd.grad(  # noqa: E731
        o, (qt, kt, vt), dot, retain_graph=True)
    lib_bwd = (_device_ms(lib_bwd_fn),
               *_time_windows(lib_bwd_fn, iters=50, warmup=5))
    print(f"[flash] library yardstick: SDPA backend {backend.name}: "
          f"fwd device {lib_fwd[0]:.5f} ms, call {lib_fwd[1]:.5f} ms "
          f"(spread {lib_fwd[2]:.3f}); bwd device {lib_bwd[0]:.5f} ms, call "
          f"{lib_bwd[1]:.5f} ms (spread {lib_bwd[2]:.3f})")
    for n in timed:
        print(f"[flash] slice B=8 L=1024 H=8 D=64 bf16 causal: {n} device "
              f"{dev[n]:.5f} ms, call {call[n][0]:.5f} ms (spread "
              f"{call[n][1]:.3f} over 3 windows)")
    print(f"[flash] plain device ms: fwd {plain['fwd'][0]:.5f}, bwd "
          f"{plain['bwd'][0]:.5f}")
    print(f"[flash] dq+dkv {dev['dq'] + dev['dkv']:.5f} ms against the "
          f"SDPA backward {lib_bwd[0]:.5f} ms (device)")
    src = "distributed_tensorflow_tpu_torch/ops/csrc/"
    replaces = {"fwd": 170, "dq": 281, "dkv": 299}
    slice_errs = errs["slice_bf16_causal"]
    rows = []
    for kind in ("fwd", "dq", "dkv"):
        variant = fa._route(bf16, 64)
        bound_ms, bound_by = _flash_bound_ms(kind, q, k, True)
        err = {"fwd": slice_errs["out"], "dq": slice_errs["dq"],
               "dkv": max(slice_errs["dk"], slice_errs["dv"])}[kind]
        lib = lib_fwd if kind == "fwd" else lib_bwd
        pl = plain["fwd" if kind == "fwd" else "bwd"]
        rows.append({
            "name": f"flash_attention.{kind}", "route": "cuda",
            "variant": variant,
            "source": src + ("flash_attention_sm90.cu" if variant == "tc"
                             else "flash_attention.cu"),
            "replaces": "distributed_tensorflow_tpu/ops/flash_attention.py:"
                        f"{replaces[kind]}",
            "max_abs_err": err, "ms": dev[kind],
            "call_ms": call[kind][0], "call_spread": call[kind][1],
            "plain_ms": pl[0], "plain_call_ms": pl[1],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / dev[kind],
            "library_ms": lib[0], "library_call_ms": lib[1],
            "library_spread": lib[2], "library_backend": backend.name,
            "simt_ms": dev[f"{kind}_simt"],
            "simt_call_ms": call[f"{kind}_simt"][0]})
    return rows


SERVE = dict(vocab=16384, hidden=512, layers=8, heads=8, ffn=2048,
             slots=8, block=8, chunk=16, pool=128)


def _serve_model():
    from distributed_tensorflow_tpu_torch.models import create_model

    model = create_model("gpt", num_classes=SERVE["vocab"],
                         hidden=SERVE["hidden"], layers=SERVE["layers"],
                         heads=SERVE["heads"], ffn=SERVE["ffn"],
                         max_len=16 + 64 + 64, dropout_rate=0.0,
                         dtype="bfloat16")
    return model.reset_parameters(torch.Generator().manual_seed(0))


def _bench_trace():
    """``bench.py --serve``'s default trace, drawn in its order from
    ``default_rng(0)``: 32 requests, prompts of the 16-token shared prefix
    plus 16-32 tokens (every 4th plus 64), 32-64 new tokens.  Returns the
    shared prefix and the requests."""
    from distributed_tensorflow_tpu_torch.serving import Request

    rng = np.random.default_rng(0)
    n, rate, prompt_len, max_new, shared_len = 32, 4.0, 32, 64, 16
    rng.exponential(1.0 / rate, n)          # the arrivals (see below)
    p_lens = rng.integers(prompt_len // 2, prompt_len + 1, n)
    p_lens[::4] = 2 * prompt_len
    n_news = rng.integers(max_new // 2, max_new + 1, n)
    shared = rng.integers(0, SERVE["vocab"], shared_len).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, SERVE["vocab"], pl).astype(np.int32)]) for pl in p_lens]
    # every request arrives at 0: the smoke is no benchmark, and the
    # Poisson arrivals at 4 per second would add about 8 s of wall time to
    # each window
    return shared, [Request(rid=i, prompt=prompts[i],
                            max_new_tokens=int(n_news[i]))
                    for i in range(n)]


def _reset_paged_counts() -> None:
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    pa.paged_attention.launches = 0
    pa.paged_attention.int8_launches = 0


def _paged_counts() -> tuple[int, int]:
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    return pa.paged_attention.launches, pa.paged_attention.int8_launches


def _serve_window(name, kv, requests, gpu):
    """A warm-up window of the first two requests (allocator, library
    handles; they stay in the prefix pool), then the whole trace with the
    paged counts set to 0 just before; returns the summary and the counts
    (all launches, int8-route launches)."""
    from distributed_tensorflow_tpu_torch.serving import ContinuousBatcher

    batcher = ContinuousBatcher(kv, prefill_chunk=SERVE["chunk"])
    batcher.run(requests[:2])
    torch.cuda.synchronize()
    _reset_paged_counts()
    summary = batcher.run(requests)
    torch.cuda.synchronize()
    counts = _paged_counts()
    assert summary["completed"] == len(requests), (name, summary["completed"])
    for r in summary["results"]:
        req = requests[r.rid]
        assert len(r.tokens) == req.max_new_tokens, (name, r.rid)
        assert all(0 <= t < SERVE["vocab"] for t in r.tokens), name
    pool = summary["prefix_cache"]
    assert pool["hits"] > 0, (name, pool)
    lp_sum = sum(len(r.prompt) for r in requests)
    assert summary["prefill_tokens"] == lp_sum - pool["tokens_reused"], (
        name, summary["prefill_tokens"], lp_sum, pool)
    paged = summary["paged"] or {}
    print(f"[serve] window {name} ({gpu}; {kv.kv_layout}, {kv.kv_dtype}): "
          f"completed={summary['completed']} "
          f"decode_iterations={summary['decode_iterations']} "
          f"prefill_chunks={summary['prefill_chunks']} "
          f"prefill_tokens={summary['prefill_tokens']} "
          f"paged_launches={counts[0]} int8_launches={counts[1]} "
          f"serve_tokens_per_sec={summary['serve_tokens_per_sec']:.3f} "
          f"ttft_p50_s={summary['serve_ttft_p50_s']:.5f} "
          f"ttft_p95_s={summary['serve_ttft_p95_s']:.5f} "
          f"itl_p50_s={summary['serve_itl_p50_s']:.6f} "
          f"itl_p95_s={summary['serve_itl_p95_s']:.6f} "
          f"serve_prefix_cache_hit_rate="
          f"{summary['serve_prefix_cache_hit_rate']:.4f} "
          f"serve_prefix_zero_copy_hit_rate="
          f"{summary['serve_prefix_zero_copy_hit_rate']} "
          f"cow_copies={paged.get('cow_copies')} "
          f"kv_bytes_per_slot={summary['serve_kv_bytes_per_slot']} "
          f"elapsed_s={summary['elapsed_s']:.4f}")
    print(f"[serve] window {name}: prefix_cache={json.dumps(pool)} "
          f"device_phase_s={json.dumps(summary['device_phase_s'])}")
    return summary, counts


def serve_phase(gpu: str) -> tuple[int, int]:
    """Windows M, P and Q on ``bench.py --serve``'s trace, the
    cross-checks, ``generate`` and temperature checks, and the decode
    profiles; returns the paged kernel's launches in windows P and Q
    (all, and on the int8 route)."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    layers, slots, block = SERVE["layers"], SERVE["slots"], SERVE["block"]
    model = _serve_model()
    shared, requests = _bench_trace()
    pool = dict(prefix_cache_blocks=SERVE["pool"], prefix_block=block)

    # M: the default table of bench.py --serve: monolithic, prefix pool
    mono = SlotKVCache(model, None, slots, **pool)
    m, (launches, _) = _serve_window("M", mono, requests, gpu)
    assert launches == 0, launches
    assert m["paged"] is None and m["serve_kv_blocks_in_use"] is None

    # P: the same trace on the paged table, the same pool (zero copy)
    kv = SlotKVCache(model, None, slots, kv_layout="paged",
                     paged_block=block, **pool)
    p, (p_launches, p_int8) = _serve_window("P", kv, requests, gpu)
    iters = p["decode_iterations"]
    assert p_launches == layers * iters and p_int8 == 0, (p_launches, iters)
    assert p["paged"]["zero_copy_blocks"] == p["prefix_cache"]["hits"]
    # the warm-up left requests 0 and 1 pooled, block-aligned at 80 and 40
    # tokens: each admission here reuses all but the last token and writes
    # that one into a shared block
    assert p["paged"]["cow_copies"] >= 1, p["paged"]
    assert kv.blocks_in_use == p["prefix_cache"]["cached_blocks"], (
        kv.blocks_in_use, p["prefix_cache"])
    kv.reset_prefix_cache()
    assert kv.blocks_in_use == 0, kv.blocks_in_use

    # Q: window P at int8 storage; every launch on the kernel's int8 route
    kv8 = SlotKVCache(model, None, slots, kv_layout="paged",
                      paged_block=block, kv_dtype="int8", **pool)
    q, (q_launches, q_int8) = _serve_window("Q", kv8, requests, gpu)
    assert q_launches == q_int8 == layers * q["decode_iterations"], (
        q_launches, q_int8, q["decode_iterations"])
    ratio = q["serve_kv_bytes_per_slot"] / p["serve_kv_bytes_per_slot"]
    assert ratio < 0.6, ratio
    agree = total = 0
    for a, b in zip(p["results"], q["results"]):
        agree += sum(x == y for x, y in zip(a.tokens, b.tokens))
        total += len(a.tokens)
    print(f"[serve] window Q vs P: kv_bytes_per_slot ratio {ratio:.4f} "
          f"(bound 0.6); greedy tokens equal at {agree}/{total} positions")

    _fused_vs_gather(model, kv, requests)
    _profile_decode(kv, "paged")
    for req in requests[:slots]:
        kv8.insert(req.prompt)
    _profile_decode(kv8, "paged int8")
    xcheck = _cross_checks(model, requests)
    _profile_decode(xcheck, "monolithic")
    _generate_check(model, shared)
    _temperature_check(model, requests)
    return p_launches + q_launches, q_int8


def _fused_vs_gather(model, kv, requests) -> None:
    """First decode step's logits: the paged fused table vs a gather twin
    holding the same prompts (prefill writes identical pools on both)."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    slots = SERVE["slots"]
    twin = SlotKVCache(model, None, slots, kv_layout="paged",
                       paged_block=SERVE["block"], paged_fused=False)
    for table in (kv, twin):
        for req in requests[:slots]:
            table.insert(req.prompt)
    fused = kv.decode_logits()
    gather = twin.decode_logits()
    torch.cuda.synchronize()
    assert fused.shape == (slots, SERVE["vocab"])
    assert bool(fused.isfinite().all())
    _close_logits("paged fused vs gather", fused, gather)


def _close_logits(label, got, want) -> float:
    err = float((got - want).abs().max())
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"[serve] {label} logits: max_abs_err={err:.4e} (bound "
          f"{LOGIT_ATOL}), bitwise equal {bool(torch.equal(got, want))}, "
          f"greedy agreement {agree}/{got.shape[0]}, logit scale "
          f"{float(want.abs().max()):.3f}")
    assert err <= LOGIT_ATOL, (label, err)
    return err


def _cross_checks(model, requests):
    """The trace's first 8 prompts: first-decode-step logits of the
    monolithic table (dense read) against the paged fused table, and of a
    warm prefix pool (the prompts admitted and evicted once) against the
    cold admission.  Returns the monolithic table, 8 slots active."""
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    slots, block = SERVE["slots"], SERVE["block"]
    prompts = [r.prompt for r in requests[:slots]]
    mono = SlotKVCache(model, None, slots)
    paged = SlotKVCache(model, None, slots, kv_layout="paged",
                        paged_block=block)
    for table in (mono, paged):
        for p in prompts:
            table.insert(p)
    _close_logits("monolithic (dense) vs paged fused", mono.decode_logits(),
                  paged.decode_logits())
    pooled = SlotKVCache(model, None, slots, prefix_cache_blocks=SERVE["pool"],
                         prefix_block=block)
    for p in prompts:
        pooled.insert(p)
    cold = pooled.decode_logits().clone()
    before = pooled.prefix_cache_stats()["hits"]
    for s in range(slots):
        pooled.evict(s)
    for p in prompts:
        pooled.insert(p)
    warm_hits = pooled.prefix_cache_stats()["hits"] - before
    assert warm_hits > 0, warm_hits
    print(f"[serve] warm pool re-admission: {warm_hits} block hits")
    _close_logits("monolithic warm pool vs cold", pooled.decode_logits(),
                  cold)
    return mono


def _generate_check(model, shared) -> None:
    """Eight prompts of the shared prefix plus 16 tokens: the cursor mode's
    logits at the first generated position against the monolithic table's
    prefill logits, and ``generate(greedy=True)``'s 64 tokens against the
    table's stream (agreement printed)."""
    from distributed_tensorflow_tpu_torch.models.gpt import generate
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    slots = SERVE["slots"]
    rng = np.random.default_rng(1)
    prompts = np.stack([np.concatenate([shared, rng.integers(
        0, SERVE["vocab"], 16).astype(np.int32)]) for _ in range(slots)])
    lp = prompts.shape[1]
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(prompts).cuda().long(),
                          cache=model.init_cache(slots))
    table = SlotKVCache(model, None, slots)
    prefill = []
    for p in prompts:
        slot, _ = table.begin_insert(p)
        prefill.append(table._prefill_forward(
            slot, p[None], np.arange(lp, dtype=np.int32)[None])[0, -1])
    _close_logits("cursor (generate) vs monolithic prefill", logits[:, -1],
                  torch.stack(prefill))
    t0 = time.perf_counter()
    gen = generate(model, None, prompts, 64, greedy=True).cpu().numpy()
    gen_s = time.perf_counter() - t0
    table = SlotKVCache(model, None, slots)
    stream = [[table.insert(p)[1]] for p in prompts]
    for _ in range(63):
        toks = table.advance()
        for s in range(slots):
            stream[s].append(int(toks[s]))
    stream = np.asarray(stream)
    assert gen.shape == stream.shape == (slots, 64)
    assert ((gen >= 0) & (gen < SERVE["vocab"])).all()
    print(f"[serve] generate(greedy=True) vs the monolithic table over 64 "
          f"new tokens: {int((gen == stream).sum())}/{gen.size} equal, "
          f"{int((gen == stream).all(1).sum())}/{slots} whole streams "
          f"equal; generate took {gen_s:.3f} s")


def _temperature_check(model, requests) -> None:
    """A 0.8-temperature window of 8 requests twice from the same seed:
    identical streams, every id in range."""
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, SlotKVCache)

    def run():
        kv = SlotKVCache(model, None, SERVE["slots"], greedy=False,
                         temperature=0.8,
                         generator=torch.Generator("cuda").manual_seed(0))
        res = ContinuousBatcher(kv, prefill_chunk=SERVE["chunk"]).run(
            requests[:8])
        return [r.tokens for r in res["results"]]

    a, b = run(), run()
    assert a == b, "same seed, different streams"
    assert all(0 <= t < SERVE["vocab"] for toks in a for t in toks)
    greedy = [r.tokens for r in ContinuousBatcher(
        SlotKVCache(model, None, SERVE["slots"]),
        prefill_chunk=SERVE["chunk"]).run(requests[:8])["results"]]
    same = sum(x == y for s, g in zip(a, greedy) for x, y in zip(s, g))
    print(f"[serve] temperature 0.8 window, 8 requests, twice from seed "
          f"0: streams identical; {same}/{sum(map(len, a))} tokens equal "
          f"the greedy window's")


def _lm_data(rows: int):
    """bench.py --lm's tokens: default_rng(0) ids over 1025 positions,
    split into inputs and next-token labels."""
    tok = np.random.default_rng(0).integers(0, LM["vocab"],
                                            (rows, LM["seq"] + 1))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _lm_model(attention_impl: str):
    from distributed_tensorflow_tpu_torch.models import create_model

    return create_model("gpt", num_classes=LM["vocab"], hidden=LM["hidden"],
                        layers=LM["layers"], heads=LM["heads"],
                        ffn=LM["ffn"], max_len=LM["seq"], dropout_rate=0.0,
                        dtype="bfloat16", attention_impl=attention_impl)


_FLASH_COUNTS = ("fwd", "dq", "dkv", "fwd_tc", "dq_tc", "dkv_tc")


def _flash_counts() -> dict:
    """Launches of each flash kernel (all routes), and of the tc route."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    return {n: getattr(fa.flash_attention, f"{n}_launches")
            for n in _FLASH_COUNTS}


def _reset_flash_counts() -> None:
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    for n in _FLASH_COUNTS:
        setattr(fa.flash_attention, f"{n}_launches", 0)


def train_phase(gpu: str):
    """Full-width GPT LM training through SyncEngine and Trainer; returns
    the flash launches of the fit, of the evaluate call, and the steps."""
    from distributed_tensorflow_tpu_torch.data import Dataset
    from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer

    layers, batch = LM["layers"], LM["batch"]
    x, y = _lm_data(64 + 16)
    train_ds = Dataset(x=x[:64], y=y[:64], num_classes=LM["vocab"],
                       name="lm_bench")
    eval_ds = Dataset(x=x[64:], y=y[64:], num_classes=LM["vocab"],
                      name="lm_bench")
    model = _lm_model("flash")
    trainer = Trainer(model, engine=SyncEngine(model), seed=0)
    # the heartbeat reads each step's loss (a host sync per step), so its
    # timestamps mark when each step finished on the device
    beats = []
    _reset_flash_counts()
    result = trainer.fit(train_ds, epochs=2, batch_size=batch, log_every=1,
                         log_fn=lambda line: beats.append(
                             (time.perf_counter(), line)))
    torch.cuda.synchronize()
    fit = _flash_counts()
    steps = result["steps"]
    losses = [float(line.split()[3]) for _, line in beats]
    assert steps == 16 and len(losses) == 16, (steps, len(losses))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    # every forward, dQ and dK/dV of the bf16 model on the tc route
    n = layers * steps
    assert fit == {"fwd": n, "dq": n, "dkv": n, "fwd_tc": n, "dq_tc": n,
                   "dkv_tc": n}, fit
    _reset_flash_counts()
    ev = trainer.evaluate(eval_ds, batch_size=batch)
    torch.cuda.synchronize()
    evaluate = _flash_counts()
    eval_batches = -(-len(eval_ds) // batch)
    n = layers * eval_batches
    assert evaluate == {"fwd": n, "dq": 0, "dkv": 0, "fwd_tc": n,
                        "dq_tc": 0, "dkv_tc": 0}, evaluate
    assert np.isfinite(ev["loss"]) and ev["count"] == 16 * LM["seq"], ev
    stamps = [t for t, _ in beats]
    gaps = np.diff(stamps)                  # steps 2..16, first excluded
    tokens = batch * LM["seq"]
    print(f"[train] {gpu}: steps={steps} loss first={losses[0]:.4f} "
          f"last={losses[-1]:.4f} "
          f"steady_tokens_per_sec={tokens * len(gaps) / gaps.sum():.1f} "
          f"step_ms_p50={np.median(gaps) * 1e3:.3f} "
          f"eval_loss={ev['loss']:.5f} eval_accuracy={ev['accuracy']:.6f} "
          f"elapsed_s={result['elapsed']:.3f} "
          f"flash_launches_fit={json.dumps(fit)} "
          f"flash_launches_eval={json.dumps(evaluate)}")
    print(f"[train] losses {' '.join(f'{v:.4f}' for v in losses)}")
    _flash_vs_dense_step(x[:batch], y[:batch])
    _profile_train(trainer.engine, trainer.state, x[:batch], y[:batch])
    return fit, evaluate, steps


def _flash_vs_dense_step(x, y) -> None:
    """One SyncEngine step of the flash model and of a dense-attention twin
    from the same fresh weights on the same batch: loss and every
    parameter's gradient (left in ``.grad`` by the step)."""
    from distributed_tensorflow_tpu_torch.engines import SyncEngine

    losses, grads = {}, {}
    for impl in ("flash", "dense"):
        eng = SyncEngine(_lm_model(impl))
        state = eng.init_state(torch.Generator().manual_seed(0))
        state, m = eng.step(state, *eng.shard_batch(x, y))
        losses[impl] = float(m["loss"])
        grads[impl] = {n: p.grad for n, p in state.model.named_parameters()}
    worst, worst_name = 0.0, None
    for name, g in grads["dense"].items():
        if name.endswith("attn.key.bias"):
            continue
        rel = float((grads["flash"][name].float() - g.float()).norm()
                    / g.float().norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    rel_loss = abs(losses["flash"] - losses["dense"]) / abs(losses["dense"])
    print(f"[train] one step flash vs dense twin: loss {losses['flash']:.6f}"
          f" vs {losses['dense']:.6f} (rel {rel_loss:.2e}, bound "
          f"{TRAIN_LOSS_RTOL}); worst gradient rel err {worst:.3e} at "
          f"{worst_name} (bound {TRAIN_GRAD_RTOL})")
    assert rel_loss <= TRAIN_LOSS_RTOL, rel_loss
    assert worst <= TRAIN_GRAD_RTOL, (worst, worst_name)


def _device_rows(prof, steps):
    """(device us per step, launches per step, name) of each device kernel,
    largest first.  User annotations with device time (the optimizer's
    ``Optimizer.step#...`` range) are left out: they span kernels that are
    counted on their own."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total / steps, e.count / steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0), reverse=True)


def _profile_train(engine, state, x, y, steps: int = 4) -> None:
    """Where a train step's time goes: ``steps`` SyncEngine steps timed on
    the host clock, then the same under ``torch.profiler``: the device's
    busy share of an unprofiled step, the flash kernels' share of device
    time, kernels per step, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    xs, ys = engine.shard_batch(x, y)
    engine.step(state, xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step(state, xs, ys)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step(state, xs, ys)
        torch.cuda.synchronize()
    rows = _device_rows(prof, steps)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print("[profile] no device time in the trace: not measured")
        return
    # flash_{kind}_kernel (SIMT) or flash_{kind}_tc_kernel (tensor cores)
    flash_us = {kind: sum(r[0] for r in rows
                          if re.search(rf"flash_{kind}(_tc)?_kernel", r[2]))
                for kind in ("fwd", "dq", "dkv")}
    names = sorted({m.group(0) for r in rows
                    if (m := re.search(r"flash_(fwd|dq|dkv)(_tc)?_kernel",
                                       r[2]))})
    total_flash = sum(flash_us.values())
    print(f"[profile] train step (B=8, L=1024, bf16): wall_ms="
          f"{wall_us / 1e3:.4f} device_busy_ms={busy_us / 1e3:.4f} "
          f"busy_share={busy_us / wall_us:.4f} "
          f"flash_ms={total_flash / 1e3:.4f} "
          f"flash_share_of_device={total_flash / busy_us:.4f} "
          + " ".join(f"flash_{k}_ms={v / 1e3:.4f}"
                     for k, v in flash_us.items())
          + f" kernels_per_step={sum(r[1] for r in rows):.1f} "
          f"flash_kernels={','.join(names)}")
    for dev_us, count, key in rows[:8]:
        print(f"[profile]   {dev_us:9.2f} us/step x{count:<6.1f} {key[:80]}")


def _profile_decode(kv, label: str, steps: int = 16) -> None:
    """Where a decode step's time goes: ``steps`` decode iterations of the
    full table timed on the host clock, then the same again under
    ``torch.profiler`` for the device kernels' own time — the device's
    busy share of an unprofiled step, and the top kernels."""
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
    rows = _device_rows(prof, steps)
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print("[profile] no device time in the trace: not measured")
        return
    # the split kernel and, with more than one split, the combine kernel
    paged_us = sum(r[0] for r in rows
                   if re.search(r"paged_(attention|combine)_kernel", r[2]))
    print(f"[profile] {label} decode step (8 active slots): wall_ms="
          f"{wall_us / 1e3:.4f} device_busy_ms={busy_us / 1e3:.4f} "
          f"busy_share={busy_us / wall_us:.4f} "
          f"paged_attention_ms={paged_us / 1e3:.4f} "
          f"paged_attention_share_of_device={paged_us / busy_us:.4f} "
          f"kernels_per_step={sum(r[1] for r in rows):.1f}")
    for dev_us, count, key in rows[:8]:
        print(f"[profile]   {dev_us:9.2f} us/step x{count:<6.1f} {key[:80]}")


_MANGLED = {"f": "float", "13__nv_bfloat16": "bf16", "a": "int8",
            "Lb0E": "false", "Lb1E": "true"}


def _ptxas_lines(log: str):
    """One line per kernel of a ptxas -v report: registers and spills."""
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"\d+((?:flash|paged)_\w+?_kernel)I(.*?)EE?v",
                         block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if name and regs and spill:
            args = re.findall(r"Li(\d+)E|(Lb[01]E)|(13__nv_bfloat16|S1_|f|a)",
                              name.group(2))
            shown = [a[0] or _MANGLED.get(a[1] or a[2], "") for a in args]
            # S1_ repeats the first type argument
            shown = [x or shown[0] for x in shown]
            yield (f"{name.group(1)}<{', '.join(shown)}>: {regs.group(1)} "
                   f"registers, {spill.group(1)} bytes spill stores, "
                   f"{spill.group(2)} bytes spill loads")


def build_phase() -> None:
    """One nvcc per kernel source, all started together."""
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    jobs = {"paged_attention": pa.build,
            "flash_attention": functools.partial(fa.build, "simt"),
            "flash_attention_sm90": functools.partial(fa.build, "tc")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for fut in [pool.submit(fn) for fn in jobs.values()]:
            fut.result()
    for name in jobs:
        print(f"[build] {name}.cu built in "
              f"{_build.build_seconds[name]:.2f}s")
    print(f"[build] phase {time.perf_counter() - t0:.2f}s")
    for lib in ("flash_attention_sm90", "paged_attention"):
        for line in _ptxas_lines(_build.build_logs[lib]):
            print(f"[build] ptxas {line}")
    for d in (64, 128):
        print(f"[build] tc dynamic shared memory at head_dim {d}: "
              f"{fa.smem_bytes(d, 'tc')}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 parity on the card
    torch.backends.cudnn.allow_tf32 = False

    gpu = _device_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    build_phase()
    paged_errs = paged_check_phase()
    flash_errs = flash_check_phase()
    launches, int8_launches = serve_phase(gpu)
    fit, evaluate, steps = train_phase(gpu)
    # the timings last: each profiler session before the serve and train
    # windows would be in their host times
    paged_row = paged_timing_phase(paged_errs)
    # windows P and Q; the int8 sub-entry counts Q's int8-route launches
    paged_row["launches"] = launches
    paged_row["int8"]["launches"] = int8_launches
    flash_rows = flash_timing_phase(flash_errs)
    for row in flash_rows:
        kind = row["name"].rsplit(".", 1)[1]
        # the launches of this row's kernel: the tc count for a tc row
        counter = f"{kind}_tc" if row["variant"] == "tc" else kind
        row["launches"] = fit[counter] + evaluate[counter]
        print(f"[flash] {row['name']} ({row['variant']}) at the slice's "
              f"shape, device ms: kernel={row['ms']:.5f} "
              f"plain={row['plain_ms']:.5f} "
              f"library={row['library_ms']:.5f} "
              f"({row['library_backend']}) simt={row['simt_ms']:.5f}; "
              f"call ms: kernel={row['call_ms']:.5f}; "
              f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
              f"bound_share={row['bound_share']:.4f} "
              f"launches_per_train_step={fit[counter] / steps:.1f}")
    print(gpu)
    print(json.dumps({"kernels": [paged_row, *flash_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
