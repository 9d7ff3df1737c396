"""Paged decode/verify attention (port of ``ops/paged_attention.py``).

``paged_attention`` reads a physical KV block pool ``(num_blocks, block,
kv_heads, head_dim)`` through each slot's int32 block table without ever
gathering the ``(slots, max_len)`` K/V copy.  On a CUDA tensor it launches
the hand-written Hopper kernel in ``csrc/paged_attention.cu`` (the port of
the Pallas kernel ``_kernel``, ``pl.pallas_call`` at the JAX module's
``paged_attention``); on a CPU tensor it runs ``paged_attention_reference``,
the plain PyTorch version: gather, dequantize, widen, masked dense softmax.
A CUDA tensor never falls back to the plain version.

The kernel is split-key flash-decoding: one CTA per (slot, kv head, key
split), each split's f32 partial ``(m, l, acc)`` merged by a second small
kernel with weights ``exp(m_i - m)``.  ``_splits`` picks the split count
from the shapes alone; ``_split_reference`` is the plain version of the
split and the merge, which the tests hold to the one-pass version.

Query row ``r`` of a slot attends keys ``t <= pos + r`` (``l_q == 1`` is
the decode step, ``l_q == k + 1`` speculative verify).  The kernel trusts
the block table, as the TPU kernel does: every entry it reads must be a
valid pool index.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    dense_attention)

MAX_HEAD_DIM = 256
_SMEM_LIMIT = 232_448          # bytes of shared memory one Hopper CTA may use
# a split's K/V chunk is cut so that a CTA stays under this where it can
_SMEM_TARGET = 64 * 1024
_SMS = 132                     # streaming multiprocessors of an H100 SXM
_MIN_SPLIT_TOKENS = 32
_NEG_INF = -1e30
_TINY = 1e-30
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_attention_reference(q, k_pool, v_pool, block_tables, positions, *,
                              k_scale=None, v_scale=None, scale=None):
    """Plain PyTorch version: gather the pool through the block table,
    dequantize, widen kv heads, dense masked softmax in f32.  Same
    signature as ``paged_attention``."""
    s, l_q, h, d = q.shape
    n, blk, kvh, _ = k_pool.shape
    mb = block_tables.shape[1]
    bt = block_tables.long()
    keys = k_pool[bt].reshape(s, mb * blk, kvh, d)
    vals = v_pool[bt].reshape(s, mb * blk, kvh, d)
    if k_scale is not None:
        ks = k_scale[bt].reshape(s, mb * blk, kvh)
        vs = v_scale[bt].reshape(s, mb * blk, kvh)
        keys = keys.to(torch.float32) * ks[..., None]
        vals = vals.to(torch.float32) * vs[..., None]
    if kvh != h:
        keys = keys.repeat_interleave(h // kvh, dim=2)
        vals = vals.repeat_interleave(h // kvh, dim=2)
    t = torch.arange(mb * blk, device=q.device)
    valid = (t[None, None, :]
             <= positions.long()[:, None, None]
             + torch.arange(l_q, device=q.device)[None, :, None])
    out = dense_attention(q.to(torch.float32), keys.to(torch.float32),
                          vals.to(torch.float32), causal=False, scale=scale,
                          kv_mask=valid)
    return out.to(q.dtype)


def _split_ranges(n_live: int, splits: int) -> list[tuple[int, int]]:
    """Table entries ``[j0, j1)`` of each split of a slot with ``n_live``
    live entries (the kernel's rule): ``C = ceil(n_live / splits)``, split
    ``i`` owns ``[i C, (i + 1) C)`` clipped to ``n_live``."""
    per = -(-n_live // splits)
    return [(min(i * per, n_live), min((i + 1) * per, n_live))
            for i in range(splits)]


def _split_reference(q, k_pool, v_pool, block_tables, positions, *,
                     k_scale=None, v_scale=None, scale=None, splits=1):
    """Plain version of the kernel's split and merge: each split's f32
    partial ``(m, l, acc)`` over its table entries, with the kernel's
    masks (a masked score is -1e30; a split with no valid key for a row
    keeps ``m = -1e30``, an empty one ``l = 0``), then the merge with
    weights ``exp(m_i - m)``.  Same arguments as ``paged_attention`` and
    the split count."""
    s, l_q, h, d = q.shape
    _, blk, kvh, _ = k_pool.shape
    mb = block_tables.shape[1]
    g = h // kvh
    sm_scale = float(scale) if scale is not None else d ** -0.5
    # (S, KVH, GL, D): folded row r = g_i * l_q + li
    qf = (q.float().reshape(s, l_q, kvh, g, d).permute(0, 2, 3, 1, 4)
          .reshape(s, kvh, g * l_q, d))
    qoff = torch.arange(g * l_q, device=q.device) % l_q
    # table entries each slot reads: those holding a key t <= pos + l_q - 1
    n_live = ((positions.long() + l_q - 1) // blk + 1).clamp(max=mb).tolist()
    out = torch.empty(s, kvh, g * l_q, d, dtype=torch.float32,
                      device=q.device)
    for si in range(s):
        p0 = int(positions[si])
        parts = []
        for j0, j1 in _split_ranges(n_live[si], splits):
            if j0 == j1:
                parts.append((torch.full((kvh, g * l_q), _NEG_INF,
                                         device=q.device),
                              torch.zeros(kvh, g * l_q, device=q.device),
                              torch.zeros(kvh, g * l_q, d, device=q.device)))
                continue
            ids = block_tables[si, j0:j1].long()
            keys = k_pool[ids].float().reshape(-1, kvh, d)
            vals = v_pool[ids].float().reshape(-1, kvh, d)
            if k_scale is not None:
                keys = keys * k_scale[ids].reshape(-1, kvh, 1)
                vals = vals * v_scale[ids].reshape(-1, kvh, 1)
            sc = torch.einsum("hrd,thd->hrt", qf[si], keys) * sm_scale
            t = torch.arange(j0 * blk, j1 * blk, device=q.device)
            sc = torch.where(t[None, None, :] <= p0 + qoff[None, :, None],
                             sc, _NEG_INF)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hrt,thd->hrd", p,
                                                     vals)))
        m = torch.stack([pt[0] for pt in parts]).amax(0)
        w = [torch.exp(pt[0] - m) for pt in parts]
        lsum = sum(wi * pt[1] for wi, pt in zip(w, parts))
        acc = sum(wi[..., None] * pt[2] for wi, pt in zip(w, parts))
        out[si] = acc / lsum.clamp_min(_TINY)[..., None]
    return (out.reshape(s, kvh, g, l_q, d).permute(0, 3, 1, 2, 4)
            .reshape(s, l_q, h, d).to(q.dtype))


@functools.cache
def _library():
    from distributed_tensorflow_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    ptr = ctypes.c_void_p
    lib.paged_attention_launch.argtypes = (
        [ptr] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ptr])
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build (or load the already-built) kernel library now."""
    _library()


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(gl: int, d: int, blk: int, *, mb: int = 1, splits: int = 1,
               chunk: int = 1, kv_bytes: int = 4,
               quantized: bool = False) -> int:
    """Dynamic shared memory one CTA needs (mirrors ``layout`` in the CUDA
    source): q rows and acc (f32), m/l/corr, the split's block ids, the
    chunk's scores, 128 partial sums of P V, and per stage the chunk's K and
    V rows in the pool's type (and their int8 scales); one stage when a
    chunk holds a whole split.  A row of whole 16-byte chunks is padded to
    an odd number of them."""
    cmax = -(-mb // splits)
    stages = 1 if chunk >= cmax else 2
    keys = chunk * blk
    rb = d * kv_bytes
    rs = rb + 16 if rb % 16 == 0 and (rb // 16) % 2 == 0 else rb
    fixed = (2 * _a16(4 * gl * d) + _a16(12 * gl) + _a16(4 * cmax)
             + _a16(4 * gl * keys) + 4 * 128)
    stage = 2 * (_a16(keys * rs) + (_a16(4 * keys) if quantized else 0))
    return fixed + stages * stage


def _splits(slots: int, kv_heads: int, max_blocks: int, block: int) -> int:
    """Key splits per (slot, kv head), from the shapes alone: enough CTAs
    for about four per SM, but at least ``_MIN_SPLIT_TOKENS`` table tokens
    per split (a split's fixed cost, and the combine's, outweigh a shorter
    range), and at most one split per table entry; rounded down to a power
    of two.  Set from the split sweep of ``chip_smoke.py``, which times
    powers of two (PERF.md: at a 4096-token context 9 splits took 1.3x the
    time of 8)."""
    want = -(-4 * _SMS // (slots * kv_heads))
    n = max(1, min(want, max_blocks * block // _MIN_SPLIT_TOKENS,
                   max_blocks))
    return 1 << (n.bit_length() - 1)


@functools.lru_cache(maxsize=None)
def _plan(gl: int, d: int, blk: int, mb: int, splits: int, kv_bytes: int,
          quantized: bool) -> tuple[int, int]:
    """``(chunk, smem bytes)``: the most table entries a split stages at
    once such that the CTA stays under ``_SMEM_TARGET`` (a whole split where
    it fits, else two stages; at least one entry)."""
    kw = dict(mb=mb, splits=splits, kv_bytes=kv_bytes, quantized=quantized)
    cmax = -(-mb // splits)
    chunk = cmax
    while chunk > 1 and smem_bytes(gl, d, blk, chunk=chunk,
                                   **kw) > _SMEM_TARGET:
        chunk -= 1
    return chunk, smem_bytes(gl, d, blk, chunk=chunk, **kw)


def _check(q, k_pool, v_pool, block_tables, positions, k_scale, v_scale):
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError(f"q must be (slots, l_q, heads, head_dim) and pools "
                         f"(num_blocks, block, kv_heads, head_dim); got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    s, l_q, h, d = q.shape
    n, blk, kvh, dk = k_pool.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if h % kvh:
        raise ValueError(f"heads={h} not divisible by kv_heads={kvh}")
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q head_dim {d}")
    if block_tables.ndim != 2 or block_tables.shape[0] != s:
        raise ValueError(f"block_tables must be (slots={s}, max_blocks), "
                         f"got {tuple(block_tables.shape)}")
    if positions.shape != (s,):
        raise ValueError(f"positions must be (slots={s},), got "
                         f"{tuple(positions.shape)}")
    if k_scale is not None and (k_scale.shape != (n, blk, kvh)
                                or v_scale.shape != (n, blk, kvh)):
        raise ValueError(f"scales must be (num_blocks, block, kv_heads) = "
                         f"{(n, blk, kvh)}")
    quantized = k_scale is not None
    operands = [q, k_pool, v_pool, block_tables, positions]
    if quantized:
        operands += [k_scale, v_scale]
    if any(t.device != q.device for t in operands):
        raise ValueError("paged_attention operands must share one device")
    if any(not t.is_contiguous() for t in operands):
        raise ValueError("paged_attention operands must be contiguous")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype not in _KV_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share a dtype among float32, bfloat16 "
                        f"and int8; got {k_pool.dtype}/{v_pool.dtype}")
    if quantized != (k_pool.dtype == torch.int8):
        raise TypeError("int8 pools need k_scale/v_scale, and only int8 "
                        "pools take them")
    if quantized and (k_scale.dtype != torch.float32
                      or v_scale.dtype != torch.float32):
        raise TypeError("k_scale/v_scale must be float32")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("block_tables and positions must be int32")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim={d} exceeds the kernel's maximum "
                         f"{MAX_HEAD_DIM}")
    mb = block_tables.shape[1]
    _smem_check(h // kvh * l_q, d, blk, mb, _splits(s, kvh, mb, blk),
                k_pool.element_size(), quantized)


def _smem_check(gl, d, blk, mb, splits, kv_bytes, quantized):
    chunk, need = _plan(gl, d, blk, mb, splits, kv_bytes, quantized)
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"paged_attention needs {need} bytes of shared memory per CTA "
            f"(group x l_q = {gl} rows, head_dim {d}, block {blk}, "
            f"{chunk} table entries per chunk); the card allows "
            f"{_SMEM_LIMIT}")
    return chunk


def paged_attention(q, k_pool, v_pool, block_tables, positions, *,
                    k_scale=None, v_scale=None, scale=None):
    """Fused paged decode attention.

    Args:
      q: (slots, l_q, heads, head_dim) f32 or bf16 queries.
      k_pool, v_pool: (num_blocks, block, kv_heads, head_dim) pools, f32,
        bf16, or int8 with scales.
      block_tables: (slots, max_blocks) int32 pool block ids.
      positions: (slots,) int32 position of each slot's first query row.
      k_scale, v_scale: (num_blocks, block, kv_heads) f32 per-vector
        scales, given iff the pools are int8.
      scale: softmax scale; defaults to ``head_dim ** -0.5``.

    Returns (slots, l_q, heads, head_dim) in ``q.dtype``.  Each launch of
    the CUDA kernel adds one to ``paged_attention.launches``, and one on
    int8 pools also to ``paged_attention.int8_launches``.
    """
    _check(q, k_pool, v_pool, block_tables, positions, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, positions,
            k_scale=k_scale, v_scale=v_scale, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda (kernel) or cpu "
                         f"(plain version), got {q.device}")
    return _paged_cuda(q, k_pool, v_pool, block_tables, positions,
                       k_scale=k_scale, v_scale=v_scale, scale=scale)


def _paged_cuda(q, k_pool, v_pool, block_tables, positions, *,
                k_scale=None, v_scale=None, scale=None, splits=None):
    """The kernel on checked CUDA inputs, at ``splits`` key splits
    (default: ``_splits`` of the shapes).  One launch of the split kernel
    (and of the combine kernel when ``splits > 1``) counts as one."""
    s, l_q, h, d = q.shape
    blk, kvh = k_pool.shape[1], k_pool.shape[2]
    mb = block_tables.shape[1]
    quantized = k_scale is not None
    gl = h // kvh * l_q
    splits = splits or _splits(s, kvh, mb, blk)
    chunk = _smem_check(gl, d, blk, mb, splits, k_pool.element_size(),
                        quantized)
    lib = _library()
    out = torch.empty_like(q)
    part = (torch.empty(s * kvh * splits * gl * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    sm_scale = float(scale) if scale is not None else d ** -0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            s, l_q, h, kvh, d, blk, mb, splits, chunk, sm_scale,
            _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed with "
                           f"cudaError_t {err}")
    paged_attention.launches += 1
    paged_attention.int8_launches += quantized
    return out


paged_attention.launches = 0
paged_attention.int8_launches = 0
