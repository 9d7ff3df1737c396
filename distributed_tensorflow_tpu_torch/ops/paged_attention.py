"""Paged decode/verify attention (port of ``ops/paged_attention.py``).

``paged_attention`` reads a physical KV block pool ``(num_blocks, block,
kv_heads, head_dim)`` through each slot's int32 block table without ever
gathering the ``(slots, max_len)`` K/V copy.  On a CUDA tensor it launches
the hand-written Hopper kernel in ``csrc/paged_attention.cu`` (the port of
the Pallas kernel ``_kernel``, ``pl.pallas_call`` at the JAX module's
``paged_attention``); on a CPU tensor it runs ``paged_attention_reference``,
the plain PyTorch version: gather, dequantize, widen, masked dense softmax.
A CUDA tensor never falls back to the plain version.

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


@functools.cache
def _library():
    from distributed_tensorflow_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    ptr = ctypes.c_void_p
    lib.paged_attention_launch.argtypes = (
        [ptr] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int] * 2 + [ptr])
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build (or load the already-built) kernel library now."""
    _library()


def smem_bytes(gl: int, d: int, blk: int) -> int:
    """Dynamic shared memory one CTA needs (mirrors ``smem_bytes`` in the
    CUDA source)."""
    return 4 * (2 * gl * d + 2 * blk * d + gl * blk + 2 * gl)


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
    need = smem_bytes((h // kvh) * l_q, d, blk)
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"paged_attention needs {need} bytes of shared memory per CTA "
            f"(group x l_q = {(h // kvh) * l_q} rows, head_dim {d}, block "
            f"{blk}); the card allows {_SMEM_LIMIT}")


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
    the CUDA kernel adds one to ``paged_attention.launches``.
    """
    _check(q, k_pool, v_pool, block_tables, positions, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, positions,
            k_scale=k_scale, v_scale=v_scale, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda (kernel) or cpu "
                         f"(plain version), got {q.device}")
    s, l_q, h, d = q.shape
    blk, kvh = k_pool.shape[1], k_pool.shape[2]
    mb = block_tables.shape[1]
    quantized = k_scale is not None
    lib = _library()
    out = torch.empty_like(q)
    sm_scale = float(scale) if scale is not None else d ** -0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            s, l_q, h, kvh, d, blk, mb, sm_scale,
            _Q_DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed with "
                           f"cudaError_t {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
