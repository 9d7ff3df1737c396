"""Flash attention, forward and backward (port of ``ops/flash_attention.py``).

Exact ``softmax(scale·QKᵀ)V`` on model-layout ``(B, L, H, D)`` tensors,
with an optional causal mask (by absolute position) and an optional
``(B, Lk)`` key-validity mask, both writing ``NEG_INF = -1e30``.  On CUDA
tensors the hand-written Hopper kernels run — the ports of the Pallas
kernels ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``; on CPU
tensors the plain PyTorch versions ``_fwd_reference``/``_bwd_reference``
run (the math of the JAX package's ``_fwd_block_ref``/``_bwd_block_ref``,
in f32).  A CUDA tensor never falls back to a plain version.

Two routes, chosen by ``_route(dtype, head_dim)`` from the inputs alone:
``"tc"`` for bfloat16 with a head dim that is a multiple of 16 up to 128
(the GPT training path) runs the forward, dQ and dK/dV on Hopper's tensor
cores, ``csrc/flash_attention_sm90.cu``; ``"simt"`` (float32, and so
``flash_bwd_block``, and other head dims) runs ``csrc/flash_attention.cu``.
The ``tc`` kernels round P and dS to bf16 for their products: one rounding
more than the ``simt`` kernels' f32 P.

``flash_attention`` is differentiable through ``_FlashCore``, the
counterpart of the JAX ``_flash_core`` custom_vjp: the forward saves
``q, k, v, mask, out, lse``, the backward computes ``Δ = rowsum(dO∘O)`` in
f32 and runs the dQ and dK/dV kernels.  ``flash_fwd_block`` /
``flash_bwd_block`` are the same kernels without autograd, for the ring
schedules: per-block ``(out, lse)``, and per-block f32 gradients given the
global ``lse``/``Δ``.

A row whose keys are all masked gets the reference kernel's answer, not 0:
every masked score is ``-1e30``, so the row's weights are uniform over the
keys it visited (all ``Lk`` keys without the causal mask).  Under the
causal mask such a row's answer depends on which key tiles were visited,
in the JAX kernels as here; the GPT path never has one (a causal row always
sees its own position).

Launch counts (the main path's proof that it ran the kernels):
``flash_attention.fwd_launches``, ``.dq_launches`` and ``.dkv_launches``
over both routes, and ``.fwd_tc_launches``, ``.dq_tc_launches`` and
``.dkv_tc_launches`` for the ``tc`` route alone.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30   # matches parallel.ring_attention.NEG_INF
_TINY = 1e-30
MAX_HEAD_DIM = 256
_SMEM_LIMIT = 232_448          # bytes of shared memory one Hopper CTA may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------
# plain versions (the CPU path, and the kernels' yardstick on the card)
# --------------------------------------------------------------------------

def _scores(q, k, kv_mask, scale, causal):
    """f32 masked scores (B, H, Lq, Lk); ``kv_mask`` None = all valid."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(s.shape[-2], device=s.device)[:, None]
        kpos = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = torch.where(qpos >= kpos, s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    return s


def _fwd_reference(q, k, v, kv_mask, scale, causal):
    """Plain forward: ``(out (B, Lq, H, D) in q.dtype, lse (B, H, Lq) f32)``."""
    s = _scores(q, k, kv_mask, scale, causal)
    m = s.amax(dim=-1)                                      # (B, H, Lq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(_TINY)
    out = torch.einsum("bhlm,bmhd->blhd", p, v.float())
    out = out / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _bwd_reference(q, k, v, kv_mask, do, lse, delta, scale, causal):
    """Plain backward given the row statistics ``lse``/``delta`` (B, H, Lq):
    ``(dq, dk, dv)`` in f32."""
    s = _scores(q, k, kv_mask, scale, causal)
    p = torch.exp(s - lse[..., None])                       # (B, H, Lq, Lk)
    do32 = do.float()
    dv = torch.einsum("bhlm,blhd->bmhd", p, do32)
    dp = torch.einsum("blhd,bmhd->bhlm", do32, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k.float())
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.float())
    return dq, dk, dv


def _term_sums(q, k, v, kv_mask, do, lse, delta, scale, causal):
    """The sum of the absolute terms of each output of the plain versions,
    ``(out, dk, dv, dq)`` in f32: ``Σ_k p|v|`` (p normalized by lse),
    ``Σ_q |dS||q|``, ``Σ_q p|dO|`` and ``Σ_k |dS||k|``.  A kernel that
    rounds each P or dS to bf16 before the product is off by at most 2^-9
    times these."""
    s = _scores(q, k, kv_mask, scale, causal)
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dp = torch.einsum("blhd,bmhd->bhlm", do32, v.float())
    ds = (p * (dp - delta[..., None]) * scale).abs()
    return (torch.einsum("bhlm,bmhd->blhd", p, v.float().abs()),
            torch.einsum("bhlm,blhd->bmhd", ds, q.float().abs()),
            torch.einsum("bhlm,blhd->bmhd", p, do32.abs()),
            torch.einsum("bhlm,bmhd->blhd", ds, k.float().abs()))


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------

_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]


@functools.cache
def _library(route: str = "simt"):
    """The kernel library of ``route``: ``simt`` = ``flash_attention.cu``
    (fwd, dq, dkv; a dtype argument), ``tc`` = ``flash_attention_sm90.cu``
    (fwd, dq and dkv, bf16 only)."""
    from distributed_tensorflow_tpu_torch.ops import _build

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if route == "simt":
        lib = _build.load("flash_attention")
        tail = _TAIL + [i32, ptr]
        fns = {"fwd": 6, "dq": 8, "dkv": 9}
    else:
        lib = _build.load("flash_attention_sm90")
        tail = _TAIL + [ptr]
        fns = {"fwd_tc": 6, "dq_tc": 8, "dkv_tc": 9}
    for name, n_ptrs in fns.items():
        fn = getattr(lib, f"flash_{name}_launch")
        fn.argtypes = [ptr] * n_ptrs + tail
        fn.restype = i32
    return lib


def build(route: str | None = None) -> None:
    """Build (or load the already-built) kernel library of ``route``, or
    of both routes."""
    for r in ((route,) if route else ("simt", "tc")):
        _library(r)


def _route(dtype, head_dim: int) -> str:
    """``"tc"`` where the tensor-core kernels take the inputs (bfloat16, a
    head dim that is a multiple of 16 up to 128), else ``"simt"``."""
    if (dtype == torch.bfloat16 and head_dim % 16 == 0
            and 16 <= head_dim <= 128):
        return "tc"
    return "simt"


def _tiles(d: int, route: str = "simt") -> tuple[int, int, int]:
    """(BQ, BK, DT) the kernels of ``route`` use for head dim ``d``
    (mirrors ``by_head_dim`` / ``dispatch`` in the CUDA sources)."""
    if route == "tc":
        return 64, 64, (64 if d <= 64 else 128)
    if d <= 64:
        return 64, 64, 64
    if d <= 128:
        return 64, 64, 128
    return 32, 32, 256


def smem_bytes(d: int, route: str = "simt") -> dict[str, int]:
    """Dynamic shared memory each kernel of ``route`` needs per CTA at head
    dim ``d`` (mirrors ``Smem`` in the CUDA sources)."""
    bq, bk, dt = _tiles(d)
    ld, ldp = dt + 1, bk + 1
    simt = {"fwd": 4 * (bq * ld + 2 * bk * ld + bq * ldp + bk),
            "dq": 4 * (2 * bq * ld + 2 * bk * ld + bq * ldp + bk),
            "dkv": 4 * (2 * bk * ld + 2 * bq * ld + 2 * bq * ldp + bk
                        + 2 * bq)}
    if route == "simt":
        return simt
    if _route(torch.bfloat16, d) != "tc":
        raise ValueError(f"the tc route takes head dims that are multiples "
                         f"of 16 up to 128, not {d}")
    tile, _, dt = _tiles(d, "tc")
    row = 2 * tile * (dt + 8)              # one bf16 tile, rows padded by 8
    return {"fwd": row + 4 * row + 2 * tile * 4,
            "dq": 2 * row + 4 * row + 2 * tile * 4,
            "dkv": 2 * row + 4 * row + 4 * tile * 4}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    ``tc`` kernels copy 16 bytes at a time)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _launch(name, *tensors, dims, scale, causal, dtype, device):
    route = "tc" if name.endswith("_tc") else "simt"
    lib = _library(route)
    extra = () if route == "tc" else (_DTYPES[dtype],)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"flash_{name}_launch")(
            *(_ptr(t) for t in tensors), *dims, float(scale), int(causal),
            *extra, stream)
    if err:
        raise RuntimeError(f"flash_attention {name} kernel launch failed "
                           f"with cudaError_t {err}")


def _dims(q, k):
    return q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3]


def _fwd_cuda(q, k, v, mask, scale, causal, route=None):
    """The forward kernel of ``route`` (default: ``_route`` of the inputs)."""
    route = route or _route(q.dtype, q.shape[-1])
    b, lq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if route == "tc":
        q, k, v = (_aligned(x) for x in (q, k, v))
    _launch("fwd_tc" if route == "tc" else "fwd", q, k, v, mask, out, lse,
            dims=_dims(q, k), scale=scale, causal=causal, dtype=q.dtype,
            device=q.device)
    flash_attention.fwd_launches += 1
    if route == "tc":
        flash_attention.fwd_tc_launches += 1
    return out, lse


def _dq_cuda(q, k, v, mask, do, lse, delta, scale, causal, route=None):
    """The dQ kernel of ``route`` (default: ``_route`` of the inputs)."""
    route = route or _route(q.dtype, q.shape[-1])
    dq = torch.empty_like(q)
    if route == "tc":
        q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    _launch("dq_tc" if route == "tc" else "dq", q, k, v, mask, do, lse,
            delta, dq, dims=_dims(q, k), scale=scale, causal=causal,
            dtype=q.dtype, device=q.device)
    flash_attention.dq_launches += 1
    if route == "tc":
        flash_attention.dq_tc_launches += 1
    return dq


def _dkv_cuda(q, k, v, mask, do, lse, delta, scale, causal, route=None):
    """The dK/dV kernel of ``route`` (default: ``_route`` of the inputs)."""
    route = route or _route(q.dtype, q.shape[-1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if route == "tc":
        q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    _launch("dkv_tc" if route == "tc" else "dkv", q, k, v, mask, do, lse,
            delta, dk, dv, dims=_dims(q, k), scale=scale, causal=causal,
            dtype=q.dtype, device=q.device)
    flash_attention.dkv_launches += 1
    if route == "tc":
        flash_attention.dkv_tc_launches += 1
    return dk, dv


def _bwd_cuda(q, k, v, mask, do, lse, delta, scale, causal):
    return (_dq_cuda(q, k, v, mask, do, lse, delta, scale, causal),
            *_dkv_cuda(q, k, v, mask, do, lse, delta, scale, causal))


# --------------------------------------------------------------------------
# dispatch: CUDA tensors to the kernels, CPU tensors to the plain versions
# --------------------------------------------------------------------------

def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cuda (kernels) or cpu (plain "
                     f"versions), got {t.device}")


def _fwd(q, k, v, mask, scale, causal):
    if _on_cuda(q):
        return _fwd_cuda(q, k, v, mask, scale, causal)
    return _fwd_reference(q, k, v, mask, scale, causal)


def _bwd(q, k, v, mask, do, lse, delta, scale, causal):
    """Gradients in the input dtypes."""
    if _on_cuda(q):
        return _bwd_cuda(q, k, v, mask, do, lse, delta, scale, causal)
    dq, dk, dv = _bwd_reference(q, k, v, mask, do, lse, delta, scale, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, kv_mask, extra=()):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B, L, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k and v must be (B={b}, Lk, H={h}, D={d}); got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype among float32 and "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, k.shape[1]):
        raise ValueError(f"kv_mask must be (B, Lk) = {(b, k.shape[1])}, got "
                         f"{tuple(kv_mask.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim={d} exceeds the kernels' maximum "
                         f"{MAX_HEAD_DIM}")
    need = max(smem_bytes(d, _route(q.dtype, d)).values())
    if need > _SMEM_LIMIT:
        raise ValueError(f"flash attention needs {need} bytes of shared "
                         f"memory per CTA at head_dim {d}; the card allows "
                         f"{_SMEM_LIMIT}")
    operands = [q, k, v, *extra] + ([] if kv_mask is None else [kv_mask])
    if any(t.device != q.device for t in operands):
        raise ValueError("flash attention operands must share one device")


def _mask_f32(kv_mask):
    return (None if kv_mask is None
            else kv_mask.to(torch.float32).contiguous())


class _FlashCore(torch.autograd.Function):
    """Differentiable core: the forward kernel, and the dQ and dK/dV
    kernels as its backward (the JAX ``_flash_core`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, causal):
        out, lse = _fwd(q, k, v, mask, scale, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # Δ from the output as stored (bf16 for a bf16 model), in f32
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)
        dq, dk, dv = _bwd(q, k, v, mask, do, lse, delta.contiguous(),
                          ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, kv_mask=None,
                    block_q: int = 512, block_k: int = 1024):
    """Memory-efficient exact attention on model-layout tensors.

    Args:
      q: (B, Lq, H, D);  k, v: (B, Lk, H, D); float32 or bfloat16, one
        dtype for all three; head_dim up to 256.
      causal: mask future positions by absolute position.
      scale: softmax scale; defaults to ``head_dim ** -0.5``.
      kv_mask: optional (B, Lk) key-validity mask (>0 == valid).
      block_q / block_k: the TPU kernel's VMEM tile sizes, accepted for
        signature parity; the CUDA kernels pick their own tiles, and these
        do not change the result.

    Returns (B, Lq, H, D) in q's dtype, differentiable in q, k and v (the
    gradients come back in their dtypes).  Rows with no valid key: see the
    module docstring.
    """
    del block_q, block_k
    _check(q, k, v, kv_mask)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashCore.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            _mask_f32(kv_mask), scale, bool(causal))


flash_attention.fwd_launches = 0
flash_attention.dq_launches = 0
flash_attention.dkv_launches = 0
flash_attention.fwd_tc_launches = 0
flash_attention.dq_tc_launches = 0
flash_attention.dkv_tc_launches = 0


# --------------------------------------------------------------------------
# blockwise primitives for the ring schedules (not differentiable)
# --------------------------------------------------------------------------

def flash_fwd_block(q, k, v, kv_mask, *, scale, causal=False,
                    block_q: int = 512, block_k: int = 1024):
    """One flash forward over a (q-block, k-block) pair.

    q: (B, Lq, H, D); k/v: (B, Lk, H, D); kv_mask: (B, Lk) (>0 valid).
    Returns (out (B, Lq, H, D) in q.dtype, lse (B, H, Lq) f32).
    ``causal`` means the pair sits on the ring's diagonal.  ``block_q`` /
    ``block_k`` as in :func:`flash_attention`."""
    del block_q, block_k
    _check(q, k, v, kv_mask)
    return _fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                _mask_f32(kv_mask), float(scale), bool(causal))


def flash_bwd_block(q, k, v, kv_mask, do, lse, delta, *, scale,
                    causal=False, block_q: int = 512, block_k: int = 1024):
    """Per-block gradients given the GLOBAL softmax statistics.

    lse/delta: (B, H, Lq) — log-sum-exp of the FULL row and Σ_d do·out of
    the FULL output.  Returns (dq, dk, dv) in f32, each the contribution of
    this (q-block, k-block) pair alone.  Rows past a tile edge are masked
    inside the kernels, so no q padding (the TPU's ``lse = +1e30`` rows) is
    needed."""
    del block_q, block_k
    b, lq, h, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"do must match q {tuple(q.shape)}, got "
                         f"{tuple(do.shape)}")
    if lse.shape != (b, h, lq) or delta.shape != (b, h, lq):
        raise ValueError(f"lse and delta must be (B, H, Lq) = {(b, h, lq)}")
    f32 = [t.to(torch.float32).contiguous() for t in (q, k, v, do, lse, delta)]
    _check(*f32[:3], kv_mask, extra=f32[3:])
    q32, k32, v32, do32, lse32, delta32 = f32
    mask = _mask_f32(kv_mask)
    if _on_cuda(q32):
        return _bwd_cuda(q32, k32, v32, mask, do32, lse32, delta32,
                         float(scale), bool(causal))
    return _bwd_reference(q32, k32, v32, mask, do32, lse32, delta32,
                          float(scale), bool(causal))
