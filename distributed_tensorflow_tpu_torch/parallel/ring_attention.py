"""Sequence parallelism: ring attention and Ulysses all-to-all (port of
``parallel/ring_attention.py``), and the single-device dense attention.

A sequence longer than one device holds is sharded over the ``seq`` axis
of a (data, seq) mesh (``parallel/mesh.py``): rank ``idx`` of the axis
holds tokens ``[idx·L, (idx+1)·L)`` of every sequence of its batch rows,
and attention runs without any rank holding the whole (L, L) score matrix.
Each function here is called by every rank of the axis with its own block
and the mesh, where JAX calls it inside ``shard_map``.

* ``ring_attention``: K/V blocks rotate around the axis (``ring_shift``)
  while each rank's Q stays; partial softmax results merge with the
  running (max, sum, acc).  Plain tensor code, differentiated through the
  shifts' transposes.
* ``ring_flash_attention``: the same schedule, each (Q, K/V block)
  pairing on the flash kernels (``ops.flash_attention.flash_fwd_block``,
  ``flash_bwd_block``), the blocks merged on their (out, lse) pairs
  (``_merge_blocks``).  Its backward is a second ring (``_RingFlash``, the
  JAX ``custom_vjp``) in which dK/dV ride with their K/V block.  Causal
  masking needs no position offsets in the kernels: a pairing is entirely
  future (skipped, no launch), diagonal (the kernel's own causal mask) or
  entirely past (no mask).  ``ring_fwd_block``/``ring_bwd_block`` are one
  pairing's work, given the block's source rank ``src`` and this rank's
  ``idx``; the ring passes call them, and ``virtual_ring`` calls them for
  every (idx, step) of n virtual ranks in one process.
* ``ulysses_attention``/``ulysses_flash_attention``: one ``all_to_all``
  per tensor reshards (B, L/n, H, D) to (B, L, H/n, D), dense or flash
  attention runs on the whole sequence for H/n heads, and one reshards
  back.  Needs ``heads % n == 0``; the key mask is all-gathered.

``dense_attention`` is the gather path's attention in paged serving, the
math behind ``ops.paged_attention``'s plain version, and BERT's ``dense``
attention (with attention-probability dropout through ``prob_fn``; the
sequence-parallel attentions have no such hook, as in JAX).  Shapes follow
the JAX package: q/k/v are (batch, seq, heads, head_dim).
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel.mesh import SEQ_AXIS

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp() NaN-free when
                 # an entire row is masked


def dense_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    kv_mask=None, prob_fn=None):
    """Reference attention over (B, L, H, D) tensors, computed in q's dtype.

    ``kv_mask``: optional key-validity mask; masked keys get NEG_INF.
    (B, Lk) applies per batch row to every query; (B, Lq, Lk) applies per
    query (the multi-position decode step).
    ``prob_fn``: optional transform of the post-softmax probabilities
    (B, H, Lq, Lk): the hook for attention-probability dropout.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    # masked_fill takes the scalar as a kernel argument: no host-to-device
    # copy, so the read can be captured in a CUDA graph
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(lq, device=s.device)[:, None]
        kpos = torch.arange(lk, device=s.device)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    if kv_mask is not None:
        m = (kv_mask[:, None, :, :] if kv_mask.ndim == 3
             else kv_mask[:, None, None, :])
        s = s.masked_fill(~(m > 0), NEG_INF)
    p = torch.softmax(s, dim=-1)
    if prob_fn is not None:
        p = prob_fn(p)
    return torch.einsum("bhlm,bmhd->blhd", p, v)


def _row_stats(q, fill: float, dtype):
    """A (B, H, Lq) tensor of ``fill``."""
    b, lq, h, _ = q.shape
    return torch.full((b, h, lq), fill, dtype=dtype, device=q.device)


def ring_attention(q, k, v, mesh, axis: str = SEQ_AXIS, causal: bool = False,
                   scale: float | None = None, kv_mask=None):
    """Blockwise ring attention over the ``axis`` ring.

    Rank i holds Q/K/V of sequence block i.  At step t it attends Q_i
    against the K/V block that started on rank (i - t) mod n, after
    passing its current K/V on to rank i + 1 (rotate, then process: n - 1
    rotations).  The running (max, sum, acc) merge makes the result
    softmax(QKᵀ)V whatever the order of arrival.  Causal positions are
    global: query ``idx·Lq + j`` against key ``src·Lk + m``."""
    n, idx = coll.axis_size(mesh, axis), coll.axis_index(mesh, axis)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    lq, lk = q.shape[1], k.shape[1]
    mask = kv_mask if kv_mask is not None else k.new_ones(k.shape[:2])

    def process(t, m, l, acc, k_cur, v_cur, mk_cur):
        src = (idx - t) % n
        s = torch.einsum("blhd,bmhd->bhlm", q, k_cur) * scale
        if causal:
            qpos = idx * lq + torch.arange(lq, device=q.device)
            kpos = src * lk + torch.arange(lk, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        s = s.masked_fill(~(mk_cur[:, None, None, :] > 0), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))             # (B, H, Lq)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhlm,bmhd->blhd", p, v_cur)
        return m_new, l_new, acc * corr.transpose(1, 2)[..., None] + pv

    m = _row_stats(q, NEG_INF, q.dtype)
    l = _row_stats(q, 0.0, q.dtype)
    acc = torch.zeros_like(q)
    # block 0 (own K/V) costs no communication; the loop does the n - 1
    m, l, acc = process(0, m, l, acc, k, v, mask)
    k_cur, v_cur, mk_cur = k, v, mask
    for t in range(1, n):
        k_cur, v_cur, mk_cur = coll.ring_shift((k_cur, v_cur, mk_cur), mesh,
                                               axis=axis)
        m, l, acc = process(t, m, l, acc, k_cur, v_cur, mk_cur)
    # a row with no unmasked key (not under causal self-attention) gets 0
    return acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]


def _ulysses(q, k, v, mesh, axis, causal, scale, kv_mask, attn_fn):
    """The Ulysses reshard: (B, L/n, H, D) → (B, L, H/n, D) with one
    ``all_to_all`` per tensor, ``attn_fn`` on the whole sequence for H/n
    heads, and back."""
    n = coll.axis_size(mesh, axis)
    if q.shape[2] % n != 0:
        raise ValueError(
            f"num_heads {q.shape[2]} not divisible by axis size {n}")

    def to_heads(x):
        return coll.all_to_all(x, mesh, split_axis=2, concat_axis=1,
                               axis=axis)

    full_mask = None
    if kv_mask is not None:   # (B, L/n) → (B, L): every rank needs all keys
        full_mask = coll.all_gather(kv_mask, mesh, tiled=True, axis=axis,
                                    dim=1)
    out = attn_fn(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                  scale=scale, kv_mask=full_mask)
    return coll.all_to_all(out, mesh, split_axis=1, concat_axis=2, axis=axis)


def ulysses_attention(q, k, v, mesh, axis: str = SEQ_AXIS,
                      causal: bool = False, scale: float | None = None,
                      kv_mask=None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism with dense
    local attention (``_ulysses``)."""
    return _ulysses(q, k, v, mesh, axis, causal, scale, kv_mask,
                    dense_attention)


def ulysses_flash_attention(q, k, v, mesh, axis: str = SEQ_AXIS,
                            causal: bool = False, scale: float | None = None,
                            kv_mask=None):
    """The Ulysses reshard with the flash kernels as the local math: after
    the all-to-all each rank holds the whole sequence for H/n heads, the
    single-device flash case (``ops.flash_attention.flash_attention``,
    differentiable through its kernels)."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_attention)

    return _ulysses(q, k, v, mesh, axis, causal, scale, kv_mask,
                    flash_attention)


# ---------------------------------------------------------------------------
# ring attention on the flash kernels
# ---------------------------------------------------------------------------

def _merge_blocks(acc, lse, out_b, lse_b):
    """Merge (acc, lse) with a block's (out, lse), in f32: the softmax-
    weighted combination of the two."""
    lse_new = torch.logaddexp(lse, lse_b)
    alpha = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    beta = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return acc * alpha + out_b.float() * beta, lse_new


def _pairing(src: int, idx: int, causal: bool):
    """The pairing of this rank's Q (block ``idx``) with K/V block
    ``src``: None for an entirely future block (skipped), else the
    kernel's ``causal`` flag (True on the diagonal)."""
    if not causal:
        return False
    if src > idx:
        return None
    return src == idx


def ring_fwd_block(q, k, v, mask, *, src: int, idx: int, causal: bool,
                   scale: float):
    """One ring step's forward: ``(out, lse)`` of Q against the K/V block
    that started on rank ``src``: ``flash_fwd_block`` (with the causal
    mask on the diagonal), or for a future block zeros and an lse of
    NEG_INF, which the merge weighs by 0."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_fwd_block)

    diag = _pairing(src, idx, causal)
    if diag is None:
        return torch.zeros_like(q), _row_stats(q, NEG_INF, torch.float32)
    return flash_fwd_block(q, k, v, mask, scale=scale, causal=diag)


def ring_bwd_block(q, k, v, mask, do, lse, delta, *, src: int, idx: int,
                   causal: bool, scale: float):
    """One ring step's backward: this pairing's f32 ``(dq, dk, dv)`` given
    the whole rows' ``lse`` and ``delta`` (``flash_bwd_block``), or None
    for a future block."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import (
        flash_bwd_block)

    diag = _pairing(src, idx, causal)
    if diag is None:
        return None
    return flash_bwd_block(q, k, v, mask, do, lse, delta, scale=scale,
                           causal=diag)


def virtual_ring(q, k, v, mask, do, n: int, *, causal: bool, scale: float):
    """The ring-flash forward and backward of n virtual ranks in one
    process, through the ring's own per-block functions: rank idx holds
    block idx of q, k, v, mask and do, and at step t pairs its Q with block
    ``src = (idx - t) % n``, as the ring passes do.  The forward merges the
    pairings' (out, lse); the backward uses the merged rows' lse and
    Δ = Σ dO·O, and adds each pairing's (dk, dv) to block src's sums, which
    is what riding the ring gives.  Returns ``(out, lse, dq, dk, dv)`` over
    the whole sequence, the gradients in f32.  A check of the block
    kernels at the ring's shapes and branches on one device."""
    qs, ks, vs, ms, dos = (list(t.chunk(n, dim=1))
                           for t in (q, k, v, mask, do))
    outs, lses = [], []
    for idx in range(n):
        acc = torch.zeros(qs[idx].shape, dtype=torch.float32,
                          device=q.device)
        lse = _row_stats(qs[idx], NEG_INF, torch.float32)
        for t in range(n):
            src = (idx - t) % n
            out_b, lse_b = ring_fwd_block(qs[idx], ks[src], vs[src],
                                          ms[src], src=src, idx=idx,
                                          causal=causal, scale=scale)
            acc, lse = _merge_blocks(acc, lse, out_b, lse_b)
        outs.append(acc.to(q.dtype))
        lses.append(lse)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 2)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    deltas = delta.chunk(n, dim=2)
    dq = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in qs]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in ks]
    dv = [torch.zeros_like(x) for x in dk]
    for idx in range(n):
        for t in range(n):
            src = (idx - t) % n
            grads = ring_bwd_block(qs[idx], ks[src], vs[src], ms[src],
                                   dos[idx], lses[idx], deltas[idx],
                                   src=src, idx=idx, causal=causal,
                                   scale=scale)
            if grads is not None:
                dq[idx] += grads[0]
                dk[src] += grads[1]
                dv[src] += grads[2]
    return out, lse, torch.cat(dq, 1), torch.cat(dk, 1), torch.cat(dv, 1)


def _ring_flash_fwd_pass(q, k, v, mask, mesh, axis, causal, scale):
    n, idx = coll.axis_size(mesh, axis), coll.axis_index(mesh, axis)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = _row_stats(q, NEG_INF, torch.float32)
    k_cur, v_cur, mk_cur = k, v, mask
    for t in range(n):
        if t:   # block 0 (own K/V) costs no communication
            k_cur, v_cur, mk_cur = coll.ring_shift((k_cur, v_cur, mk_cur),
                                                   mesh, axis=axis)
        out_b, lse_b = ring_fwd_block(q, k_cur, v_cur, mk_cur,
                                      src=(idx - t) % n, idx=idx,
                                      causal=causal, scale=scale)
        acc, lse = _merge_blocks(acc, lse, out_b, lse_b)
    return acc.to(q.dtype), lse


def _ring_flash_bwd_pass(q, k, v, mask, lse, delta, do, mesh, axis, causal,
                         scale):
    n, idx = coll.axis_size(mesh, axis), coll.axis_index(mesh, axis)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur, mk_cur = k, v, mask
    for t in range(n):
        grads = ring_bwd_block(q, k_cur, v_cur, mk_cur, do, lse, delta,
                               src=(idx - t) % n, idx=idx, causal=causal,
                               scale=scale)
        if grads is not None:
            dq += grads[0]
            dk += grads[1]
            dv += grads[2]
        # dK/dV ride with their K/V block, so each rank adds its pairing's
        # share to the block's own accumulator; after the last pairing
        # only (dk, dv) make the final hop home
        if t < n - 1:
            k_cur, v_cur, mk_cur, dk, dv = coll.ring_shift(
                (k_cur, v_cur, mk_cur, dk, dv), mesh, axis=axis)
        elif n > 1:
            dk, dv = coll.ring_shift((dk, dv), mesh, axis=axis)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The ring on the flash kernels, forward and backward (the JAX
    ``_ring_flash`` custom_vjp): the forward saves (q, k, v, mask, out,
    lse); the backward computes Δ = Σ dO·O in f32, as ``_FlashCore``
    does, and runs the backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, mask, mesh, axis, causal, scale):
        out, lse = _ring_flash_fwd_pass(q, k, v, mask, mesh, axis, causal,
                                        scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.args = (mesh, axis, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)
        dq, dk, dv = _ring_flash_bwd_pass(q, k, v, mask, lse,
                                          delta.contiguous(), do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def ring_flash_attention(q, k, v, mesh, axis: str = SEQ_AXIS,
                         causal: bool = False, scale: float | None = None,
                         kv_mask=None):
    """Ring attention whose block math is the flash kernels: the contract
    of :func:`ring_attention`.  Entirely future causal blocks launch no
    kernel.  The forward runs in q's dtype (``tc`` for bf16/fp16, ``tc32``
    for f32); the backward's block kernels run in f32, as
    ``flash_bwd_block`` casts."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    mask = (kv_mask if kv_mask is not None
            else k.new_ones(k.shape[:2])).to(torch.float32).contiguous()
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            mask, mesh, axis, bool(causal), scale)


SEQ_PARALLEL = {"ring": ring_attention, "ring_flash": ring_flash_attention,
                "ulysses": ulysses_attention,
                "ulysses_flash": ulysses_flash_attention}


def require_seq_mesh(impl: str, mesh):
    """``mesh``, or a raise when a sequence-parallel model has none bound:
    without it the model would attend within its own block only."""
    if mesh is None:
        raise ValueError(
            f"attention_impl={impl!r} shards the sequence over the mesh's "
            f"'seq' axis, and this model has no mesh bound: train it with "
            f"SeqParallelEngine, which binds its mesh "
            f"(models.layers.bind_seq_mesh)")
    return mesh


def block_span(impl: str, mesh, lq: int) -> tuple[int, int]:
    """(the global position of this rank's first token, the global
    sequence length) of an ``lq``-token input: (0, lq) unless ``impl`` is
    sequence-parallel, where rank ``idx`` of the ``seq`` axis holds the
    block starting at ``idx·lq`` (JAX ``gpt.py:693-700``)."""
    if impl not in SEQ_PARALLEL:
        return 0, lq
    mesh = require_seq_mesh(impl, mesh)
    return mesh.axis_index(SEQ_AXIS) * lq, mesh.axis_size(SEQ_AXIS) * lq


def seq_parallel_attention(impl: str, q, k, v, mesh, *, causal: bool = False,
                           kv_mask=None):
    """``SEQ_PARALLEL[impl]`` over the ``seq`` axis of the mesh that the
    model's engine bound."""
    require_seq_mesh(impl, mesh)
    return SEQ_PARALLEL[impl](q, k, v, mesh, axis=SEQ_AXIS, causal=causal,
                              kv_mask=kv_mask)
