"""GPT-style decoder-only causal LM (port of ``models/gpt.py``).

Pre-LN transformer decoder, learned or rotary positions, grouped-query
attention (``kv_heads``), weight-tied LM head.  Ported paths:

* training/eval mode: causal attention over the whole sequence, dense
  (``attention_impl="dense"``) or through the flash kernels
  (``attention_impl="flash"``: ``ops.flash_attention``, the Hopper ports
  of the Pallas forward, dQ and dK/dV kernels); or over a sequence sharded
  on the ``seq`` axis of a mesh (``ring``, ``ring_flash``, ``ulysses``,
  ``ulysses_flash``: ``parallel.ring_attention``), where the input is this
  rank's token block, positions are global (the block starts at
  ``axis_index(seq) · L``), K/V are widened to the query heads before the
  schedule, and the mesh is the one ``SeqParallelEngine`` binds
  (``models.layers.bind_seq_mesh``);
* slot decode (the serving path, ``serving/kv_cache.py``): the caller
  passes per-slot ``positions`` (B, L) and one KV dict per layer in
  ``pools``, written in place.  Paged (``block_tables`` given): pools
  ``{"key_pool", "value_pool"}`` of (N, blk, KVH, D); each layer writes its
  K/V through the block table, then reads it back either fused
  (``ops.paged_attention``, the Hopper kernel) or gathered (block table
  gather + masked dense attention, the prefill path and the oracle).
  Monolithic (no ``block_tables``): rows ``{"cached_key", "cached_value"}``
  of (slots, T, KVH, D); the K/V of each (row, position) is written in
  place and every query attends its row under the mask ``t <= pos``.  A
  position at or past ``max_len`` is dropped, as the JAX scatter drops it.
  With ``T = max_len + 1`` (the serving table) the last column is a
  scratch column: every write lands, those at or past ``max_len`` in that
  column, at shapes fixed by the input's, so a decode step can be captured
  in a CUDA graph; the read covers the first ``max_len`` columns.  With
  ``T = max_len`` the in-table writes are selected on the host
  (``nonzero``: a data-dependent shape, which a capture cannot hold).
  Under int8 storage each dict also holds f32 scales (``key_scale_pool``/
  ``value_scale_pool`` (N, blk, KVH), or ``key_scale``/``value_scale``
  (slots, max_len, KVH)): K/V are encoded by ``parallel.compression``'s
  channel codec on write and decoded on read;
* cursor decode (``generate``): ``forward(ids, cache=cache)`` with the
  per-layer ``{"cached_key", "cached_value", "cache_index", "overflow"}``
  dicts of ``init_cache`` returns ``(logits, cache)``.  The K/V tensors are
  written in place; the returned dicts carry the advanced cursors and the
  sticky overflow flag (the dicts passed in are not changed).

Slot decode with ``by_column=True`` (the speculative verify) runs every
op whose arithmetic depends on the number of query rows -- the GEMMs of
the q/k/v/out projections, the FFN and the head, and the attention read --
once per query column, at the shape of a one-token decode step
(``_by_column``): cuBLAS, and the paged kernel, pick their summation order
by the row count, so a verify over ``slots x width`` rows would round
otherwise than the decode step it must equal.  Each verify column is then
bitwise the decode step at its prefix.

Flax's numerics are kept: parameters are stored in float32 and Dense/Embed
compute in the model ``dtype``; LayerNorm has epsilon 1e-6 and normalizes
in float32; GELU is the tanh approximation; logits are returned in f32.
Layouts are the JAX package's: activations (B, L, H, D), pools (N, blk,
KVH, D), block tables (S, MB) int32.  ``models/convert.py`` maps a flax
param tree onto this module's ``state_dict``.

Dropout draws its keep masks from the ``generator`` the caller passes to
``forward`` (the engine's ``TrainState`` generator); it cannot reproduce
flax's random bits.  ``remat=True`` checkpoints each ``GPTBlock`` in the
training/eval mode (``models.layers.remat``, flax ``nn.remat``): the same
parameters, the block's forward run again in the backward pass.

A sequence-parallel model does not decode in ``decode=True`` mode (JAX's
refusal: a one-token step has no sequence to shard); the cursor and slot
decode paths attend the cache densely whatever ``attention_impl`` is, as
JAX's ``generate`` and tables clone the model to dense attention.

``moe_experts > 0`` swaps every block's FFN for a routed MoE layer
(``models/moe.py``, ``moe_ffn``) over the block's tokens, with
``moe_top_k`` and ``moe_capacity_factor``; the router's losses are left on
the layers (``engines.expert_parallel.router_losses``).  Every mode runs
it, and routes the tokens of one call together (a verify's ``by_column``
does not split it), as JAX does; ``generate`` prefills a MoE model's
prompt one token at a time, as JAX's scan does, since the tokens of one
call share the experts' capacity.

``partition_model=True`` lays the model out as JAX's Megatron
annotations do (JAX ``gpt.py:137-150, 254-260, 549-559, 709-714,
757-770``): column-parallel query, key and value, row-parallel ``out``,
column-parallel ``fc1`` and row-parallel ``fc2``, a vocab-parallel token
embedding and the tied head as its ``attend`` (or a column-parallel
untied ``lm_head`` with its bias whole), ``models/layers.py``.  Unbound
the layers are the plain ones; ``TensorParallelEngine`` (or ``FSDPEngine``
on a (data, model) mesh) binds its mesh (``bind_model_mesh``) and each
rank keeps its slice: ``heads/tp`` query and ``kv_heads/tp`` K/V heads,
which run the dense or flash attention on the local heads.  The head's
vocab-sharded logits are all-gathered (``gather_from_model``) and the
loss runs on the whole logits.  ``pos_embed`` and the LayerNorms stay
whole, as do a MoE block's experts unless ``partition_experts`` lets the
composite engine cut them (with ``partition_model``, the 2-D expert
layout, ``models/moe.py``).  A packed width that does not split over
'model' raises JAX's error; heads or kv_heads that do not split (whose
widths do) keep the attention whole on every rank.  Under
``CompositeEngine`` the Megatron layers carry ring or Ulysses attention
over 'seq' on the rank's local heads (Ulysses needs them to split over
the 'seq' axis).

``gpt_pipeline_stages`` (``GPTPipeEmbed``, ``GPTPipeBlock``,
``GPTPipeHead``) splits the decoder for ``engines.pipeline``: token (and
learned position) embeddings, ``layers_per_stage`` dropout-free blocks a
stage (dense or flash attention, RoPE rotated inside each block), and a
final LN with an untied head.  ``partition_model`` (pp×tp) gives them
the Megatron layout (a vocab-parallel token table, the blocks' layers,
a vocab-column-parallel head whose logits are gathered whole); a
``seq_axis`` with ring or Ulysses attention (pp×sp) makes the carry this
rank's token block, its positions global.  ``moe_experts`` (pp×ep)
gives every block of a stage the routed MoE FFN (with
``partition_experts`` its experts cut over 'expert', under
``partition_model`` the 2-D expert layout), whose router terms the
engine reads after each tick.  ``unbound()`` builds a stage's whole twin
without a mesh (its MoE FFN whole), which ``PipelineEngine.eval_params``
evaluates and decodes with.

A bound model decodes too (TP decode, JAX ``generate(mesh=...)`` and
the mesh-sharded tables): the cursor, slot and paged reads run on the
rank's ``heads/tp`` query and ``kv_heads/tp`` K/V heads, whose caches
and pools hold those heads only (``init_cache`` and the tables size them
from the attention blocks), the row-parallel ``out`` and ``fc2`` sum over
'model' and the head gathers whole logits, so every rank of a 'model'
group samples the same token.  With ``by_column`` a row-parallel layer
runs, and sums, one query column at a time, at the decode step's shape.
``generate(mesh=...)`` splits the batch over 'data' and keeps the
Megatron cut over 'model' (module function).
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import resolve_device
from distributed_tensorflow_tpu_torch.models.layers import (
    LN_EPS, ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    bind_model_mesh, check_divisible, dense as _dense, dropout as _dropout,
    flax_init_, layer_norm as _layer_norm, remat as _remat, unbound_kw)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.models.moe import MoELayer, moe_ffn
from distributed_tensorflow_tpu_torch.parallel.compression import (
    int8_channel_decode, int8_channel_encode)
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel.mesh import SEQ_AXIS
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    SEQ_PARALLEL, block_span, dense_attention, seq_parallel_attention)


def _by_column(fn, *xs):
    """``fn`` of each query column ``(x[:, j:j+1] for x in xs)`` on its
    own, as contiguous (B, 1, ...) tensors, joined along dim 1: the shapes
    and layouts of a one-token decode step."""
    return torch.cat([fn(*(x[:, j:j + 1].contiguous() for x in xs))
                      for j in range(xs[0].shape[1])], dim=1)


def _dense_by(lin, x, dtype, by_column: bool):
    """``dense``, or with ``by_column`` one ``F.linear`` per query column
    over the weights cast once.  A row-parallel layer runs its own forward
    (its partial products summed over 'model' when bound), by column one
    call per column, so that each sum has a decode step's shape."""
    if isinstance(lin, RowParallelLinear):
        return (_by_column(lambda c: lin(c, dtype), x) if by_column
                else lin(x, dtype))
    if not by_column:
        return _dense(lin, x, dtype)
    w = lin.weight.to(dtype)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return _by_column(lambda c: F.linear(c.to(dtype), w, bias), x)


def apply_rope(x, pos, base: float = 10000.0):
    """Rotary position embedding over the head dim (half-split layout).

    ``x``: (B, L, H, D) with D even; ``pos``: (B, L) or (1, L) absolute
    positions.  Computed in f32, returned in ``x``'s dtype."""
    d2 = x.shape[-1] // 2
    inv = base ** (-torch.arange(d2, dtype=torch.float32, device=x.device)
                   / d2)
    ang = pos.to(torch.float32)[..., None] * inv         # (B, L, D/2)
    cos = torch.cos(ang)[:, :, None, :]                  # (B, L, 1, D/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention: dense, flash or sequence-parallel
    (training/eval), or slot/cursor decode."""

    seq_mesh = None   # the mesh of a sequence-parallel model (bind_seq_mesh)
    tp_mesh = None    # the mesh of a tensor-parallel model (bind_tp)

    def __init__(self, hidden: int, heads: int, kv_heads: int | None = None,
                 rope: bool = False, dtype=torch.float32, device=None,
                 attention_impl: str = "dense",
                 partition_model: bool = False):
        super().__init__()
        kvh = kv_heads if kv_heads is not None else heads
        if kvh < 1 or heads % kvh:
            raise ValueError(f"kv_heads must be a positive divisor of heads "
                             f"{heads}, got {kvh}")
        self.hidden, self.heads, self.kv_heads = hidden, heads, kvh
        self.head_dim = hidden // heads
        self.rope = rope
        self.dtype = dtype
        self.attention_impl = attention_impl
        col = ColumnParallelLinear if partition_model else nn.Linear
        self.query = col(hidden, heads * self.head_dim, device=device)
        self.key = col(hidden, kvh * self.head_dim, device=device)
        self.value = col(hidden, kvh * self.head_dim, device=device)
        self.out = (RowParallelLinear if partition_model else nn.Linear)(
            heads * self.head_dim, hidden, device=device)

    def bind_tp(self, mesh, prefix: str = "") -> None:
        """Column-parallel query, key and value (``heads/tp`` query and
        ``kv_heads/tp`` K/V heads on each rank), row-parallel ``out``.
        JAX's refusals come first: a packed projection width that does
        not split over 'model'.  The heads split as
        ``parallel.mesh.kv_slot_sharding`` cuts a KV leaf's: where the
        widths split but the heads do not (``kv_slot_sharding`` leaves
        them whole; GSPMD cuts a head across ranks and reshards around the
        attention), the attention stays whole on every rank: its
        parameters replicated, its work repeated, no collective."""
        if not isinstance(self.query, ColumnParallelLinear) or \
                self.tp_mesh is not None:
            return
        tp = mesh.axis_size("model")
        for name in ("query", "key", "value"):
            lin = getattr(self, name)
            check_divisible(f"{prefix}.{name}.weight", lin.whole["weight"],
                            0, tp)
        check_divisible(f"{prefix}.out.weight", self.out.whole["weight"], 1,
                        tp)
        _, kv = meshlib.kv_slot_sharding(mesh, 0, self.kv_heads, self.heads)
        if kv.stop - kv.start != self.kv_heads // tp:
            return
        for name in ("query", "key", "value"):
            getattr(self, name).bind(mesh, f"{prefix}.{name}")
        self.out.bind(mesh, f"{prefix}.out")
        self.heads, self.kv_heads = self.heads // tp, self.kv_heads // tp
        self.tp_mesh = mesh

    def _widen(self, t):
        """kv_heads → heads by group broadcast (no-op for MHA)."""
        if self.kv_heads == self.heads:
            return t
        return t.repeat_interleave(self.heads // self.kv_heads, dim=2)

    def forward(self, x, pos=None, pool=None, block_tables=None,
                paged_fused: bool = True, cache=None, keep=None,
                by_column: bool = False):
        if self.rope and pos is None:
            raise ValueError("rope=True needs the caller to pass positions")
        b, lq, _ = x.shape
        if self.tp_mesh is not None:
            x = coll.copy_to_model(x, self.tp_mesh)
        q = _dense_by(self.query, x, self.dtype, by_column).reshape(
            b, lq, self.heads, self.head_dim)
        k = _dense_by(self.key, x, self.dtype, by_column).reshape(
            b, lq, self.kv_heads, self.head_dim)
        v = _dense_by(self.value, x, self.dtype, by_column).reshape(
            b, lq, self.kv_heads, self.head_dim)
        if self.rope:
            q, k = apply_rope(q, pos), apply_rope(k, pos)
        if cache is not None:
            out = self._cursor_attend(q, k, v, cache)
        elif pool is not None and block_tables is not None:
            out = self._paged_attend(q, k, v, pos, pool, block_tables,
                                     paged_fused, by_column)
        elif pool is not None:
            out = self._slot_attend(q, k, v, pos, pool, keep, by_column)
        elif self.attention_impl == "flash":
            from distributed_tensorflow_tpu_torch.ops.flash_attention import (
                flash_attention)
            out = flash_attention(q, self._widen(k), self._widen(v),
                                  causal=True)
        elif self.attention_impl in SEQ_PARALLEL:
            out = seq_parallel_attention(self.attention_impl, q,
                                         self._widen(k), self._widen(v),
                                         self.seq_mesh, causal=True)
        else:
            out = dense_attention(q, self._widen(k), self._widen(v),
                                  causal=True)
        out = out.reshape(b, lq, self.heads * self.head_dim)
        return _dense_by(self.out, out, self.dtype, by_column)

    def _read(self, q, keys, vals, valid, by_column):
        """``_masked_read``, by query column with ``by_column``."""
        if not by_column:
            return self._masked_read(q, keys, vals, valid)
        return _by_column(
            lambda qc, vc: self._masked_read(qc, keys, vals, vc), q, valid)

    def _masked_read(self, q, keys, vals, valid):
        """Dense attention of ``q`` over (B, T, KVH, D) keys/values under
        a per-query (B, Lq, T) validity mask, in the promotion of q's and
        the cache's dtypes, widened to ``heads`` after the cache (as the
        JAX package does); returned in the model dtype."""
        ct = torch.promote_types(q.dtype, keys.dtype)
        return dense_attention(q.to(ct), self._widen(keys.to(ct)),
                               self._widen(vals.to(ct)), causal=False,
                               kv_mask=valid).to(self.dtype)

    def _encode(self, k, v, store):
        """K/V in the storage form: ``(k, v)`` cast to ``store``, or under
        int8 ``(qk, qv, sk, sv)`` from the channel codec."""
        if store == torch.int8:
            (qk, sk), (qv, sv) = int8_channel_encode(k), int8_channel_encode(v)
            return qk, qv, sk, sv
        return k.to(store), v.to(store)

    def _slot_attend(self, q, k, v, pos, rows, keep, by_column=False):
        """Monolithic slot decode: write, then masked dense read.

        ``rows`` holds (B, T, KVH, D) ``cached_key``/``cached_value`` (and
        under int8 the (B, T, KVH) f32 ``key_scale``/``value_scale``).
        Each (row, position) K/V vector is written in place.  ``keep`` is
        None when the table's last column is a scratch column: positions
        at or past ``T - 1`` are written there.  Otherwise it is the
        ``(row, column)`` selection of the positions inside the table, and
        the others are dropped.  Every query then attends its row's real
        columns ``t <= pos``, its own K/V included."""
        ck, cv = rows["cached_key"], rows["cached_value"]
        idx = pos.long()
        names = ("cached_key", "cached_value", "key_scale", "value_scale")
        if keep is None:
            t = ck.shape[1] - 1
            r = torch.arange(idx.shape[0], device=idx.device)[:, None]
            at = idx.clamp(max=t)
            enc = self._encode(k, v, ck.dtype)
        else:
            t = ck.shape[1]
            r, c = keep
            at = idx[r, c]
            enc = self._encode(k[r, c], v[r, c], ck.dtype)
        for name, val in zip(names, enc):
            rows[name][r, at] = val
        ck, cv = ck[:, :t], cv[:, :t]
        if ck.dtype == torch.int8:
            keys = int8_channel_decode(ck, rows["key_scale"][:, :t],
                                       self.dtype)
            vals = int8_channel_decode(cv, rows["value_scale"][:, :t],
                                       self.dtype)
        else:
            keys, vals = ck, cv
        valid = (torch.arange(t, device=q.device)[None, None, :]
                 <= idx[:, :, None])
        return self._read(q, keys, vals, valid, by_column)

    def _cursor_attend(self, q, k, v, cache):
        """Cursor decode (``generate``): write this call's L K/V vectors at
        the layer's cursor, attend the whole cache under ``t <= i + j`` for
        query ``j``, advance the cursor by L.  Past capacity the write
        start is clamped to ``max_len - L`` (JAX's ``dynamic_update_slice``
        clamp) and the sticky ``overflow`` flag turns true.  Updates the
        layer's dict in place (``GPTLM.forward`` passes a copy)."""
        ck, cv = cache["cached_key"], cache["cached_value"]
        t, lq = ck.shape[1], q.shape[1]
        i = cache["cache_index"]
        steps = torch.arange(lq, device=q.device)
        at = i.clamp(max=t - lq) + steps
        ck.index_copy_(1, at, k.to(ck.dtype))
        cv.index_copy_(1, at, v.to(cv.dtype))
        cache["overflow"] = cache["overflow"] | (i + lq > t)
        cache["cache_index"] = i + lq
        valid = (torch.arange(t, device=q.device)[None, None, :]
                 <= (i + steps)[None, :, None]).expand(q.shape[0], -1, -1)
        return self._masked_read(q, ck, cv, valid)

    def _paged_attend(self, q, k, v, pos, pool, block_tables, fused,
                      by_column=False):
        """Paged KV write, then read (fused kernel or gather + dense).

        Writes scatter each (row, position) K/V vector into
        ``pool[bt[row, pos // blk], pos % blk]`` in place.  A position past
        the table (a pad position beyond max_len) must be dropped, as the
        JAX scatter drops it; ``index_put_`` would raise or wrap instead, so
        such writes are routed to the pool's LAST block, the scratch block
        that no live table entry maps (``PagedSlotKVCache``'s pool is
        ``num_blocks + 1`` blocks for this reason).  The current token's
        K/V is written before the read, so ``t <= pos`` includes it."""
        if block_tables is None:
            raise ValueError(
                "paged decode needs block_tables (B, max_blocks) — the "
                "serving engine passes each slot's block table")
        kp, vp = pool["key_pool"], pool["value_pool"]
        ksp, vsp = pool.get("key_scale_pool"), pool.get("value_scale_pool")
        blk, mb = kp.shape[1], block_tables.shape[1]
        idx = pos.long()                                   # (B, L)
        j = idx // blk
        oob = j >= mb
        bt = block_tables.long()
        blk_ids = torch.gather(bt, 1, j.clamp(max=mb - 1))
        blk_ids = torch.where(oob, kp.shape[0] - 1, blk_ids)
        off = idx % blk
        enc = self._encode(k, v, kp.dtype)
        for dst, val in zip((kp, vp, ksp, vsp), enc):
            dst[blk_ids, off] = val
        if fused:
            from distributed_tensorflow_tpu_torch.ops.paged_attention import (
                paged_attention)

            def read(qc, pc):
                return paged_attention(
                    qc.contiguous(), kp, vp, block_tables,
                    pc[:, 0].to(torch.int32).contiguous(), k_scale=ksp,
                    v_scale=vsp).to(self.dtype)

            return _by_column(read, q, pos) if by_column else read(q, pos)
        # gather the logical table back through the block table and run
        # masked dense attention; rows from unmapped entries sit past the
        # validity mask
        b = q.shape[0]
        t = mb * blk
        shape = (b, t, self.kv_heads, self.head_dim)
        keys, vals = kp[bt].reshape(shape), vp[bt].reshape(shape)
        if ksp is not None:
            keys = int8_channel_decode(keys, ksp[bt].reshape(shape[:3]),
                                       self.dtype)
            vals = int8_channel_decode(vals, vsp[bt].reshape(shape[:3]),
                                       self.dtype)
        valid = (torch.arange(t, device=q.device)[None, None, :]
                 <= idx[:, :, None])
        return self._read(q, keys, vals, valid, by_column)


class GPTBlock(nn.Module):
    """Pre-LN decoder block: x + attn(LN(x)); x + ffn(LN(x))."""

    tp_mesh = None    # the mesh of a tensor-parallel FFN (bind_tp)

    def __init__(self, hidden: int, heads: int, ffn: int,
                 dropout_rate: float = 0.1, rope: bool = False,
                 kv_heads: int | None = None, dtype=torch.float32,
                 device=None, attention_impl: str = "dense",
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25,
                 partition_model: bool = False,
                 partition_experts: bool = False):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.attn = CausalSelfAttention(hidden, heads, kv_heads, rope, dtype,
                                        device, attention_impl,
                                        partition_model)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.moe = None
        if moe_experts > 0:
            # the 2-D expert layout needs the expert cut first (JAX
            # gpt.py:540-546)
            self.moe = MoELayer(hidden, moe_experts, ffn,
                                moe_capacity_factor, moe_top_k,
                                partition_experts,
                                partition_model and partition_experts,
                                dtype=dtype, device=device)
        elif partition_model:
            self.fc1 = ColumnParallelLinear(hidden, ffn, device=device)
            self.fc2 = RowParallelLinear(ffn, hidden, device=device)
        else:
            self.fc1 = nn.Linear(hidden, ffn, device=device)
            self.fc2 = nn.Linear(ffn, hidden, device=device)

    def bind_tp(self, mesh, prefix: str = "") -> None:
        """The Megatron FFN: column-parallel ``fc1``, row-parallel
        ``fc2``.  A MoE block's experts are the composite engine's to cut
        (``models.moe.shard_experts``): whole on every rank unless
        ``partition_experts``."""
        if isinstance(getattr(self, "fc1", None), ColumnParallelLinear):
            self.fc1.bind(mesh, f"{prefix}.fc1")
            self.fc2.bind(mesh, f"{prefix}.fc2")
            self.tp_mesh = mesh

    def forward(self, x, train: bool = False, pos=None, pool=None,
                block_tables=None, paged_fused: bool = True, generator=None,
                cache=None, keep=None, by_column: bool = False):
        y = self.attn(_layer_norm(self.ln1, x, self.dtype), pos, pool,
                      block_tables, paged_fused, cache, keep, by_column)
        x = x + _dropout(y, self.dropout_rate, train, generator)
        y = _layer_norm(self.ln2, x, self.dtype)
        if self.moe is not None:
            # routed over all the call's tokens, as JAX routes them
            y = moe_ffn(self.moe, y)
        else:
            if self.tp_mesh is not None:
                y = coll.copy_to_model(y, self.tp_mesh)
            y = F.gelu(_dense_by(self.fc1, y, self.dtype, by_column),
                       approximate="tanh")
            y = _dense_by(self.fc2, y, self.dtype, by_column)
        return x + _dropout(y, self.dropout_rate, train, generator)


class GPTLM(nn.Module):
    """Decoder-only causal LM: token ids (B, L) → next-token logits (B, L, V)
    in f32.

    ``forward(ids, train=..., generator=...)`` is the training/eval mode
    (``generator`` feeds dropout when ``train``).  ``forward(ids,
    positions=..., pools=...)`` is slot decode: ``pools`` holds one KV
    dict per layer, written in place — paged pools with ``block_tables``
    (``paged_fused`` picks the kernel read or the gather read), monolithic
    rows without; ``by_column`` runs the row-count-dependent ops one
    query column at a time (the verify; module docstring).
    ``forward(ids, cache=...)`` is cursor decode and returns ``(logits,
    cache)`` (module docstring).  ``decode=True`` marks
    a model that only decodes: its forward needs ``cache=``.  Under a
    sequence-parallel ``attention_impl`` the training/eval mode takes this
    rank's token block of the sequence (module docstring)."""

    causal_lm = True   # (B, L) next-token targets: engines read it
    seq_mesh = None    # the mesh of a sequence-parallel model
    tp_mesh = None     # the mesh of a tensor-parallel model (bind_tp)

    def __init__(self, vocab_size: int = 256, hidden: int = 128,
                 layers: int = 2, heads: int = 4, ffn: int = 512,
                 max_len: int = 512, dropout_rate: float = 0.1,
                 attention_impl: str = "dense", positional: str = "learned",
                 kv_heads: int | None = None, tie_embeddings: bool = True,
                 dtype=torch.float32, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                 remat: bool = False, partition_model: bool = False,
                 partition_experts: bool = False, decode: bool = False,
                 device=None):
        super().__init__()
        if remat and moe_experts:
            raise ValueError(
                "remat + MoE blocks is unsupported: the router's sown "
                "intermediates (aux_loss/z_loss/overflow) would be re-sown "
                "during backward recompute, double-counting the balance "
                "losses; train MoE blocks without --remat")
        if attention_impl not in ("dense", "flash", *SEQ_PARALLEL):
            raise ValueError(f"unknown attention_impl '{attention_impl}'; "
                             f"dense | flash, or one of "
                             f"{tuple(SEQ_PARALLEL)}")
        if decode and attention_impl in SEQ_PARALLEL:
            # JAX gpt.py:655-669
            raise ValueError(
                "decode mode is incompatible with sequence-parallel "
                "attention (ring/ring_flash/ulysses run in shard_map "
                "over 'seq'; a 1-token step has no sequence to shard); "
                "clone with attention_impl='dense' — `generate` does "
                "this.  partition_model decode IS supported (GSPMD).")
        if positional not in ("learned", "rope"):
            raise ValueError(
                f"unknown positional '{positional}'; learned | rope")
        device = resolve_device(device)
        self._kw = dict(
            vocab_size=vocab_size, hidden=hidden, layers=layers, heads=heads,
            ffn=ffn, max_len=max_len, dropout_rate=dropout_rate,
            attention_impl=attention_impl, positional=positional,
            kv_heads=kv_heads, tie_embeddings=tie_embeddings, dtype=dtype,
            moe_experts=moe_experts, moe_top_k=moe_top_k,
            moe_capacity_factor=moe_capacity_factor, remat=remat,
            partition_model=partition_model,
            partition_experts=partition_experts, decode=decode,
            device=device)
        self.vocab_size, self.hidden, self.layers = vocab_size, hidden, layers
        self.heads, self.ffn, self.max_len = heads, ffn, max_len
        self.kv_heads = kv_heads if kv_heads is not None else heads
        self.dropout_rate = dropout_rate
        self.attention_impl = attention_impl
        self.remat = remat
        self.moe_experts = moe_experts
        self.partition_experts = partition_experts
        self.decode = bool(decode)
        self.positional = positional
        self.tie_embeddings = tie_embeddings
        self.dtype = dtype
        self.partition_model = partition_model
        rope = positional == "rope"
        self.token_embed = (VocabParallelEmbedding if partition_model
                            else nn.Embedding)(vocab_size, hidden,
                                               device=device)
        self.pos_embed = (None if rope
                          else nn.Embedding(max_len, hidden, device=device))
        self.blocks = nn.ModuleList(
            GPTBlock(hidden, heads, ffn, dropout_rate, rope, kv_heads, dtype,
                     device, attention_impl, moe_experts, moe_top_k,
                     moe_capacity_factor, partition_model, partition_experts)
            for _ in range(layers))
        self.ln_f = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.lm_head = (
            None if tie_embeddings
            else ColumnParallelLinear(hidden, vocab_size, shard_bias=False,
                                      device=device) if partition_model
            else nn.Linear(hidden, vocab_size, device=device))

    def bind_tp(self, mesh, prefix: str = "") -> None:
        """The vocab-parallel token embedding and the column-parallel
        untied head (its bias whole, as JAX leaves it unannotated); the
        blocks bind their own layers.  ``pos_embed`` and the LayerNorms
        stay whole."""
        if not self.partition_model or self.tp_mesh is not None:
            return
        self.token_embed.bind(mesh, f"{prefix}.token_embed".lstrip("."))
        if self.lm_head is not None:
            self.lm_head.bind(mesh, f"{prefix}.lm_head".lstrip("."))
        self.tp_mesh = mesh

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initializers, drawn from ``generator`` (``flax_init_``)."""
        return flax_init_(self, generator)

    def unbound(self) -> "GPTLM":
        """A fresh whole twin of this model, with no mesh and no Megatron
        layout, its sequence-parallel attention the whole-sequence one
        (``models.layers.unbound_kw``), on the same device; its parameters
        are drawn anew (load a whole ``state_dict`` into it)."""
        return type(self)(**unbound_kw(self._kw))

    def kv_heads_local(self) -> list[int]:
        """Each layer's K/V heads on this rank: ``kv_heads/tp`` where
        ``bind_tp`` cut the attention, else ``kv_heads``."""
        return [block.attn.kv_heads for block in self.blocks]

    def init_cache(self, batch: int) -> list[dict]:
        """Zero cursor-decode state for ``batch`` sequences on the model's
        device: per layer (B, max_len, KVH, D) K/V in the model dtype (KVH
        the layer's K/V heads on this rank), a 0-d cursor and a 0-d
        sticky overflow flag."""
        dev = self.token_embed.weight.device

        def zeros(kvh):
            return torch.zeros((batch, self.max_len, kvh, self.head_dim),
                               dtype=self.dtype, device=dev)

        return [{"cached_key": zeros(kvh), "cached_value": zeros(kvh),
                 "cache_index": torch.zeros((), dtype=torch.int64,
                                            device=dev),
                 "overflow": torch.zeros((), dtype=torch.bool, device=dev)}
                for kvh in self.kv_heads_local()]

    def _train_positions(self, lq: int, device):
        """(1, lq) positions of the training/eval mode: 0.. for a whole
        sequence; under sequence parallelism this rank's block's global
        positions (``block_span``), with the global length held to
        ``max_len``."""
        offset, total = block_span(self.attention_impl, self.seq_mesh, lq)
        if total > self.max_len:
            raise ValueError(
                f"sequence length {total} exceeds max_len={self.max_len}; "
                f"raise max_len or shorten the input")
        return offset + torch.arange(lq, device=device)[None, :]

    def forward(self, token_ids, train: bool = False, positions=None,
                block_tables=None, pools=None, paged_fused: bool = True,
                generator=None, cache=None, by_column: bool = False):
        lq = token_ids.shape[1]
        if by_column and pools is None:
            raise ValueError("by_column is a slot-decode option (pass "
                             "pools)")
        keep = None
        if cache is not None:
            if pools is not None or positions is not None:
                raise ValueError("cursor decode (cache=) takes no "
                                 "positions or pools")
            if len(cache) != self.layers:
                raise ValueError(f"cache must hold one dict per layer "
                                 f"({self.layers}), got {len(cache)}")
            cache = [dict(layer) for layer in cache]
            pos = (cache[0]["cache_index"]
                   + torch.arange(lq, device=token_ids.device))[None, :]
        elif pools is None:
            if self.decode:
                raise ValueError("decode=True: pass cache=model.init_cache("
                                 "batch) (or use generate)")
            if positions is not None or block_tables is not None:
                raise ValueError(
                    "positions/block_tables are only accepted in slot "
                    "decode (pass pools)")
            pos = self._train_positions(lq, token_ids.device)
        else:
            if positions is None or positions.shape != token_ids.shape:
                raise ValueError(
                    "slot decode needs positions (B, L) matching "
                    "token_ids: the per-slot write index / position input")
            if len(pools) != self.layers:
                raise ValueError(f"pools must hold one dict per layer "
                                 f"({self.layers}), got {len(pools)}")
            pos = positions
            if block_tables is None:
                t = pools[0]["cached_key"].shape[1]
                if t not in (self.max_len, self.max_len + 1):
                    raise ValueError(
                        f"monolithic rows must hold max_len={self.max_len} "
                        f"columns, or one more (a scratch column); got {t}")
                if t == self.max_len:
                    # the writes that land inside the table, selected once
                    # for every layer
                    keep = (pos < self.max_len).nonzero(as_tuple=True)
        x = self.token_embed(token_ids).to(self.dtype)
        if self.pos_embed is not None:
            # clamped like the JAX table lookup: a pad position past
            # max_len reads the last row (its write is dropped anyway)
            x = x + self.pos_embed(
                pos.long().clamp(max=self.max_len - 1)).to(self.dtype)
        x = _dropout(x, self.dropout_rate, train, generator)
        for i, block in enumerate(self.blocks):
            if self.remat and pools is None and cache is None:
                x = _remat(block, x, train, pos, generator=generator)
            else:
                x = block(x, train, pos, None if pools is None else pools[i],
                          block_tables, paged_fused, generator,
                          None if cache is None else cache[i], keep,
                          by_column)
        x = _layer_norm(self.ln_f, x, self.dtype)
        if self.tp_mesh is not None:
            logits = self._tp_head(x, by_column)
        elif self.tie_embeddings:
            head = self.token_embed.weight.to(self.dtype)
            logits = (_by_column(lambda c: F.linear(c, head), x)
                      if by_column else F.linear(x, head))
        else:
            logits = _dense_by(self.lm_head, x, self.dtype, by_column)
        if cache is not None:
            return logits.float(), cache
        return logits.float()

    def _tp_head(self, x, by_column: bool = False):
        """The head of a tensor-parallel model: this rank's vocabulary
        columns (the tied ``attend``, or the column-parallel ``lm_head``;
        by query column with ``by_column``), all-gathered into whole
        logits (``gather_from_model``, whose backward keeps this rank's
        columns), so the loss runs on the whole (B, L, V) logits, and
        decode samples them, replicated over 'model'.  The untied head's
        whole bias is added after the gather, so every rank takes its
        whole gradient."""
        mesh = self.tp_mesh
        if self.tie_embeddings:
            def part(c):
                return self.token_embed.attend(c, self.dtype)
        else:
            def part(c):
                return self.lm_head(coll.copy_to_model(c, mesh), self.dtype,
                                    bias=False)
        logits = coll.gather_from_model(
            _by_column(part, x) if by_column else part(x), mesh)
        if self.tie_embeddings:
            return logits
        return logits + self.lm_head.bias.to(self.dtype)


def sample_tokens(logits, *, greedy: bool, temperature: float = 1.0,
                  generator: torch.Generator | None = None):
    """(B, V) logits → (B,) int64 token ids: the argmax, or one draw from
    ``softmax(logits / max(temperature, 1e-6))`` per row with
    ``generator`` (on the logits' device).  The sampled stream cannot
    equal the JAX package's: ``jax.random`` and ``torch.Generator`` are
    different bit generators.

    The draw is the exponential race ``argmax(p / E)``, ``E ~ Exp(1)``,
    by which ``torch.multinomial`` draws one sample: the same calls on the
    same generator, so the same tokens, without multinomial's checks of
    ``p`` on the host, which wait for the card and cannot be captured in
    a CUDA graph."""
    if greedy:
        return logits.argmax(-1)
    probs = torch.softmax(logits.float() / max(float(temperature), 1e-6),
                          dim=-1)
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / race).argmax(-1)


def decode_model(model: GPTLM, params, mesh) -> GPTLM:
    """The model that decodes over ``mesh`` (JAX's placement rule,
    ``serving/kv_cache.py:285-300``), ``params`` (a ``state_dict``: whole
    for an unbound model, this rank's slices for a bound one) loaded into
    it.  With ``partition_model`` and a 'model' axis the model keeps the
    Megatron cut: a bound model as it is (bound to this mesh's 'model'
    axis), an unbound one as a copy bound to the mesh (``bind_model_mesh``:
    each rank keeps the slices of the whole parameters that
    ``convert.tp_shard_state_dict`` cuts); otherwise it decodes whole on
    every rank."""
    keep_tp = model.partition_model and meshlib.MODEL_AXIS in mesh.axis_names
    if model.tp_mesh is None:
        if keep_tp:
            # a process group cannot be copied: share a bound 'seq' mesh
            model = copy.deepcopy(model, {id(model.seq_mesh): model.seq_mesh})
        if params is not None:
            model.load_state_dict(params)
        return bind_model_mesh(model, mesh) if keep_tp else model
    bound = model.tp_mesh
    if not keep_tp or any(
            f(meshlib.MODEL_AXIS) != g(meshlib.MODEL_AXIS)
            for f, g in ((bound.axis_size, mesh.axis_size),
                         (bound.axis_index, mesh.axis_index))):
        raise ValueError(
            f"the model is bound to 'model' rank "
            f"{bound.axis_index(meshlib.MODEL_AXIS)} of "
            f"{bound.axis_size(meshlib.MODEL_AXIS)}; decode it over a mesh "
            f"whose 'model' axis is that one (mesh axes {mesh.axis_names})")
    if params is not None:
        model.load_state_dict(params)
    return model


@torch.no_grad()
def generate(model: GPTLM, params, prompt, max_new_tokens: int, *,
             temperature: float = 1.0, greedy: bool = False,
             generator: torch.Generator | None = None, device=None,
             mesh=None):
    """Autoregressive sampling with a KV cache: (B, Lp) prompt →
    (B, max_new_tokens) int64 continuation on the device.

    ``params``, when given, is a ``state_dict`` loaded into ``model``, which
    is moved to ``device`` (``None`` = the CUDA card).  Cursor decode
    (dense cache attention, dropout off, whatever the model's
    ``attention_impl``: the JAX ``generate`` clones the model to dense
    attention): one forward prefills every prompt token but the last, then
    each new token is one single-token step.  ``greedy=True`` takes the
    argmax; otherwise tokens draw from
    ``softmax(logits / temperature)`` with ``generator`` (default: a
    generator on the device seeded 0) — a stream that cannot equal the
    JAX package's (``sample_tokens``).

    ``mesh`` (this rank's ``parallel.mesh.Mesh``; every rank of it calls
    ``generate``) decodes over several ranks, as JAX's ``mesh`` does.  The
    batch splits over 'data' (``B % dp`` is refused, with JAX's message):
    each data rank decodes its rows (``kv_slot_sharding``) and one
    all-gather over 'data' returns the whole (B, N) on every rank.  A MoE
    model decodes the whole batch on every rank: its blocks route one
    step's tokens together against one capacity, which a split of the
    batch would change.  With ``partition_model`` and a 'model' axis the
    model decodes Megatron-cut (``decode_model``): each rank runs its
    heads and FFN columns, and every rank of a 'model' group samples the
    same tokens from the gathered logits.  Any other axis ('seq',
    'expert') replicates."""
    dev = resolve_device(device)
    model = model.to(dev)
    if mesh is not None:
        model = decode_model(model, params, mesh)
    elif params is not None:
        model.load_state_dict(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, lp = prompt.shape
    if lp + max_new_tokens > model.max_len:
        raise ValueError(
            f"prompt ({lp}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"cache capacity max_len={model.max_len}")
    dp = 1
    if mesh is not None and meshlib.DATA_AXIS in mesh.axis_names:
        dp = mesh.axis_size(meshlib.DATA_AXIS)
        if b % dp:
            raise ValueError(
                f"batch {b} not divisible by the data axis ({dp})")
    split = dp > 1 and not model.moe_experts
    if split:
        rows, _ = meshlib.kv_slot_sharding(mesh, b, model.kv_heads)
        prompt = prompt[rows]
    if generator is None and not greedy:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = model.init_cache(prompt.shape[0])
    if lp > 1 and model.moe_experts:
        # one token at a time, as JAX prefills: a MoE block routes the
        # tokens of one call together, against one capacity
        for j in range(lp - 1):
            _, cache = model(prompt[:, j:j + 1], cache=cache)
    elif lp > 1:
        _, cache = model(prompt[:, :-1], cache=cache)
    tok, out = prompt[:, -1], []
    for _ in range(max_new_tokens):
        logits, cache = model(tok[:, None], cache=cache)
        tok = sample_tokens(logits[:, -1], greedy=greedy,
                            temperature=temperature, generator=generator)
        out.append(tok)
    out = torch.stack(out, dim=1) if out else prompt[:, :0]
    if split:
        out = coll.all_gather(out.contiguous(), mesh, tiled=True,
                              axis=meshlib.DATA_AXIS, dim=0)
    return out


# --------------------------------------------------------------------------
# Pipeline stages (``engines.pipeline.PipelineEngine(stages=...)``, JAX
# ``gpt.py:918-1092``): embed → S identical stages of ``layers_per_stage``
# GPTBlocks → final LN and an untied LM head.  The head is untied because
# each stage's parameters live on its own rank (tying would need the
# embedding moved to the last stage every step).  The stages hold no
# dropout: the schedules run a stage again in the backward pass (1F1B's
# recompute, GPipe's remat), which must see the forward's values.
# ``partition_model`` lays the stages out as JAX's Megatron annotations do
# (pp×tp); ``seq_axis`` with a sequence-parallel ``attention_impl`` makes
# the carry this rank's token block of the sequence (pp×sp);
# ``moe_experts`` gives the blocks the routed MoE FFN (pp×ep).  The engine
# binds its mesh (``bind_model_mesh``, ``bind_seq_mesh``,
# ``bind_expert_mesh``).
# --------------------------------------------------------------------------


def _seq_offset(module, lq: int) -> int:
    """The global position of this rank's first token under a stage's
    ``seq_axis``: ``seq index × lq`` on the mesh the engine bound."""
    if module.seq_mesh is None:
        raise ValueError(
            f"{type(module).__name__} with seq_axis={module.seq_axis!r} "
            f"takes this rank's token block of a sequence sharded over the "
            f"mesh's 'seq' axis, and has no mesh bound: train it with "
            f"PipelineEngine, which binds its mesh")
    return module.seq_mesh.axis_index(SEQ_AXIS) * lq


class GPTPipeEmbed(nn.Module):
    """Input stage: token (+ learned position) embeddings in ``dtype``;
    under RoPE there is no position table (each block rotates q and k).
    ``partition_model``: a vocab-parallel token table (JAX ``(MODEL,
    None)``).  ``seq_axis`` (pp×sp): the input is this rank's token block,
    whose learned positions start at ``seq index × lq`` (JAX
    ``gpt.py:951-966``)."""

    seq_mesh = None   # the mesh of a sequence-parallel stage (bind_seq_mesh)

    def __init__(self, vocab_size: int = 256, hidden: int = 128,
                 max_len: int = 512, rope: bool = False,
                 dtype=torch.float32, device=None,
                 partition_model: bool = False, seq_axis: str | None = None):
        super().__init__()
        device = resolve_device(device)
        self._kw = dict(vocab_size=vocab_size, hidden=hidden,
                        max_len=max_len, rope=rope, dtype=dtype,
                        device=device, partition_model=partition_model,
                        seq_axis=seq_axis)
        self.vocab_size, self.hidden, self.max_len = vocab_size, hidden, max_len
        self.rope, self.dtype, self.seq_axis = rope, dtype, seq_axis
        self.token_embed = (VocabParallelEmbedding if partition_model
                            else nn.Embedding)(vocab_size, hidden,
                                               device=device)
        self.pos_embed = (None if rope
                          else nn.Embedding(max_len, hidden, device=device))

    def reset_parameters(self, generator: torch.Generator | None = None):
        return flax_init_(self, generator)

    def bind_tp(self, mesh, prefix: str = "") -> None:
        if isinstance(self.token_embed, VocabParallelEmbedding):
            self.token_embed.bind(mesh, f"{prefix}.token_embed".lstrip("."))

    def carry_spec(self, x):
        """The carry of ``x`` without running the embed (whose bound
        lookup is a collective): a (B, L, hidden) tensor in ``dtype``."""
        return None, [((x.shape[0], x.shape[1], self.hidden), self.dtype)]

    def unbound(self) -> "GPTPipeEmbed":
        return type(self)(**unbound_kw(self._kw))

    def forward(self, token_ids):
        lq = token_ids.shape[1]
        sp = self.seq_mesh.axis_size(SEQ_AXIS) if self.seq_axis and \
            self.seq_mesh is not None else 1
        if lq * sp > self.max_len:
            raise ValueError(
                f"sequence length {lq * sp} exceeds max_len={self.max_len}")
        x = self.token_embed(token_ids.long()).to(self.dtype)
        if self.pos_embed is None:
            return x
        offset = _seq_offset(self, lq) if self.seq_axis else 0
        pos = offset + torch.arange(lq, device=token_ids.device)[None, :]
        return x + self.pos_embed(pos).to(self.dtype)


class GPTPipeBlock(nn.Module):
    """One pipeline stage: ``layers_per_stage`` pre-LN decoder blocks
    (``GPTBlock``, dropout 0).  Without a ``seq_axis`` the carry holds
    whole sequences and RoPE positions are ``arange(L)``; with one
    (pp×sp) it is this rank's token block, attended by a
    sequence-parallel ``attention_impl`` over the bound mesh's 'seq'
    axis, with RoPE positions offset to global.  ``partition_model``: the
    Megatron attention and FFN.  ``moe_experts`` > 0 (pp×ep): each
    block's FFN a routed MoE of ``moe_top_k`` and
    ``moe_capacity_factor``, its experts cut over 'expert' under
    ``partition_experts`` (JAX ``gpt.py:988-1020``)."""

    dropout_rate = 0.0
    seq_mesh = None   # the mesh of a sequence-parallel stage (bind_seq_mesh)

    def __init__(self, hidden: int = 128, heads: int = 4, ffn: int = 512,
                 layers_per_stage: int = 1, rope: bool = False,
                 kv_heads: int | None = None, attention_impl: str = "dense",
                 dtype=torch.float32, device=None,
                 partition_model: bool = False, seq_axis: str | None = None,
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25,
                 partition_experts: bool = False):
        super().__init__()
        if attention_impl not in ("dense", "flash", *SEQ_PARALLEL):
            raise ValueError(f"unknown attention_impl '{attention_impl}' "
                             f"for pipeline stages; dense | flash, or one "
                             f"of {tuple(SEQ_PARALLEL)}")
        if seq_axis and attention_impl == "dense":
            # JAX gpt.py:999-1004
            raise ValueError(
                "seq_axis set but attention_impl is 'dense' — dense "
                "attention on a seq-sharded carry attends within local "
                "blocks only; use ring/ring_flash/ulysses")
        device = resolve_device(device)
        self._kw = dict(hidden=hidden, heads=heads, ffn=ffn,
                        layers_per_stage=layers_per_stage, rope=rope,
                        kv_heads=kv_heads, attention_impl=attention_impl,
                        dtype=dtype, device=device,
                        partition_model=partition_model, seq_axis=seq_axis,
                        moe_experts=moe_experts, moe_top_k=moe_top_k,
                        moe_capacity_factor=moe_capacity_factor,
                        partition_experts=partition_experts)
        self.hidden, self.heads, self.ffn = hidden, heads, ffn
        self.layers_per_stage, self.rope = layers_per_stage, rope
        self.kv_heads, self.attention_impl = kv_heads, attention_impl
        self.dtype, self.seq_axis = dtype, seq_axis
        self.moe_experts, self.partition_experts = (moe_experts,
                                                    partition_experts)
        self.layers = nn.ModuleList(
            GPTBlock(hidden, heads, ffn, 0.0, rope, kv_heads, dtype, device,
                     attention_impl, moe_experts, moe_top_k,
                     moe_capacity_factor, partition_model, partition_experts)
            for _ in range(layers_per_stage))

    def reset_parameters(self, generator: torch.Generator | None = None):
        return flax_init_(self, generator)

    def unbound(self) -> "GPTPipeBlock":
        return type(self)(**unbound_kw(self._kw))

    def forward(self, x):
        pos = None
        if self.rope:
            lq = x.shape[1]
            offset = _seq_offset(self, lq) if self.seq_axis else 0
            pos = offset + torch.arange(lq, device=x.device)[None, :]
        for layer in self.layers:
            x = layer(x, False, pos)
        return x


class GPTPipeHead(nn.Module):
    """Output stage: final LN → untied LM head in ``dtype``, logits in
    f32.  ``partition_model``: the head's vocabulary columns cut over
    'model' (JAX kernel ``(None, MODEL)``) and all-gathered, so the loss
    runs on whole logits.  The bias is cut with its columns: each rank's
    rides in its GEMM, so at tp = 1 the head is the plain one bitwise
    (JAX leaves it whole; a checkpoint holds it whole either way)."""

    tp_mesh = None    # the mesh of a tensor-parallel head (bind_tp)

    def __init__(self, vocab_size: int = 256, hidden: int = 128,
                 dtype=torch.float32, device=None,
                 partition_model: bool = False):
        super().__init__()
        device = resolve_device(device)
        self._kw = dict(vocab_size=vocab_size, hidden=hidden, dtype=dtype,
                        device=device, partition_model=partition_model)
        self.vocab_size, self.dtype = vocab_size, dtype
        self.ln_f = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.lm_head = (ColumnParallelLinear if partition_model
                        else nn.Linear)(hidden, vocab_size, device=device)

    def reset_parameters(self, generator: torch.Generator | None = None):
        return flax_init_(self, generator)

    def bind_tp(self, mesh, prefix: str = "") -> None:
        if isinstance(self.lm_head, ColumnParallelLinear) and \
                self.tp_mesh is None:
            self.lm_head.bind(mesh, f"{prefix}.lm_head".lstrip("."))
            self.tp_mesh = mesh

    def unbound(self) -> "GPTPipeHead":
        return type(self)(**unbound_kw(self._kw))

    def forward(self, x):
        x = _layer_norm(self.ln_f, x, self.dtype)
        if self.tp_mesh is None:
            return _dense(self.lm_head, x, self.dtype).float()
        mesh = self.tp_mesh
        return coll.gather_from_model(
            self.lm_head(coll.copy_to_model(x, mesh), self.dtype),
            mesh).float()


def gpt_pipeline_stages(vocab_size: int = 256, hidden: int = 128,
                        heads: int = 4, ffn: int = 512, max_len: int = 512,
                        layers_per_stage: int = 1,
                        partition_model: bool = False,
                        positional: str = "learned",
                        kv_heads: int | None = None,
                        attention_impl: str = "dense",
                        seq_axis: str | None = None, dtype=torch.float32,
                        num_classes: int | None = None,
                        moe_experts: int = 0, moe_top_k: int = 1,
                        moe_capacity_factor: float = 1.25,
                        partition_experts: bool = False, device=None):
    """(embed, block, head) for ``PipelineEngine(stages=...)``: a GPT
    decoder of depth ``pipe size × layers_per_stage`` (JAX
    ``gpt_pipeline_stages``).  ``num_classes`` is an alias of
    ``vocab_size`` (the harness passes it).  ``partition_model`` adds the
    Megatron layout for pp×tp; ``attention_impl='ring'`` (etc.) with
    ``seq_axis='seq'`` makes the stages sequence-parallel for pp×sp.
    ``moe_experts`` > 0 with ``partition_experts`` makes each block's FFN
    a routed MoE whose experts cut over an 'expert' axis (pp×ep)."""
    if num_classes is not None:
        vocab_size = num_classes
    if positional not in ("learned", "rope"):
        raise ValueError(
            f"unknown positional '{positional}'; learned | rope")
    rope = positional == "rope"
    if isinstance(dtype, str):
        from distributed_tensorflow_tpu_torch.models import resolve_dtype
        dtype = resolve_dtype(dtype)
    return (GPTPipeEmbed(vocab_size, hidden, max_len, rope, dtype, device,
                         partition_model, seq_axis),
            GPTPipeBlock(hidden, heads, ffn, layers_per_stage, rope,
                         kv_heads, attention_impl, dtype, device,
                         partition_model, seq_axis, moe_experts, moe_top_k,
                         moe_capacity_factor, partition_experts),
            GPTPipeHead(vocab_size, hidden, dtype, device, partition_model))
