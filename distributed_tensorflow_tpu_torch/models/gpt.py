"""GPT-style decoder-only causal LM (port of ``models/gpt.py``).

Pre-LN transformer decoder, learned or rotary positions, grouped-query
attention (``kv_heads``), weight-tied LM head.  Ported paths:

* training/eval mode: causal attention over the whole sequence, dense
  (``attention_impl="dense"``) or through the flash kernels
  (``attention_impl="flash"``: ``ops.flash_attention``, the Hopper ports
  of the Pallas forward, dQ and dK/dV kernels);
* slot decode (the serving path, ``serving/kv_cache.py``): the caller
  passes per-slot ``positions`` (B, L) and one KV dict per layer in
  ``pools``, written in place.  Paged (``block_tables`` given): pools
  ``{"key_pool", "value_pool"}`` of (N, blk, KVH, D); each layer writes its
  K/V through the block table, then reads it back either fused
  (``ops.paged_attention``, the Hopper kernel) or gathered (block table
  gather + masked dense attention, the prefill path and the oracle).
  Monolithic (no ``block_tables``): rows ``{"cached_key", "cached_value"}``
  of (slots, max_len, KVH, D); the K/V of each (row, position) is written
  in place and every query attends its row under the mask ``t <= pos``.
  Under int8 storage each dict also holds f32 scales (``key_scale_pool``/
  ``value_scale_pool`` (N, blk, KVH), or ``key_scale``/``value_scale``
  (slots, max_len, KVH)): K/V are encoded by ``parallel.compression``'s
  channel codec on write and decoded on read;
* cursor decode (``generate``): ``forward(ids, cache=cache)`` with the
  per-layer ``{"cached_key", "cached_value", "cache_index", "overflow"}``
  dicts of ``init_cache`` returns ``(logits, cache)``.  The K/V tensors are
  written in place; the returned dicts carry the advanced cursors and the
  sticky overflow flag (the dicts passed in are not changed).

Flax's numerics are kept: parameters are stored in float32 and Dense/Embed
compute in the model ``dtype``; LayerNorm has epsilon 1e-6 and normalizes
in float32; GELU is the tanh approximation; logits are returned in f32.
Layouts are the JAX package's: activations (B, L, H, D), pools (N, blk,
KVH, D), block tables (S, MB) int32.  ``models/convert.py`` maps a flax
param tree onto this module's ``state_dict``.

Dropout draws its keep masks from the ``generator`` the caller passes to
``forward`` (the engine's ``TrainState`` generator); it cannot reproduce
flax's random bits.

Not ported here (each raises ``NotImplementedError``): MoE blocks, remat,
sequence-parallel attention, tensor-parallel partitioning and
``generate(mesh=...)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import not_ported, resolve_device
from distributed_tensorflow_tpu_torch.parallel.compression import (
    int8_channel_decode, int8_channel_encode)
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    dense_attention)

LN_EPS = 1e-6   # flax nn.LayerNorm default (torch's is 1e-5)
_SEQ_PARALLEL = ("ring", "ring_flash", "ulysses", "ulysses_flash")


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


def _dense(lin: nn.Linear, x, dtype):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _dropout(x, rate: float, train: bool, generator):
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``; the keep mask is drawn from ``generator``."""
    if not train or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _layer_norm(ln: nn.LayerNorm, x, dtype):
    """flax ``nn.LayerNorm(dtype=...)``: statistics in f32, output in
    ``dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS).to(dtype)


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention: dense or flash (training/eval) or
    paged decode."""

    def __init__(self, hidden: int, heads: int, kv_heads: int | None = None,
                 rope: bool = False, dtype=torch.float32, device=None,
                 attention_impl: str = "dense"):
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
        self.query = nn.Linear(hidden, heads * self.head_dim, device=device)
        self.key = nn.Linear(hidden, kvh * self.head_dim, device=device)
        self.value = nn.Linear(hidden, kvh * self.head_dim, device=device)
        self.out = nn.Linear(heads * self.head_dim, hidden, device=device)

    def _widen(self, t):
        """kv_heads → heads by group broadcast (no-op for MHA)."""
        if self.kv_heads == self.heads:
            return t
        return t.repeat_interleave(self.heads // self.kv_heads, dim=2)

    def forward(self, x, pos=None, pool=None, block_tables=None,
                paged_fused: bool = True, cache=None, keep=None):
        if self.rope and pos is None:
            raise ValueError("rope=True needs the caller to pass positions")
        b, lq, _ = x.shape
        q = _dense(self.query, x, self.dtype).reshape(
            b, lq, self.heads, self.head_dim)
        k = _dense(self.key, x, self.dtype).reshape(
            b, lq, self.kv_heads, self.head_dim)
        v = _dense(self.value, x, self.dtype).reshape(
            b, lq, self.kv_heads, self.head_dim)
        if self.rope:
            q, k = apply_rope(q, pos), apply_rope(k, pos)
        if cache is not None:
            out = self._cursor_attend(q, k, v, cache)
        elif pool is not None and block_tables is not None:
            out = self._paged_attend(q, k, v, pos, pool, block_tables,
                                     paged_fused)
        elif pool is not None:
            out = self._slot_attend(q, k, v, pos, pool, keep)
        elif self.attention_impl == "flash":
            from distributed_tensorflow_tpu_torch.ops.flash_attention import (
                flash_attention)
            out = flash_attention(q, self._widen(k), self._widen(v),
                                  causal=True)
        else:
            out = dense_attention(q, self._widen(k), self._widen(v),
                                  causal=True)
        out = out.reshape(b, lq, self.heads * self.head_dim)
        return _dense(self.out, out, self.dtype)

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

    def _slot_attend(self, q, k, v, pos, rows, keep):
        """Monolithic slot decode: write, then masked dense read.

        ``rows`` holds (B, T, KVH, D) ``cached_key``/``cached_value`` (and
        under int8 the (B, T, KVH) f32 ``key_scale``/``value_scale``).
        Each (row, position) K/V vector is written in place; ``keep`` is
        the ``(row, column)`` selection of the positions inside the table
        (a position at or past ``max_len`` is dropped, as the JAX scatter
        drops it — the table has no scratch row).  Every query then
        attends its row's keys ``t <= pos``, its own K/V included."""
        ck, cv = rows["cached_key"], rows["cached_value"]
        t = ck.shape[1]
        r, c = keep
        idx = pos.long()
        enc = self._encode(k[r, c], v[r, c], ck.dtype)
        names = ("cached_key", "cached_value", "key_scale", "value_scale")
        for name, val in zip(names, enc):
            rows[name][r, idx[r, c]] = val
        if ck.dtype == torch.int8:
            keys = int8_channel_decode(ck, rows["key_scale"], self.dtype)
            vals = int8_channel_decode(cv, rows["value_scale"], self.dtype)
        else:
            keys, vals = ck, cv
        valid = (torch.arange(t, device=q.device)[None, None, :]
                 <= idx[:, :, None])
        return self._masked_read(q, keys, vals, valid)

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

    def _paged_attend(self, q, k, v, pos, pool, block_tables, fused):
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
            return paged_attention(
                q.contiguous(), kp, vp, block_tables,
                pos[:, 0].to(torch.int32).contiguous(), k_scale=ksp,
                v_scale=vsp).to(self.dtype)
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
        return self._masked_read(q, keys, vals, valid)


class GPTBlock(nn.Module):
    """Pre-LN decoder block: x + attn(LN(x)); x + ffn(LN(x))."""

    def __init__(self, hidden: int, heads: int, ffn: int,
                 dropout_rate: float = 0.1, rope: bool = False,
                 kv_heads: int | None = None, dtype=torch.float32,
                 device=None, attention_impl: str = "dense"):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.attn = CausalSelfAttention(hidden, heads, kv_heads, rope, dtype,
                                        device, attention_impl)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(hidden, ffn, device=device)
        self.fc2 = nn.Linear(ffn, hidden, device=device)

    def forward(self, x, train: bool = False, pos=None, pool=None,
                block_tables=None, paged_fused: bool = True, generator=None,
                cache=None, keep=None):
        y = self.attn(_layer_norm(self.ln1, x, self.dtype), pos, pool,
                      block_tables, paged_fused, cache, keep)
        x = x + _dropout(y, self.dropout_rate, train, generator)
        y = _layer_norm(self.ln2, x, self.dtype)
        y = F.gelu(_dense(self.fc1, y, self.dtype), approximate="tanh")
        y = _dense(self.fc2, y, self.dtype)
        return x + _dropout(y, self.dropout_rate, train, generator)


class GPTLM(nn.Module):
    """Decoder-only causal LM: token ids (B, L) → next-token logits (B, L, V)
    in f32.

    ``forward(ids, train=..., generator=...)`` is the training/eval mode
    (``generator`` feeds dropout when ``train``).  ``forward(ids,
    positions=..., pools=...)`` is slot decode: ``pools`` holds one KV
    dict per layer, written in place — paged pools with ``block_tables``
    (``paged_fused`` picks the kernel read or the gather read), monolithic
    rows without.  ``forward(ids, cache=...)`` is cursor decode and
    returns ``(logits, cache)`` (module docstring).  ``decode=True`` marks
    a model that only decodes: its forward needs ``cache=``."""

    def __init__(self, vocab_size: int = 256, hidden: int = 128,
                 layers: int = 2, heads: int = 4, ffn: int = 512,
                 max_len: int = 512, dropout_rate: float = 0.1,
                 attention_impl: str = "dense", positional: str = "learned",
                 kv_heads: int | None = None, tie_embeddings: bool = True,
                 dtype=torch.float32, moe_experts: int = 0,
                 remat: bool = False, partition_model: bool = False,
                 decode: bool = False, device=None):
        super().__init__()
        if moe_experts:
            not_ported("moe_experts > 0 (MoE blocks)", "remaining engines")
        if remat:
            not_ported("remat", "BERT, ResNet and remat")
        if partition_model:
            not_ported("partition_model (TP layout)", "remaining engines")
        if attention_impl in _SEQ_PARALLEL:
            not_ported(f"attention_impl={attention_impl!r}",
                        "sequence parallelism")
        if attention_impl not in ("dense", "flash"):
            raise ValueError(f"unknown attention_impl '{attention_impl}'; "
                             f"dense | flash (ported), or one of "
                             f"{_SEQ_PARALLEL}")
        if positional not in ("learned", "rope"):
            raise ValueError(
                f"unknown positional '{positional}'; learned | rope")
        device = resolve_device(device)
        self.vocab_size, self.hidden, self.layers = vocab_size, hidden, layers
        self.heads, self.ffn, self.max_len = heads, ffn, max_len
        self.kv_heads = kv_heads if kv_heads is not None else heads
        self.dropout_rate = dropout_rate
        self.attention_impl = attention_impl
        self.decode = bool(decode)
        self.positional = positional
        self.tie_embeddings = tie_embeddings
        self.dtype = dtype
        rope = positional == "rope"
        self.token_embed = nn.Embedding(vocab_size, hidden, device=device)
        self.pos_embed = (None if rope
                          else nn.Embedding(max_len, hidden, device=device))
        self.blocks = nn.ModuleList(
            GPTBlock(hidden, heads, ffn, dropout_rate, rope, kv_heads, dtype,
                     device, attention_impl) for _ in range(layers))
        self.ln_f = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.lm_head = (None if tie_embeddings
                        else nn.Linear(hidden, vocab_size, device=device))

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initializers, drawn from ``generator`` on the CPU and
        copied to the model's device: Dense kernels lecun-normal
        (truncated at ±2σ), biases zero, embeddings normal with std
        ``hidden ** -0.5``, LayerNorm scale 1 and bias 0."""
        def fill(p, std, truncated=False):
            host = torch.empty(p.shape, dtype=torch.float32)
            if truncated:
                # flax lecun_normal: std / .87962566 keeps the truncated
                # distribution's variance at fan_in ** -1
                nn.init.trunc_normal_(host, 0.0, std / .87962566103423978,
                                      -2 * std / .87962566103423978,
                                      2 * std / .87962566103423978,
                                      generator=generator)
            else:
                host.normal_(0.0, std, generator=generator)
            p.copy_(host)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fill(mod.weight, math.sqrt(1.0 / mod.in_features), True)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                fill(mod.weight, math.sqrt(1.0 / mod.embedding_dim))
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        return self

    def init_cache(self, batch: int) -> list[dict]:
        """Zero cursor-decode state for ``batch`` sequences on the model's
        device: per layer (B, max_len, KVH, D) K/V in the model dtype, a
        0-d cursor and a 0-d sticky overflow flag."""
        dev = self.token_embed.weight.device
        shape = (batch, self.max_len, self.kv_heads, self.head_dim)
        return [{"cached_key": torch.zeros(shape, dtype=self.dtype,
                                           device=dev),
                 "cached_value": torch.zeros(shape, dtype=self.dtype,
                                             device=dev),
                 "cache_index": torch.zeros((), dtype=torch.int64,
                                            device=dev),
                 "overflow": torch.zeros((), dtype=torch.bool, device=dev)}
                for _ in range(self.layers)]

    def forward(self, token_ids, train: bool = False, positions=None,
                block_tables=None, pools=None, paged_fused: bool = True,
                generator=None, cache=None):
        lq = token_ids.shape[1]
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
            if lq > self.max_len:
                raise ValueError(
                    f"sequence length {lq} exceeds max_len={self.max_len}; "
                    f"raise max_len or shorten the input")
            pos = torch.arange(lq, device=token_ids.device)[None, :]
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
                # monolithic rows: the writes that land inside the table,
                # selected once for every layer
                keep = (pos < self.max_len).nonzero(as_tuple=True)
        x = self.token_embed(token_ids).to(self.dtype)
        if self.pos_embed is not None:
            # clamped like the JAX table lookup: a pad position past
            # max_len reads the last row (its write is dropped anyway)
            x = x + self.pos_embed(
                pos.long().clamp(max=self.max_len - 1)).to(self.dtype)
        x = _dropout(x, self.dropout_rate, train, generator)
        for i, block in enumerate(self.blocks):
            x = block(x, train, pos, None if pools is None else pools[i],
                      block_tables, paged_fused, generator,
                      None if cache is None else cache[i], keep)
        x = _layer_norm(self.ln_f, x, self.dtype)
        if self.tie_embeddings:
            logits = F.linear(x, self.token_embed.weight.to(self.dtype))
        else:
            logits = _dense(self.lm_head, x, self.dtype)
        if cache is not None:
            return logits.float(), cache
        return logits.float()


def sample_tokens(logits, *, greedy: bool, temperature: float = 1.0,
                  generator: torch.Generator | None = None):
    """(B, V) logits → (B,) int64 token ids: the argmax, or one draw from
    ``softmax(logits / max(temperature, 1e-6))`` per row with
    ``generator`` (on the logits' device).  The sampled stream cannot
    equal the JAX package's: ``jax.random`` and ``torch.Generator`` are
    different bit generators."""
    if greedy:
        return logits.argmax(-1)
    probs = torch.softmax(logits.float() / max(float(temperature), 1e-6),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: GPTLM, params, prompt, max_new_tokens: int, *,
             temperature: float = 1.0, greedy: bool = False,
             generator: torch.Generator | None = None, device=None,
             mesh=None):
    """Autoregressive sampling with a KV cache: (B, Lp) prompt →
    (B, max_new_tokens) int64 continuation on the device.

    ``params``, when given, is a ``state_dict`` loaded into ``model``, which
    is moved to ``device`` (``None`` = the CUDA card).  Cursor decode
    (dense cache attention, dropout off): one forward prefills every
    prompt token but the last, then each new token is one single-token
    step.  ``greedy=True`` takes the argmax; otherwise tokens draw from
    ``softmax(logits / temperature)`` with ``generator`` (default: a
    generator on the device seeded 0) — a stream that cannot equal the
    JAX package's (``sample_tokens``)."""
    if mesh is not None:
        not_ported("generate(mesh=...) (multi-device decode)",
                   "remaining engines")
    dev = resolve_device(device)
    model = model.to(dev)
    if params is not None:
        model.load_state_dict(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, lp = prompt.shape
    if lp + max_new_tokens > model.max_len:
        raise ValueError(
            f"prompt ({lp}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"cache capacity max_len={model.max_len}")
    if generator is None and not greedy:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = model.init_cache(b)
    if lp > 1:
        _, cache = model(prompt[:, :-1], cache=cache)
    tok, out = prompt[:, -1], []
    for _ in range(max_new_tokens):
        logits, cache = model(tok[:, None], cache=cache)
        tok = sample_tokens(logits[:, -1], greedy=greedy,
                            temperature=temperature, generator=generator)
        out.append(tok)
    return torch.stack(out, dim=1) if out else prompt[:, :0]
