"""Slot KV cache (port of ``serving/kv_cache.py``).

The device half of the serving engine: a fixed table of ``slots``
independent sequences, each with its own length, advanced together by one
decode step.  Two layouts, selected by ``kv_layout`` as in the JAX package:

* ``SlotKVCache(model, params, slots)`` — monolithic: one
  ``(slots, max_len, kv_heads, head_dim)`` K/V row per slot and layer,
  read by masked dense attention.  Decode rows that do not take part write
  garbage at their own length, invisible under the length-driven mask and
  overwritten by their next real write.
* ``SlotKVCache(..., kv_layout="paged")`` builds ``PagedSlotKVCache``: one
  physical KV block pool per layer, shared by every slot, plus host-owned
  per-slot int32 block tables, refcounts and a free list (vLLM
  PagedAttention, Kwon et al., arXiv:2309.06180).  Prefill reads it by
  gather + masked dense attention; decode (``advance``) through the Hopper
  kernel of ``ops.paged_attention``, one launch per layer per step.  The
  pool carries one extra SCRATCH block (id ``num_blocks``): unmapped table
  entries point at it, and the rows of slots that do not take part in a
  decode step are routed wholly to it.

Both layouts share the host bookkeeping of this module's base class:
chunked admission (``begin_insert``/``prefill_chunk``, Sarathi-Serve),
greedy or temperature sampling (``torch.Generator``, on the device), the
prefix pool's chained SHA-256 block keys and hit/miss/evict accounting, and
``kv_dtype`` storage (bf16, f32, or int8 with one f32 max-abs scale per
written K/V vector).  The optional prefix pool caches block-aligned
prompt-prefix KV keyed by the exact prefix tokens, with LRU eviction: the
monolithic pool stores byte copies of the blocks and copies them back on a
hit; the paged pool stores block ids with a refcount pin and a hit aliases
them into the slot's table (zero copy), the write of the last prompt token
into a shared block going through copy-on-write.

Differences from the JAX table, all in how work is issued: PyTorch runs
eagerly, so there are no compiled programs and no power-of-two prefill
buckets — a chunk of ``n`` prompt tokens is one forward over exactly ``n``
positions (the JAX chunk scans the same positions one token at a time
under the same per-position mask).  A GEMM over another row count may round
differently, so on the card a prefix hit or another chunking may differ
from a cold prefill in the last bits.  The tables are updated in place.

Parity contract (as in the JAX package): the monolithic read and the paged
gather read are the dense math; the fused decode read agrees with them
within a tolerance, not bitwise; int8 storage is a lossy codec.  Sampled
streams cannot equal JAX's (``models.gpt.sample_tokens``).

Not ported yet, each raising ``NotImplementedError``: ``advance_multi``,
speculative verify/commit/rewind, the disaggregated handoff,
``swap_params``, mesh sharding and the compile/memory ledger.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import not_ported, resolve_device
from distributed_tensorflow_tpu_torch.models.gpt import sample_tokens


class SlotOverflow(RuntimeError):
    """An active slot was asked to write past its ``max_len`` capacity
    (admission bounds prompt + max_new_tokens, so this is a bookkeeping
    bug, never a user error)."""


class BlockPoolExhausted(RuntimeError):
    """The paged KV block pool has no free physical block for a required
    write (``can_admit`` should have deferred the admission)."""


def _storage_dtype(kv_dtype, model_dtype) -> torch.dtype:
    """``kv_dtype`` (None, a name or a torch dtype) → the table's dtype."""
    if kv_dtype is None:
        return model_dtype
    if isinstance(kv_dtype, str):
        from distributed_tensorflow_tpu_torch.models import resolve_dtype
        return torch.int8 if kv_dtype == "int8" else resolve_dtype(kv_dtype)
    return kv_dtype


class SlotKVCache:
    """Fixed slot table for one ``GPTLM``, monolithic layout, and the host
    bookkeeping both layouts share (module docstring).

    ``model`` is a port ``GPTLM``; ``params``, when given, is a
    ``state_dict`` loaded into it.  The model is moved to ``device``
    (``None`` = the CUDA card).  ``generator`` feeds temperature sampling
    (``greedy=False``); by default a generator on the device seeded 0."""

    def __new__(cls, *args, kv_layout: str = "monolithic", **kwargs):
        # one kwarg selects the layout at every call site, as in the JAX
        # package
        if cls is SlotKVCache and kv_layout == "paged":
            return super().__new__(PagedSlotKVCache)
        return super().__new__(cls)

    def __init__(self, model, params, slots: int, *, mesh=None,
                 greedy: bool = True, temperature: float = 1.0,
                 kv_dtype=None, prefix_cache_blocks: int = 0,
                 prefix_block: int = 16, kv_layout: str = "monolithic",
                 paged_blocks: int = 0, paged_block: int = 0,
                 paged_fused: bool = True, ledger=None, device=None,
                 generator: torch.Generator | None = None):
        if kv_layout not in ("monolithic", "paged"):
            raise ValueError(f"kv_layout must be 'monolithic' or 'paged', "
                             f"got {kv_layout!r}")
        if kv_layout == "monolithic" and (paged_blocks or paged_block):
            raise ValueError("paged_blocks/paged_block only apply to "
                             "kv_layout='paged'")
        if mesh is not None:
            not_ported("mesh-sharded slot tables", "remaining engines")
        if ledger is not None:
            not_ported("the compile/memory ledger", "rest of observability")
        if slots < 1:
            raise ValueError(f"slots must be positive, got {slots}")
        if prefix_cache_blocks < 0:
            raise ValueError(f"prefix_cache_blocks must be >= 0, got "
                             f"{prefix_cache_blocks}")
        if prefix_block < 1:
            raise ValueError(f"prefix_block must be positive, got "
                             f"{prefix_block}")
        self.kv_layout = kv_layout
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.max_len = int(model.max_len)
        self.greedy = bool(greedy)
        self.temperature = float(temperature)
        self.generator = (generator if generator is not None
                          else torch.Generator(self.device).manual_seed(0))
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state_dict(params)
        self._store = _storage_dtype(kv_dtype, model.dtype)
        self.kv_dtype = str(self._store).removeprefix("torch.")
        self.prefix_cache_blocks = int(prefix_cache_blocks)
        self.prefix_block = int(prefix_block)

        # host slot table; ``reserved`` marks slots claimed by a chunked
        # admission in progress (lengths[] is then the fill position)
        self.lengths = np.zeros(self.slots, np.int32)
        self.active = np.zeros(self.slots, np.bool_)
        self.reserved = np.zeros(self.slots, np.bool_)
        self.tokens = np.zeros(self.slots, np.int32)   # last token per slot
        self._pending: dict[int, dict] = {}
        # prefix pool: key → a byte copy of the block (monolithic) or a
        # pinned block id (paged), least recently used first
        self._prefix_pool: OrderedDict[bytes, object] = OrderedDict()
        self.prefix_stats = {"hits": 0, "misses": 0, "evictions": 0,
                             "tokens_reused": 0, "inserted_blocks": 0}
        # prompt tokens actually fed through a prefill forward (reused
        # prefix positions are skipped)
        self.prefill_tokens_computed = 0
        self._phase_s = {"prefill_s": 0.0, "decode_s": 0.0}
        self.cache = self._init_cache()

    def _layer_cache(self, lead: tuple, names: tuple) -> dict:
        """One layer's zero KV leaves: (*lead, KVH, D) payload at the
        storage dtype and, under int8, (*lead, KVH) f32 scales."""
        m = self.model
        shape = (*lead, m.kv_heads, m.head_dim)
        out = {n: torch.zeros(shape, dtype=self._store, device=self.device)
               for n in names[:2]}
        if self._store == torch.int8:
            out.update({n: torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
                        for n in names[2:]})
        return out

    def _init_cache(self) -> list[dict]:
        return [self._layer_cache((self.slots, self.max_len),
                                  ("cached_key", "cached_value",
                                   "key_scale", "value_scale"))
                for _ in range(self.model.layers)]

    # ------------------------------------------------------------ slot API
    @property
    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots)
                if not (self.active[i] or self.reserved[i])]

    def _sample(self, logits) -> torch.Tensor:
        """(B, V) logits → (B,) ids: greedy or a temperature draw with the
        table's generator — one definition for prefill and decode."""
        return sample_tokens(logits, greedy=self.greedy,
                             temperature=self.temperature,
                             generator=self.generator)

    def _claim_slot(self, prompt, slot: int | None) -> tuple[np.ndarray,
                                                             int, int]:
        """Shared admission validation: returns (prompt, lp, slot)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        lp = int(prompt.shape[0])
        if lp < 1:
            raise ValueError("prompt must hold at least one token")
        if lp >= self.max_len:
            raise ValueError(
                f"prompt length {lp} leaves no room to generate within "
                f"max_len={self.max_len}")
        if slot is None:
            free = self.free_slots
            if not free:
                raise RuntimeError("no free slot — evict before inserting")
            slot = free[0]
        elif self.active[slot] or self.reserved[slot]:
            raise RuntimeError(f"slot {slot} is active — evict it first")
        return prompt, lp, slot

    def insert(self, prompt, slot: int | None = None) -> tuple[int, int]:
        """Admit a prompt (``begin_insert`` + one uncapped chunk); returns
        ``(slot, first_token)``: the first generated token is sampled from
        the last prompt position's logits, and the slot's length becomes
        ``len(prompt)``."""
        slot, _ = self.begin_insert(prompt, slot)
        try:
            first = self.prefill_chunk(slot)
        except BaseException:
            # a failure inside the final chunk may land after the slot
            # activated (in _pool_prefix): release whichever state it
            # reached
            if self.has_pending(slot):
                self.abort_insert(slot)
            elif self.active[slot]:
                self.evict(slot)
            raise
        return slot, first

    def begin_insert(self, prompt,
                     slot: int | None = None) -> tuple[int, int]:
        """Claim a slot for a chunk-by-chunk admission; returns
        ``(slot, reused_tokens)``.  With the prefix pool on, the longest
        cached block-aligned prefix is restored into the slot and prefill
        resumes after it.  The slot stays RESERVED until the final
        ``prefill_chunk`` activates it."""
        prompt, lp, slot = self._claim_slot(prompt, slot)
        reused = self._restore_prefix(prompt, lp, slot)
        self.reserved[slot] = True
        self.lengths[slot] = reused
        self._pending[slot] = {"prompt": prompt, "lp": lp, "filled": reused}
        return slot, reused

    def prefill_chunk(self, slot: int,
                      max_tokens: int | None = None) -> int | None:
        """Prefill the next ≤ ``max_tokens`` prompt tokens of a pending
        admission in one forward.  Returns the first generated token when
        this was the final chunk (the slot becomes active), else None."""
        pend = self._pending.get(slot)
        if pend is None:
            raise RuntimeError(f"slot {slot} has no pending admission "
                               f"(begin_insert first)")
        filled, lp = pend["filled"], pend["lp"]
        n = lp - filled
        if max_tokens is not None:
            if max_tokens < 1:
                raise ValueError(
                    f"max_tokens must be positive, got {max_tokens}")
            n = min(n, int(max_tokens))
        final = filled + n == lp
        self._ensure_writable(slot, filled, filled + n)
        t0 = time.perf_counter()
        logits = self._prefill_forward(
            slot, pend["prompt"][None, filled:filled + n],
            np.arange(filled, filled + n, dtype=np.int32)[None, :])
        # materialized before host state flips: a device error surfaces
        # while the slot is still pending
        first = int(self._sample(logits[:, -1])[0])
        self._phase_s["prefill_s"] += time.perf_counter() - t0
        pend["filled"] = filled + n
        self.lengths[slot] = filled + n
        self.prefill_tokens_computed += n
        if not final:
            return None
        del self._pending[slot]
        self.reserved[slot] = False
        self.active[slot] = True
        self.lengths[slot] = lp
        self.tokens[slot] = first
        self._pool_prefix(pend["prompt"], lp, slot)
        return first

    def pending_tokens(self, slot: int) -> int:
        """Prompt tokens a pending admission still has to prefill."""
        pend = self._pending[slot]
        return pend["lp"] - pend["filled"]

    def has_pending(self, slot: int) -> bool:
        """Whether ``slot`` holds an in-progress (begin_insert) admission."""
        return slot in self._pending

    def abort_insert(self, slot: int) -> None:
        """Release a reserved slot whose admission will not complete."""
        if slot not in self._pending:
            raise RuntimeError(f"slot {slot} has no pending admission")
        del self._pending[slot]
        self.reserved[slot] = False
        self.lengths[slot] = 0

    def decode_logits(self, only=None) -> torch.Tensor:
        """The forward of one decode iteration without sampling: every
        ACTIVE slot (or the ``only`` subset) writes its last token's K/V at
        its current length and reads its KV.  Returns (slots, vocab) f32
        logits on the device; host lengths and tokens are left as they
        are, so a following ``advance`` rewrites the same K/V."""
        mask = self.active if only is None else np.asarray(only, np.bool_)
        live = self.lengths[mask]
        if live.size and int(live.max()) >= self.max_len:
            raise SlotOverflow(
                f"active slot at length {int(live.max())} would write past "
                f"max_len={self.max_len}; the scheduler must bound "
                f"prompt + max_new_tokens at admission")
        for slot in np.flatnonzero(mask):
            pos = int(self.lengths[slot])
            self._ensure_writable(int(slot), pos, pos + 1)
        return self._decode_forward(mask)[:, -1]

    def advance(self, only=None) -> np.ndarray:
        """One decode iteration: every ACTIVE slot (or the ``only`` subset)
        consumes its last token and emits the next one; lengths advance by
        one.  Returns the (slots,) token vector — rows that did not take
        part carry their stale token."""
        mask = self.active if only is None else np.asarray(only, np.bool_)
        t0 = time.perf_counter()
        logits = self.decode_logits(mask)
        nxt = self._sample(logits).cpu().numpy().astype(np.int32)
        self._phase_s["decode_s"] += time.perf_counter() - t0
        nxt = np.where(mask, nxt, self.tokens)
        self.lengths[mask] += 1
        self.tokens = nxt
        return nxt

    def evict(self, slot: int) -> None:
        """Free a slot.  Monolithic: host bookkeeping only — stale K/V is
        unreachable (validity is length-driven) and the next prefill
        overwrites it."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        self.active[slot] = False
        self.lengths[slot] = 0
        self.tokens[slot] = 0

    def phase_times(self) -> dict[str, float]:
        """Cumulative host-observed seconds in prefill and decode forwards
        (each ends in a device→host read of its sampled tokens, so device
        time is included)."""
        return dict(self._phase_s)

    # ------------------------------------------------------------ forwards
    def _forward(self, tokens: np.ndarray, positions: np.ndarray, kv,
                 **kw) -> torch.Tensor:
        """One model forward over (B, L) tokens at (B, L) positions,
        writing ``kv`` in place; returns the logits."""
        with torch.no_grad():
            return self.model(
                torch.from_numpy(tokens.astype(np.int64)).to(self.device),
                positions=torch.from_numpy(
                    positions.astype(np.int32)).to(self.device),
                pools=kv, **kw)

    def _rows(self, slot: int) -> list[dict]:
        """Every layer's leaves restricted to one slot's row (views)."""
        return [{n: t[slot:slot + 1] for n, t in layer.items()}
                for layer in self.cache]

    def _ensure_writable(self, slot: int, start: int, end: int) -> None:
        """Make positions ``[start, end)`` of ``slot`` writable (the
        monolithic row always is)."""

    def _prefill_forward(self, slot, tokens, positions) -> torch.Tensor:
        return self._forward(tokens, positions, self._rows(slot))

    def _decode_forward(self, mask) -> torch.Tensor:
        return self._forward(self.tokens[:, None], self.lengths[:, None],
                             self.cache)

    # --------------------------------------------------------- prefix pool
    def _prefix_keys(self, prompt: np.ndarray, n_blocks: int) -> list[bytes]:
        """Chained block keys: block b's key is SHA-256 of (block b-1's
        key ‖ block b's token bytes), so a block matches only when every
        block before it matched, at O(L) work and constant key size."""
        blk = self.prefix_block
        keys, prev = [], b""
        for b in range(n_blocks):
            h = hashlib.sha256(prev)
            h.update(prompt[b * blk:(b + 1) * blk].tobytes())
            prev = h.digest()
            keys.append(prev)
        return keys

    def _match(self, keys: list[bytes]) -> int:
        """Leading keys present in the pool."""
        matched = 0
        for key in keys:
            if key not in self._prefix_pool:
                break
            matched += 1
        return matched

    def _restore_prefix(self, prompt: np.ndarray, lp: int,
                        slot: int) -> int:
        """Copy the longest cached block-aligned prefix into ``slot``;
        returns the reused positions.  Reuse is capped at the full blocks
        before the last prompt token, which is always recomputed (its
        logits sample the first token)."""
        if not self.prefix_cache_blocks:
            return 0
        blk = self.prefix_block
        usable = (lp - 1) // blk    # full blocks strictly before the tail
        insertable = lp // blk      # full blocks the prompt will pool
        keys = self._prefix_keys(prompt, usable)
        matched = self._match(keys)
        self.prefix_stats["hits"] += matched
        self.prefix_stats["misses"] += insertable - matched
        self.prefix_stats["tokens_reused"] += matched * blk
        for b, key in enumerate(keys[:matched]):
            self._prefix_pool.move_to_end(key)   # LRU touch
            span = slice(b * blk, (b + 1) * blk)
            for layer, entry in zip(self.cache, self._prefix_pool[key]):
                for name, t in layer.items():
                    t[slot, span].copy_(entry[name])
        return matched * blk

    def _pool_prefix(self, prompt: np.ndarray, lp: int, slot: int) -> None:
        """After a completed prefill, pool a copy of every full prompt
        block not already cached, evicting least-recently-used entries
        past the bound.  An entry is a clone: a view would alias the
        slot's row, which its next occupant overwrites."""
        if not self.prefix_cache_blocks:
            return
        blk = self.prefix_block
        for b, key in enumerate(self._prefix_keys(prompt, lp // blk)):
            if key in self._prefix_pool:
                self._prefix_pool.move_to_end(key)
                continue
            span = slice(b * blk, (b + 1) * blk)
            self._prefix_pool[key] = [
                {name: t[slot, span].clone() for name, t in layer.items()}
                for layer in self.cache]
            self.prefix_stats["inserted_blocks"] += 1
        while len(self._prefix_pool) > self.prefix_cache_blocks:
            self._prefix_pool.popitem(last=False)
            self.prefix_stats["evictions"] += 1

    def prefix_cache_stats(self) -> dict | None:
        """Cumulative hit/miss/evict accounting (None when the pool is
        off); ``hit_rate`` is reused blocks over reusable + pooled ones."""
        if not self.prefix_cache_blocks:
            return None
        s = dict(self.prefix_stats)
        total = s["hits"] + s["misses"]
        s["cached_blocks"] = len(self._prefix_pool)
        s["hit_rate"] = s["hits"] / total if total else 0.0
        return s

    def reset_prefix_cache(self) -> None:
        """Drop pooled blocks and zero the accounting."""
        self._prefix_pool.clear()
        for k in self.prefix_stats:
            self.prefix_stats[k] = 0

    # --------------------------------------------------------- accounting
    def _leaf_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for layer in self.cache for t in layer.values())

    def kv_bytes_per_slot(self) -> int:
        """Stored KV-table bytes per slot: every leaf (K/V and, under
        int8, the f32 scales) over the slot count."""
        return self._leaf_bytes() // self.slots


class PagedSlotKVCache(SlotKVCache):
    """Paged KV layout: one physical block pool per layer shared by every
    slot + host-owned per-slot block tables (module docstring).
    ``paged_block`` (default ``prefix_block``) must divide ``max_len`` and
    equal ``prefix_block`` when the prefix pool is on: a hit aliases pool
    blocks by id."""

    def __init__(self, model, params, slots: int, *, kv_layout: str = "paged",
                 prefix_cache_blocks: int = 0, prefix_block: int = 16,
                 paged_blocks: int = 0, paged_block: int = 0,
                 paged_fused: bool = True, **kwargs):
        if kv_layout != "paged":
            raise ValueError("PagedSlotKVCache is the kv_layout='paged' "
                             "implementation")
        if prefix_cache_blocks and paged_block \
                and int(paged_block) != int(prefix_block):
            raise ValueError(
                f"paged_block ({paged_block}) must equal prefix_block "
                f"({prefix_block}) when the prefix pool is on: pool hits "
                f"alias physical blocks by pointer")
        block = int(paged_block) if paged_block else int(prefix_block)
        if block < 1:
            raise ValueError(f"paged_block must be positive, got {block}")
        if model.max_len % block:
            raise ValueError(
                f"paged_block={block} must divide max_len={model.max_len}")
        self.paged_block = block
        self.max_blocks = model.max_len // block          # table width
        # default pool: every slot can grow to max_len (+1 block of CoW
        # headroom per slot when hits can alias) and the prefix pool can
        # pin its whole capacity, so the default never exhausts; smaller
        # explicit pools rely on can_admit
        cow_pad = 1 if prefix_cache_blocks else 0
        self.num_blocks = int(paged_blocks) if paged_blocks else (
            slots * (self.max_blocks + cow_pad) + int(prefix_cache_blocks))
        if self.num_blocks < self.max_blocks + cow_pad:
            raise ValueError(
                f"paged_blocks={self.num_blocks} cannot hold even one full "
                f"slot ({self.max_blocks} blocks + {cow_pad} CoW headroom)")
        self._scratch = self.num_blocks  # physical id of the scratch block
        self.paged_fused = bool(paged_fused)
        super().__init__(model, params, slots, kv_layout="paged",
                         prefix_cache_blocks=prefix_cache_blocks,
                         prefix_block=block, **kwargs)

        # the paged substrate: refcounted physical blocks, a free list,
        # per-slot logical→physical tables (host numpy; the device sees a
        # masked snapshot per forward)
        self._block_refs = np.zeros(self.num_blocks, np.int32)
        self._free_list = list(range(self.num_blocks))[::-1]  # pop() → 0,1,..
        self._slot_blocks: list[list[int]] = [[] for _ in range(self.slots)]
        self.block_tables_np = np.full(
            (self.slots, self.max_blocks), self._scratch, np.int32)
        # committed block budgets (can_admit's outstanding ledger)
        self._slot_need = np.zeros(self.slots, np.int32)
        self._paged_counters = {"zero_copy_hits": 0, "zero_copy_blocks": 0,
                                "zero_copy_tokens": 0, "cow_copies": 0}
        self._bt_cache: tuple[np.ndarray, torch.Tensor] | None = None

    def _init_cache(self) -> list[dict]:
        return [self._layer_cache((self.num_blocks + 1, self.paged_block),
                                  ("key_pool", "value_pool",
                                   "key_scale_pool", "value_scale_pool"))
                for _ in range(self.model.layers)]

    # -------------------------------------------------- block bookkeeping
    @property
    def blocks_in_use(self) -> int:
        """Allocated physical blocks (scratch excluded)."""
        return self.num_blocks - len(self._free_list)

    def _alloc_block(self) -> int:
        if not self._free_list:
            raise BlockPoolExhausted(
                f"paged KV pool exhausted: all {self.num_blocks} blocks in "
                f"use — the scheduler's can_admit gate should have deferred "
                f"this admission")
        bid = self._free_list.pop()
        self._block_refs[bid] = 1
        return bid

    def _release_block(self, bid: int) -> None:
        self._block_refs[bid] -= 1
        if self._block_refs[bid] == 0:
            self._free_list.append(bid)

    def _release_slot_blocks(self, slot: int) -> None:
        for bid in self._slot_blocks[slot]:
            self._release_block(bid)
        self._slot_blocks[slot].clear()
        self.block_tables_np[slot, :] = self._scratch
        self._slot_need[slot] = 0

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one physical block in every layer's pools, int8 scale
        pools included (in place)."""
        for layer in self.cache:
            for pool in layer.values():
                pool[dst].copy_(pool[src])

    def _ensure_writable(self, slot: int, start: int, end: int) -> None:
        """Make positions ``[start, end)`` of ``slot`` safely writable:
        allocate missing blocks, copy-on-write shared ones (refcount > 1:
        aliased from the prefix pool or pinned by it) — the slot's table
        then points at its private copy and every other sharer keeps
        reading the original."""
        if end <= start:
            return
        sb = self._slot_blocks[slot]
        blk = self.paged_block
        last = min((end - 1) // blk, self.max_blocks - 1)
        for j in range(start // blk, last + 1):
            while len(sb) <= j:      # extend coverage with fresh blocks
                bid = self._alloc_block()
                sb.append(bid)
                self.block_tables_np[slot, len(sb) - 1] = bid
            bid = sb[j]
            if self._block_refs[bid] > 1:   # shared → copy-on-write
                new = self._alloc_block()
                self._copy_block(bid, new)
                self._release_block(bid)
                sb[j] = new
                self.block_tables_np[slot, j] = new
                self._paged_counters["cow_copies"] += 1


    def _masked_bt(self, mask) -> torch.Tensor:
        """Device block-table snapshot with non-participating rows routed
        wholly to scratch.  An unchanged table is not uploaded again."""
        bt = np.where(np.asarray(mask, np.bool_)[:, None],
                      self.block_tables_np, np.int32(self._scratch))
        bt = bt.astype(np.int32)
        if self._bt_cache is not None and np.array_equal(self._bt_cache[0],
                                                         bt):
            return self._bt_cache[1]
        dev = torch.from_numpy(bt).to(self.device)
        self._bt_cache = (bt, dev)
        return dev

    # ------------------------------------------------- admission budgets
    def _block_need(self, total_len: int) -> int:
        need = -(-int(total_len) // self.paged_block)
        pad = 1 if self.prefix_cache_blocks else 0
        # CoW headroom: a fully aligned prefix hit recomputes its last
        # token into a shared block
        return min(need + pad, self.max_blocks + pad)

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Block-exhaustion admission gate: free blocks, minus what live
        admissions may still claim under their budgets, must cover this
        request's worst-case need."""
        outstanding = sum(
            max(int(self._slot_need[s]) - len(self._slot_blocks[s]), 0)
            for s in range(self.slots) if self._slot_need[s])
        need = self._block_need(int(prompt_len) + int(max_new_tokens))
        return len(self._free_list) - outstanding >= need

    def note_admission(self, slot: int, total_len: int) -> None:
        """Register an admitted request's worst-case block budget (prompt
        + max_new_tokens); cleared on evict/abort."""
        self._slot_need[slot] = self._block_need(total_len)

    # ------------------------------------------------------------ forwards
    def _prefill_forward(self, slot, tokens, positions) -> torch.Tensor:
        """The gather read over the slot's own block table row."""
        bt_row = torch.from_numpy(
            self.block_tables_np[slot:slot + 1].copy()).to(self.device)
        return self._forward(tokens, positions, self.cache,
                             block_tables=bt_row, paged_fused=False)

    def _decode_forward(self, mask) -> torch.Tensor:
        """The fused read (or the gather read with ``paged_fused=False``)
        over the masked block tables."""
        return self._forward(self.tokens[:, None], self.lengths[:, None],
                             self.cache, block_tables=self._masked_bt(mask),
                             paged_fused=self.paged_fused)

    def abort_insert(self, slot: int) -> None:
        super().abort_insert(slot)
        self._release_slot_blocks(slot)

    def evict(self, slot: int) -> None:
        """Free a slot and release its blocks."""
        super().evict(slot)
        self._release_slot_blocks(slot)

    # --------------------------------------------------------- prefix pool
    def _restore_prefix(self, prompt: np.ndarray, lp: int,
                        slot: int) -> int:
        """The zero-copy hit: matched pool blocks are aliased into the
        slot's block table with a refcount bump.  Reuse covers full blocks
        up to the one holding the last prompt token (unlike the monolithic
        ``(lp - 1) // blk`` cap) but at most ``lp - 1`` positions: the
        last token is recomputed, and its write into a shared block goes
        through copy-on-write."""
        if not self.prefix_cache_blocks:
            return 0
        blk = self.prefix_block
        usable = lp // blk
        keys = self._prefix_keys(prompt, usable)
        matched = self._match(keys)
        reused = min(matched * blk, lp - 1)
        self.prefix_stats["hits"] += matched
        self.prefix_stats["misses"] += usable - matched
        self.prefix_stats["tokens_reused"] += reused
        if not matched:
            return 0
        sb = self._slot_blocks[slot]
        for b, key in enumerate(keys[:matched]):
            self._prefix_pool.move_to_end(key)   # LRU touch
            bid = self._prefix_pool[key]
            self._block_refs[bid] += 1
            sb.append(bid)
            self.block_tables_np[slot, b] = bid
        self._paged_counters["zero_copy_hits"] += 1
        self._paged_counters["zero_copy_blocks"] += matched
        self._paged_counters["zero_copy_tokens"] += reused
        return reused

    def _pool_prefix(self, prompt: np.ndarray, lp: int, slot: int) -> None:
        """Pool = pin: every full prompt block not already pooled gets a
        refcount pin on the slot's own physical block (no copy)."""
        if not self.prefix_cache_blocks:
            return
        sb = self._slot_blocks[slot]
        for b, key in enumerate(self._prefix_keys(prompt,
                                                  lp // self.prefix_block)):
            if key in self._prefix_pool:
                self._prefix_pool.move_to_end(key)
                continue
            self._block_refs[sb[b]] += 1          # the pool's pin
            self._prefix_pool[key] = sb[b]
            self.prefix_stats["inserted_blocks"] += 1
        while len(self._prefix_pool) > self.prefix_cache_blocks:
            _, bid = self._prefix_pool.popitem(last=False)
            self._release_block(bid)
            self.prefix_stats["evictions"] += 1

    def reset_prefix_cache(self) -> None:
        """Release the pool's pins and zero the pool and zero-copy/CoW
        accounting."""
        while self._prefix_pool:
            _, bid = self._prefix_pool.popitem(last=False)
            self._release_block(bid)
        super().reset_prefix_cache()
        for k in self._paged_counters:
            self._paged_counters[k] = 0

    # --------------------------------------------------------- accounting
    def kv_bytes_per_slot(self) -> int:
        """Bytes actually backing live sequences — allocated pool blocks
        (every layer's K and V, and int8 scales) plus the block tables —
        amortized over live (active or reserved) slots."""
        per_block = self._leaf_bytes() // (self.num_blocks + 1)
        live = int(self.active.sum()) + int(self.reserved.sum())
        return (self.blocks_in_use * per_block
                + self.block_tables_np.nbytes) // max(live, 1)

    def paged_stats(self) -> dict:
        """Pool utilization + the zero-copy/CoW ledger (cumulative)."""
        return {"num_blocks": self.num_blocks,
                "block": self.paged_block,
                "blocks_in_use": self.blocks_in_use,
                "utilization": self.blocks_in_use / self.num_blocks,
                **dict(self._paged_counters)}
