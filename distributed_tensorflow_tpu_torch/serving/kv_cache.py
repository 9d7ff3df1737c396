"""Slot KV cache, paged layout (port of ``serving/kv_cache.py``).

The device half of the serving engine.  ``SlotKVCache(model, params,
slots, kv_layout="paged")`` builds a ``PagedSlotKVCache``: one physical KV
block pool per layer, shared by every slot, plus host-owned per-slot int32
block tables, refcounts and a free list (vLLM PagedAttention, Kwon et al.,
arXiv:2309.06180).

* Prefill (``begin_insert``/``prefill_chunk``, ``insert``) runs the
  model's gather read: block-table gather + masked dense attention.
* Decode (``advance``) runs the fused read: the Hopper kernel of
  ``ops.paged_attention``, one launch per layer per decode step.
* The pool carries one extra SCRATCH block (id ``num_blocks``): unmapped
  table entries point at it, and during decode the rows of slots that do
  not take part are routed wholly to it, so their garbage writes never land
  in a live block.

Differences from the JAX table, all in how work is issued, none in what is
computed: PyTorch runs eagerly, so there are no compiled programs and no
power-of-two prefill buckets — a chunk of ``n`` prompt tokens is one
forward over exactly ``n`` positions (the JAX chunk scans the same
positions one token at a time under the same per-position mask; pad
positions never influence real ones).  The pools are updated in place.

Parity contract (as in the JAX package): prefill (gather path) and decode
on the gather path are the dense math; the fused decode read agrees with
it within a tolerance (online-softmax reassociation), not bitwise.

Ported: greedy sampling, chunked prefill, block allocation with refcounts
and copy-on-write, admission budgets, the fused decode step, eviction and
the accounting.  Not ported yet, each raising ``NotImplementedError``: the
monolithic layout, the prefix pool, temperature sampling, int8 KV,
``advance_multi``, speculative verify/commit/rewind, the disaggregated
handoff, ``swap_params`` and mesh sharding.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import not_ported, resolve_device


class SlotOverflow(RuntimeError):
    """An active slot was asked to write past its ``max_len`` capacity
    (admission bounds prompt + max_new_tokens, so this is a bookkeeping
    bug, never a user error)."""


class BlockPoolExhausted(RuntimeError):
    """The paged KV block pool has no free physical block for a required
    write (``can_admit`` should have deferred the admission)."""


class SlotKVCache:
    """Fixed slot table for one ``GPTLM``: host slot bookkeeping shared by
    the layouts.  ``kv_layout="paged"`` constructs ``PagedSlotKVCache``;
    the monolithic layout is not ported yet."""

    def __new__(cls, *args, kv_layout: str = "monolithic", **kwargs):
        # one kwarg selects the layout at every call site, as in the JAX
        # package
        if cls is SlotKVCache and kv_layout == "paged":
            return super().__new__(PagedSlotKVCache)
        return super().__new__(cls)

    def __init__(self, model, params, slots: int, *,
                 kv_layout: str = "monolithic", **kwargs):
        if kv_layout not in ("monolithic", "paged"):
            raise ValueError(f"kv_layout must be 'monolithic' or 'paged', "
                             f"got {kv_layout!r}")
        not_ported("the monolithic slot table (kv_layout='monolithic')",
                    "prefix pool and monolithic layout")

    # ------------------------------------------------------------ slot API
    @property
    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots)
                if not (self.active[i] or self.reserved[i])]

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

    def begin_insert(self, prompt,
                     slot: int | None = None) -> tuple[int, int]:
        """Claim a slot for a chunk-by-chunk admission; returns
        ``(slot, reused_tokens)`` (always 0 reused: the prefix pool is not
        ported).  The slot stays RESERVED until the final
        ``prefill_chunk`` activates it."""
        prompt, lp, slot = self._claim_slot(prompt, slot)
        self.reserved[slot] = True
        self.lengths[slot] = 0
        self._pending[slot] = {"prompt": prompt, "lp": lp, "filled": 0}
        return slot, 0

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

    def phase_times(self) -> dict[str, float]:
        """Cumulative host-observed seconds in prefill and decode forwards
        (each ends in a device→host read of its sampled tokens, so device
        time is included)."""
        return dict(self._phase_s)


class PagedSlotKVCache(SlotKVCache):
    """Paged KV layout: one physical block pool per layer shared by every
    slot + host-owned per-slot block tables (module docstring).

    ``model`` is a port ``GPTLM``; ``params``, when given, is a
    ``state_dict`` loaded into it.  The model is moved to ``device``
    (``None`` = the CUDA card)."""

    def __init__(self, model, params, slots: int, *, device=None,
                 mesh=None, greedy: bool = True, kv_dtype=None,
                 prefix_cache_blocks: int = 0, prefix_block: int = 16,
                 kv_layout: str = "paged", paged_blocks: int = 0,
                 paged_block: int = 0, paged_fused: bool = True,
                 ledger=None):
        if kv_layout != "paged":
            raise ValueError("PagedSlotKVCache is the kv_layout='paged' "
                             "implementation")
        if mesh is not None:
            not_ported("mesh-sharded slot tables", "remaining engines")
        if not greedy:
            not_ported("temperature sampling (greedy=False)",
                        "speculative verify and advance_multi")
        if prefix_cache_blocks:
            not_ported("the prefix pool (prefix_cache_blocks > 0)",
                        "prefix pool and monolithic layout")
        if ledger is not None:
            not_ported("the compile/memory ledger", "rest of observability")
        if slots < 1:
            raise ValueError(f"slots must be positive, got {slots}")
        if prefix_block < 1:
            raise ValueError(f"prefix_block must be positive, got "
                             f"{prefix_block}")
        self.kv_layout = "paged"
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.max_len = int(model.max_len)
        self.greedy = True
        block = int(paged_block) if paged_block else int(prefix_block)
        if block < 1:
            raise ValueError(f"paged_block must be positive, got {block}")
        if self.max_len % block:
            raise ValueError(
                f"paged_block={block} must divide max_len={self.max_len}")
        self.paged_block = block
        self.max_blocks = self.max_len // block          # table width
        # default pool: every slot can grow to max_len, so the default
        # never exhausts; smaller explicit pools rely on can_admit
        self.num_blocks = (int(paged_blocks) if paged_blocks
                           else self.slots * self.max_blocks)
        if self.num_blocks < self.max_blocks:
            raise ValueError(
                f"paged_blocks={self.num_blocks} cannot hold even one full "
                f"slot ({self.max_blocks} blocks)")
        self._scratch = self.num_blocks  # physical id of the scratch block

        if kv_dtype is not None:
            if isinstance(kv_dtype, str):
                from distributed_tensorflow_tpu_torch.models import (
                    resolve_dtype)
                kv_dtype = (torch.int8 if kv_dtype == "int8"
                            else resolve_dtype(kv_dtype))
            if kv_dtype == torch.int8:
                not_ported("int8 KV storage (kv_dtype='int8')",
                            "speculative verify and advance_multi")
        self.paged_fused = bool(paged_fused)
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state_dict(params)
        store = kv_dtype if kv_dtype is not None else model.dtype
        self.kv_dtype = str(store).removeprefix("torch.")
        shape = (self.num_blocks + 1, block, model.kv_heads, model.head_dim)
        self.cache = [
            {"key_pool": torch.zeros(shape, dtype=store, device=self.device),
             "value_pool": torch.zeros(shape, dtype=store,
                                       device=self.device)}
            for _ in range(model.layers)]

        # host slot table
        self.lengths = np.zeros(self.slots, np.int32)
        self.active = np.zeros(self.slots, np.bool_)
        self.reserved = np.zeros(self.slots, np.bool_)
        self.tokens = np.zeros(self.slots, np.int32)   # last token per slot
        self._pending: dict[int, dict] = {}

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

        self.prefill_tokens_computed = 0
        self._phase_s = {"prefill_s": 0.0, "decode_s": 0.0}

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
        """Copy one physical block in every layer's pools (in place)."""
        for layer in self.cache:
            for pool in layer.values():
                pool[dst].copy_(pool[src])

    def _ensure_writable(self, slot: int, start: int, end: int) -> None:
        """Make positions ``[start, end)`` of ``slot`` safely writable:
        allocate missing blocks, copy-on-write shared ones (refcount > 1):
        the slot's table then points at its private copy and every other
        sharer keeps reading the original."""
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
        return min(need, self.max_blocks)

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
    def _forward(self, tokens: np.ndarray, positions: np.ndarray, bt,
                 fused: bool) -> torch.Tensor:
        """One model forward over (B, L) tokens at (B, L) positions,
        writing the pools in place; returns the logits."""
        with torch.no_grad():
            return self.model(
                torch.from_numpy(tokens.astype(np.int64)).to(self.device),
                positions=torch.from_numpy(
                    positions.astype(np.int32)).to(self.device),
                block_tables=bt, pools=self.cache, paged_fused=fused)

    def insert(self, prompt, slot: int | None = None) -> tuple[int, int]:
        """Admit a prompt (``begin_insert`` + one uncapped chunk); returns
        ``(slot, first_token)``."""
        slot, _ = self.begin_insert(prompt, slot)
        try:
            first = self.prefill_chunk(slot)
        except BaseException:
            if self.has_pending(slot):
                self.abort_insert(slot)
            elif self.active[slot]:
                self.evict(slot)
            raise
        return slot, first

    def prefill_chunk(self, slot: int,
                      max_tokens: int | None = None) -> int | None:
        """Prefill the next ≤ ``max_tokens`` prompt tokens of a pending
        admission through the gather read.  Returns the first generated
        token when this was the final chunk (the slot becomes active),
        else None."""
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
        # allocation + CoW before the forward: its writes must only land
        # in private (or scratch) blocks
        self._ensure_writable(slot, filled, filled + n)
        bt_row = torch.from_numpy(
            self.block_tables_np[slot:slot + 1].copy()).to(self.device)
        t0 = time.perf_counter()
        logits = self._forward(
            pend["prompt"][None, filled:filled + n],
            np.arange(filled, filled + n, dtype=np.int32)[None, :],
            bt_row, fused=False)
        first = int(logits[0, -1].argmax())
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
        return first

    def decode_logits(self, only=None) -> torch.Tensor:
        """The forward of one decode iteration without sampling: every
        ACTIVE slot (or the ``only`` subset) writes its last token's K/V at
        its current length and reads through the paged pool (fused or
        gather, per ``paged_fused``).  Returns (slots, vocab) f32 logits on
        the device; host lengths and tokens are left as they are, so a
        following ``advance`` rewrites the same K/V."""
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
        logits = self._forward(self.tokens[:, None], self.lengths[:, None],
                               self._masked_bt(mask), fused=self.paged_fused)
        return logits[:, -1]

    def advance(self, only=None) -> np.ndarray:
        """One decode iteration: every ACTIVE slot (or the ``only`` subset)
        consumes its last token and emits the next one through the fused
        read; lengths advance by one.  Returns the (slots,) token vector —
        rows that did not take part carry their stale token."""
        mask = self.active if only is None else np.asarray(only, np.bool_)
        t0 = time.perf_counter()
        logits = self.decode_logits(mask)
        nxt = logits.argmax(-1).cpu().numpy().astype(np.int32)
        self._phase_s["decode_s"] += time.perf_counter() - t0
        nxt = np.where(mask, nxt, self.tokens)
        self.lengths[mask] += 1
        self.tokens = nxt
        return nxt

    def abort_insert(self, slot: int) -> None:
        super().abort_insert(slot)
        self._release_slot_blocks(slot)

    def evict(self, slot: int) -> None:
        """Free a slot and release its blocks."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        self._release_slot_blocks(slot)
        self.active[slot] = False
        self.lengths[slot] = 0
        self.tokens[slot] = 0

    # --------------------------------------------------------- accounting
    def kv_bytes_per_slot(self) -> int:
        """Bytes actually backing live sequences — allocated pool blocks
        (every layer's K and V) plus the block tables — amortized over
        live (active or reserved) slots."""
        per_block = sum(pool[0].numel() * pool.element_size()
                        for layer in self.cache for pool in layer.values())
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
