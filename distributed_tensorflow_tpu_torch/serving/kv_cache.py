"""Slot KV cache (port of ``serving/kv_cache.py``).

The device half of the serving engine: a fixed table of ``slots``
independent sequences, each with its own length, advanced together by one
decode step.  Two layouts, selected by ``kv_layout`` as in the JAX package:

* ``SlotKVCache(model, params, slots)`` — monolithic: one
  ``(slots, max_len + 1, kv_heads, head_dim)`` K/V row per slot and layer,
  read by masked dense attention over its first ``max_len`` columns.  The
  last column is scratch: a write at or past ``max_len`` lands there (the
  JAX scatter drops it), so every write has a static shape.  Decode rows
  that do not take part write garbage at their own length, invisible under
  the length-driven mask and overwritten by their next real write.  The
  scratch column is not counted in ``kv_bytes_per_slot``.
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

Multi-step decode and speculative verify (JAX ``kv_cache.py:1017-1286``):
``dispatch_multi(k)`` issues a fused round of ``k`` decode steps with
token feedback and in-device deactivation (EOS, budget, ``max_len``)
without waiting for it; ``drain_multi`` waits for the oldest round and
folds its ``(k, slots)`` token/active stacks into the host mirrors, FIFO;
``advance_multi`` is the two back to back.  On the card a round is one
CUDA graph replay (``serving/decode_graph.py``), captured per ``k`` on its
second use (the first runs eagerly on a side stream); on the CPU the same
body runs as an eager loop.  The round reads static device buffers that
the host refreshes only when their value changed (``_dev_cached``), and its
stacks come back through a pinned buffer of its own behind a CUDA event.
``verify_block`` scores a ``(slots, width)`` token block in one forward
(greedy argmaxes), whose GEMMs and attention reads run one query column at
a time, so that each column is bitwise the decode step at its prefix
(``GPTLM.forward(by_column=True)``); ``commit_block`` and ``rewind`` roll
back by length bookkeeping alone.  ``dispatch_count`` counts every forward issued: a
prefill chunk, a decode step, a verify, a fused round.

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

``mesh`` (JAX ``SlotKVCache(mesh=...)``, every rank of the mesh builds
the table and drives it alike): a model with ``partition_model`` on a
mesh with a 'model' axis decodes Megatron-cut
(``models.gpt.decode_model``: a bound model as it is, an unbound one
bound to the mesh from its whole parameters), and every layer's leaves
hold the K/V heads of the layer's attention on this rank
(``GPTLM.kv_heads_local``: ``kv_heads/tp`` where ``bind_tp`` cut them,
``parallel.mesh.kv_slot_sharding``): the paged pool of a rank is its own
contiguous ``(num_blocks + 1, block, kv_heads/tp, D)`` tensor, so the
Hopper kernel reads it at that head count.  ``slots`` must divide by the
'data' axis (JAX's message), but the table is replicated over 'data':
every data rank serves every slot (JAX splits the slots over 'data'; the
streams are the same).  The host state (block tables, the zero-copy
ledger, refcounts, the prefix pool) is the same on every rank, since
each makes the same host decisions (``serving.scheduler``: the batcher
refuses arrivals that a wall clock could admit apart); the sampling
generator is seeded alike, so every rank draws the same token.  A TP
table's decode round holds NCCL calls (the row-parallel sums, the
embedding's and the head's gather), so it runs eagerly, never captured
(``eager_rounds``).

``ledger`` (``observability.xla_stats.ProgramLedger``, JAX
``SlotKVCache(ledger=)``): the first call of each entry point per shape
signature (a prefill chunk of ``n`` tokens, the decode step, a verify of
``width`` columns) and each captured round is recorded under JAX's
program name (``kv_prefill_chunk_l<n>``, ``kv_decode_step``,
``kv_verify_w<width>``, ``kv_decode_multi_k<k>``; ``kv_paged_…`` for the
paged table) with its wall time and the card's memory around it.  It
observes and changes nothing that runs.

``swap_params`` (JAX ``swap_params``, the fleet's weight hot-swap) copies
a state_dict of the same keys, shapes and dtypes into the table's own
model's parameters in place, on the current stream: a captured round replays the addresses it captured, so the swap
reaches it without a recapture.  It empties the prefix pool, whose blocks
hold KV of the old weights (JAX's swap keeps them).  The disaggregated handoff is absent.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from collections import OrderedDict

import numpy as np
import torch

from distributed_tensorflow_tpu_torch import resolve_device
from distributed_tensorflow_tpu_torch.models.gpt import (
    decode_model, sample_tokens)
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.serving.decode_graph import RoundGraph


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
    (``greedy=False``); by default a generator on the device seeded 0.
    ``mesh``: a TP table (module docstring)."""

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
        self._ledger = ledger
        self.slots = int(slots)
        self.max_len = int(model.max_len)
        self.greedy = bool(greedy)
        self.temperature = float(temperature)
        self.generator = (generator if generator is not None
                          else torch.Generator(self.device).manual_seed(0))
        model = model.to(self.device)
        self.mesh = mesh
        if mesh is not None:
            dp = mesh.shape.get(meshlib.DATA_AXIS, 1)
            if self.slots % dp:
                raise ValueError(
                    f"slots ({self.slots}) must divide by the mesh's data "
                    f"axis ({dp}): each data shard owns a contiguous slot "
                    f"block")
            model = decode_model(model, params, mesh)
        elif params is not None:
            model.load_state_dict(params)
        self.model = model
        self._kv_heads = model.kv_heads_local()
        # a TP table's round holds NCCL calls: eager, never captured
        self.eager_rounds = model.tp_mesh is not None
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
        self._init_multi_state()
        self.cache = self._init_cache()

    def swap_params(self, params) -> None:
        """Zero-downtime weight hot-swap (JAX ``swap_params``): copy
        ``params``, a state_dict of the served model (same keys, shapes
        and dtypes), into the model's own parameters, in place, on the
        current stream (the fleet enters the replica's stream and drains
        its in-flight slots first: KV written under the old weights must
        never be decoded under the new ones).  Every address stays, so a
        captured round replays on the new weights and a swap never
        recaptures.  The prefix pool is emptied: its blocks hold KV of
        the old weights.  On the card the stream is synchronized before
        returning, so the source tensors may be freed."""
        served = self.model.state_dict()
        if set(params) != set(served):
            raise ValueError(
                "swap_params needs the same param tree structure as the "
                "served checkpoint (same model config) — a different "
                "architecture cannot hot-swap into live slots")
        new = {k: torch.as_tensor(params[k]) for k in served}
        mismatch = [
            f"{k}: {tuple(a.shape)}/{str(a.dtype).removeprefix('torch.')} "
            f"vs {tuple(b.shape)}/{str(b.dtype).removeprefix('torch.')}"
            for k, a in served.items() for b in (new[k],)
            if a.shape != b.shape or a.dtype != b.dtype]
        if mismatch:
            raise ValueError(
                f"swap_params shape/dtype mismatch (a swap must be a "
                f"compiled-program cache hit): {mismatch[:3]}")
        # the pool's blocks hold KV the old weights wrote (JAX's swap
        # keeps them, so a later hit would decode over stale KV)
        self._drop_pool()
        with torch.no_grad():
            for k, t in served.items():
                t.copy_(new[k], non_blocking=False)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _init_multi_state(self) -> None:
        """The multi-step decode state (JAX ``kv_cache.py:261-283``).
        ``eos_tok``/``budget`` arm the fused round's in-device
        deactivation (-1 = no EOS, 0 = unlimited: the draft table's mode);
        ``halted`` mirrors slots the device stopped that the scheduler has
        not evicted yet; ``_inflight`` counts each slot's steps dispatched
        and not drained.  ``_dev_vecs`` holds the static device buffers of
        ``_dev_cached`` beside the host value each holds; ``_carry`` the
        fused round's device state after the last round."""
        self.eos_tok = np.full(self.slots, -1, np.int32)
        self.budget = np.zeros(self.slots, np.int32)
        self.halted = np.zeros(self.slots, np.bool_)
        self.dispatch_count = 0
        self._dev_vecs: dict[str, tuple[np.ndarray, torch.Tensor]] = {}
        # host view at the last dispatch (None: the device carry is not
        # the last round's)
        self._multi_snap = None
        self._multi_pending: list[dict] = []    # in-flight rounds (FIFO)
        self._inflight = np.zeros(self.slots, np.int32)
        self._carry = {name: torch.zeros(self.slots, dtype=dtype,
                                         device=self.device)
                       for name, dtype in (("tokens", torch.int64),
                                           ("lengths", torch.int32),
                                           ("active", torch.bool),
                                           ("budget", torch.int32))}
        self._round_out: dict[int, torch.Tensor] = {}   # k → (3, k, slots)
        self._graphs: dict[int, RoundGraph] = {}
        self._eager_rounds: set[int] = set()

    def _drop_graphs(self) -> None:
        """Forget the captured rounds: a graph replays the tensors it was
        captured on, so any path that rebinds a cache tensor (instead of
        writing it in place) calls this.  Today only ``_init_cache`` does:
        the prefix pool's restore and the copy-on-write write in place."""
        self._graphs.clear()
        self._eager_rounds.clear()

    # the program-name prefix the ledger records this layout's entry
    # points under (JAX's names)
    _PROGRAM = "kv"

    def _observed(self, name: str, signature=()):
        """The ledger's record of the first call of entry point ``name``
        per ``signature`` (a null context without a ledger)."""
        if self._ledger is None:
            return contextlib.nullcontext()
        return self._ledger.first_call(f"{self._PROGRAM}_{name}",
                                       signature, self.device)

    def _layer_cache(self, lead: tuple, names: tuple, kv_heads: int) -> dict:
        """One layer's zero KV leaves: (*lead, KVH, D) payload at the
        storage dtype and, under int8, (*lead, KVH) f32 scales, KVH the
        layer's K/V heads on this rank (each leaf allocated whole: a
        rank's pool is contiguous, as the paged kernel needs)."""
        m = self.model
        shape = (*lead, kv_heads, m.head_dim)
        out = {n: torch.zeros(shape, dtype=self._store, device=self.device)
               for n in names[:2]}
        if self._store == torch.int8:
            out.update({n: torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=self.device)
                        for n in names[2:]})
        return out

    def _init_cache(self) -> list[dict]:
        # one scratch column past max_len (module docstring)
        self._drop_graphs()
        return [self._layer_cache((self.slots, self.max_len + 1),
                                  ("cached_key", "cached_value",
                                   "key_scale", "value_scale"), kvh)
                for kvh in self._kv_heads]

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
        self._reset_multi_slot(slot)
        return prompt, lp, slot

    def _reset_multi_slot(self, slot: int) -> None:
        """Clear a slot's multi-step state at claim and evict: no EOS,
        unlimited budget, not halted.  ``_inflight`` is left as it is: it
        balances dispatch against drain, and a slot reclaimed while a
        round is out must keep its pending decrement."""
        self.eos_tok[slot] = -1
        self.budget[slot] = 0
        self.halted[slot] = False

    def set_decode_limits(self, slot: int, eos: int | None,
                          budget: int) -> None:
        """Arm in-device deactivation for ``slot``: the fused round stops
        advancing it once it emits ``eos`` (None = never) or has emitted
        ``budget`` more tokens (0 = unlimited).  Host bookkeeping; the
        vectors ride the next dispatch."""
        if budget < 0:
            raise ValueError(f"budget must be >= 0, got {budget}")
        self.eos_tok[slot] = -1 if eos is None else int(eos)
        self.budget[slot] = int(budget)
        self.halted[slot] = False

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
        with self._observed(f"prefill_chunk_l{n}", n):
            if getattr(self.model, "moe_experts", 0):
                # one token at a time, as JAX's prefill scan: a MoE block
                # routes the tokens of one forward together, against one
                # capacity, so a many-token forward would drop others
                for j in range(filled, filled + n):
                    logits = self._prefill_forward(
                        slot, pend["prompt"][None, j:j + 1],
                        np.full((1, 1), j, dtype=np.int32))
            else:
                logits = self._prefill_forward(
                    slot, pend["prompt"][None, filled:filled + n],
                    np.arange(filled, filled + n, dtype=np.int32)[None, :])
            # materialized before host state flips: a device error
            # surfaces while the slot is still pending
            first = int(self._sample(logits[:, -1])[0])
        self._phase_s["prefill_s"] += time.perf_counter() - t0
        self.dispatch_count += 1
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
        if self._multi_pending:
            raise RuntimeError(
                "a fused multi-step round is in flight — drain it before "
                "a single-step advance (host mirrors lag the device)")
        for slot in np.flatnonzero(mask):
            pos = int(self.lengths[slot])
            self._ensure_writable(int(slot), pos, pos + 1)
        return self._decode_forward(mask)[:, -1]

    def advance(self, only=None) -> np.ndarray:
        """One decode iteration: every ACTIVE slot (or the ``only`` subset)
        consumes its last token and emits the next one; lengths advance by
        one.  Returns the (slots,) token vector — rows that did not take
        part carry their stale token.  The step's tokens and lengths stay
        on the device as the next step's inputs (``_dev_learn``), so an
        uninterrupted decode loop uploads nothing."""
        mask = self.active if only is None else np.asarray(only, np.bool_)
        t0 = time.perf_counter()
        with self._observed("decode_step"):
            logits = self.decode_logits(mask)
            d_nxt = self._sample(logits)
            nxt = d_nxt.cpu().numpy().astype(np.int32)
        self._phase_s["decode_s"] += time.perf_counter() - t0
        self.dispatch_count += 1
        d_mask = self._dev_cached("mask", mask)
        d_tok = self._dev_cached("tokens", self.tokens)
        d_len = self._dev_cached("lengths", self.lengths)
        nxt = np.where(mask, nxt, self.tokens)
        self.lengths[mask] += 1
        self.tokens = nxt
        self._dev_learn("tokens", self.tokens,
                        torch.where(d_mask, d_nxt, d_tok))
        self._dev_learn("lengths", self.lengths,
                        torch.where(d_mask, d_len + 1, d_len))
        return nxt

    # ------------------------------------------------- device slot vectors
    _DEV_DTYPES = {"tokens": np.int64, "lengths": np.int32,
                   "mask": np.bool_, "bt": np.int32, "h_tok": np.int64,
                   "h_len": np.int32, "h_act": np.bool_, "h_bud": np.int32,
                   "edited": np.bool_, "eos": np.int64}

    def _upload(self, host: np.ndarray, out: torch.Tensor | None = None
                ) -> torch.Tensor:
        """Host array → device tensor (into ``out`` when given).  On the
        card the copy goes through a pinned block of PyTorch's caching
        host allocator and does not wait: the allocator keeps the block
        until the copy has run."""
        src = torch.from_numpy(np.ascontiguousarray(host))
        if out is None:
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        if self.device.type == "cuda":
            out.copy_(src.pin_memory(), non_blocking=True)
        else:
            out.copy_(src)
        return out

    def _dev_cached(self, name: str, host) -> torch.Tensor:
        """The static device buffer of a host slot vector (JAX
        ``_dev_cached``): written from the host only when the host value
        differs from the one the buffer holds.  A buffer keeps its address
        for the table's life, so a captured round reads it; every write
        to it is ordered on the stream after the work issued before."""
        host = np.asarray(host, self._DEV_DTYPES[name])
        hit = self._dev_vecs.get(name)
        if hit is not None and np.array_equal(hit[0], host):
            return hit[1]
        buf = self._upload(host, None if hit is None else hit[1])
        self._dev_vecs[name] = (host.copy(), buf)
        return buf

    def _dev_learn(self, name: str, host, dev: torch.Tensor) -> None:
        """Adopt a device result as the buffer's value (JAX
        ``_dev_learn``): the caller set the host mirror to the same value,
        so the next ``_dev_cached`` of it uploads nothing."""
        host = np.asarray(host, self._DEV_DTYPES[name])
        buf = self._dev_vecs[name][1]
        buf.copy_(dev)
        self._dev_vecs[name] = (host.copy(), buf)

    # ------------------------------------------------- multi-step decode
    def _round_body(self, k: int) -> None:
        """One fused round of ``k`` decode steps on the static buffers
        (JAX ``_multi``): the prologue selects the host edits over the
        device carry per slot, then each step writes K/V at each slot's
        length, samples, and takes a slot out of the carried mask once it
        emits its EOS, spends its budget or reaches ``max_len``.  Writes
        the ``(3, k, slots)`` int32 stack of tokens, active-at-entry and
        done flags into ``_round_out[k]`` and the carry back into its
        buffers.  This is what ``RoundGraph`` captures."""
        vec, carry = self._dev_vecs, self._carry
        edited = vec["edited"][1]
        tokens = torch.where(edited, vec["h_tok"][1], carry["tokens"])
        lengths = torch.where(edited, vec["h_len"][1], carry["lengths"])
        active = torch.where(edited, vec["h_act"][1], carry["active"])
        budget = torch.where(edited, vec["h_bud"][1], carry["budget"])
        eos = vec["eos"][1]
        # the paged table's snapshot, staged by ``_multi_prepare``
        bt = vec["bt"][1] if "bt" in vec else None
        rows = []
        for _ in range(k):
            logits = self._step_forward(tokens[:, None], lengths[:, None],
                                        bt)[:, -1]
            nxt = torch.where(active, self._sample(logits), tokens)
            nlen = torch.where(active, lengths + 1, lengths)
            armed = budget > 0
            nbud = torch.where(active & armed, budget - 1, budget)
            done = active & ((nxt == eos) | (armed & (nbud <= 0))
                             | (nlen >= self.max_len))
            rows.append(torch.stack([nxt.int(), active.int(), done.int()]))
            tokens, lengths, active, budget = (nxt, nlen, active & ~done,
                                               nbud)
        self._round_out[k].copy_(torch.stack(rows, dim=1))
        for name, val in (("tokens", tokens), ("lengths", lengths),
                          ("active", active), ("budget", budget)):
            carry[name].copy_(val)

    def _run_round(self, k: int) -> None:
        """Issue ``_round_body(k)``: eagerly on the CPU and for a TP table
        (``eager_rounds``: its round holds NCCL calls); otherwise, on the
        card, a ``k``'s first round runs eagerly on a side stream (it
        creates what a capture must find: library handles, workspaces),
        the second is captured and replayed, every later one replays.  A
        capture that fails raises; there is no eager fallback."""
        if k not in self._round_out:
            self._round_out[k] = torch.zeros((3, k, self.slots),
                                             dtype=torch.int32,
                                             device=self.device)
        if self.device.type != "cuda" or self.eager_rounds:
            self._round_body(k)
            return
        graph = self._graphs.get(k)
        if graph is None:
            if k not in self._eager_rounds:
                self._eager_rounds.add(k)
                here = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(here)
                with torch.cuda.stream(side):
                    self._round_body(k)
                here.wait_stream(side)
                return
            graph = self._graphs[k] = RoundGraph(self, k)
        graph.replay(self)

    def prepare_round(self, k: int) -> None:
        """Make ``k``'s fused round ready to replay before serving: on the
        card, unless the table's rounds run eagerly, run its eager round
        and its capture now, on an idle table (rows that take part in no
        step write only where nothing reads), so that serving replays
        and never captures (``serving.fleet.ReplicaSet`` does this for
        every replica before its threads start).  A no-op on the CPU and
        once ``k`` is captured."""
        if (self.device.type != "cuda" or self.eager_rounds
                or k in self._graphs):
            return
        if (self.active.any() or self.reserved.any()
                or self._multi_pending):
            raise RuntimeError("prepare_round needs an idle table (no "
                               "live, reserved or in-flight slot)")
        while k not in self._graphs:
            self.dispatch_multi(k)
            self.drain_multi()

    def _multi_prepare(self, mask: np.ndarray, k: int) -> None:
        """Layout hook before a fused dispatch (the paged table covers
        in-flight growth and stages its block table)."""

    def dispatch_multi(self, k: int) -> dict:
        """Issue one fused round of ``k`` decode steps without waiting for
        it (JAX ``dispatch_multi``).  Slots the device already deactivated
        (``halted``) are left out; host edits since the last dispatch
        ride as ``edited``-selected uploads.  The round's stacks start
        their copy to a pinned host buffer behind the round's own event,
        enqueued before any later round can overwrite them.  Rounds drain
        in dispatch order."""
        if k < 1:
            raise ValueError(f"multi-step k must be >= 1, got {k}")
        mask = self.active & ~self.halted
        self._multi_prepare(mask, k)
        self._inflight[mask] += k
        h_tok = self.tokens.astype(np.int32)
        h_len = self.lengths.astype(np.int32)
        h_act = mask.astype(np.bool_)
        h_bud = self.budget.astype(np.int32)
        snap = self._multi_snap
        if snap is None:
            edited = np.ones(self.slots, np.bool_)
        else:
            # host diverged from the host view at the last dispatch; drain
            # applies each round's deltas to both, so only scheduler edits
            # show
            edited = ((h_tok != snap["tokens"]) | (h_len != snap["lengths"])
                      | (h_act != snap["mask"]) | (h_bud != snap["budget"]))
        t0 = time.perf_counter()
        for name, host in (("h_tok", h_tok), ("h_len", h_len),
                           ("h_act", h_act), ("h_bud", h_bud),
                           ("edited", edited), ("eos", self.eos_tok)):
            self._dev_cached(name, host)
        self._run_round(k)
        self.dispatch_count += 1
        out = self._round_out[k]
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = out.clone(), None
        self._phase_s["decode_s"] += time.perf_counter() - t0
        self._multi_snap = {"tokens": h_tok.copy(), "lengths": h_len.copy(),
                            "mask": h_act.copy(), "budget": h_bud.copy()}
        handle = {"k": int(k), "mask": h_act.copy(), "host": host,
                  "event": event}
        self._multi_pending.append(handle)
        return handle

    def drain_multi(self, handle: dict | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Wait for the oldest round and fold its deltas into the host
        mirrors (JAX ``drain_multi``): lengths advance by each slot's
        emitted count, ``tokens`` takes the last emission, spent budgets
        shrink, deactivated slots set ``halted``; the same deltas land on
        the dispatch snapshot.  Returns ``(toks, acts)``, (k, slots)
        stacks of tokens and the active-at-entry mask per step (a
        contiguous True prefix per slot)."""
        if not self._multi_pending:
            raise RuntimeError("no fused round in flight")
        if handle is not None and handle is not self._multi_pending[0]:
            raise RuntimeError(
                "fused rounds drain in dispatch order — this handle is "
                "not the oldest outstanding round")
        handle = self._multi_pending.pop(0)
        k, mask = handle["k"], handle["mask"]
        t0 = time.perf_counter()
        if handle["event"] is not None:
            handle["event"].synchronize()
        stack = handle["host"].numpy().copy()
        self._phase_s["decode_s"] += time.perf_counter() - t0
        toks = stack[0]
        acts = stack[1].astype(np.bool_)
        dones = stack[2].astype(np.bool_)
        self._inflight[mask] -= k
        emitted = acts.sum(axis=0).astype(np.int32)
        sel = emitted > 0
        done_any = dones.any(axis=0)
        snap = self._multi_snap
        # a slot evicted and readmitted mid-flight was inactive on the
        # device for the whole round (the host's finish conditions are
        # the device's stop conditions), so ``sel`` covers only slots
        # whose host state still describes this round's stream
        self.lengths[sel] += emitted[sel]
        snap["lengths"][sel] += emitted[sel]
        last = toks[np.maximum(emitted - 1, 0), np.arange(self.slots)]
        self.tokens[sel] = last[sel]
        snap["tokens"][sel] = last[sel]
        bsel = sel & (self.budget > 0)
        self.budget[bsel] -= emitted[bsel]
        snap["budget"][bsel] -= emitted[bsel]
        self.halted |= done_any
        snap["mask"] &= ~done_any
        return toks, acts

    def advance_multi(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """``dispatch_multi`` + ``drain_multi`` back to back: one fused
        round, waited for (the draft's proposal loop uses this)."""
        self.dispatch_multi(k)
        return self.drain_multi()

    @property
    def pending_multi(self) -> int:
        """Outstanding (dispatched, undrained) fused rounds."""
        return len(self._multi_pending)

    def abandon_multi(self) -> None:
        """Drop every outstanding round without folding its tokens into
        the host mirrors (the batcher's failure cleanup): ``_inflight`` is
        rebalanced and the device carry forgotten, so the next dispatch
        uploads from the host mirrors."""
        for handle in self._multi_pending:
            self._inflight[handle["mask"]] -= handle["k"]
        self._multi_pending.clear()
        self._multi_snap = None

    # ------------------------------------------------- speculative decode
    def _check_verify(self, block) -> np.ndarray:
        if not self.greedy:
            raise ValueError(
                "verify_block requires greedy sampling: the exact "
                "acceptance rule (accept while draft == target argmax) "
                "only exists for greedy decode")
        block = np.asarray(block, np.int32)
        if block.ndim != 2 or block.shape[0] != self.slots:
            raise ValueError(
                f"block must be (slots, width) = ({self.slots}, k+1), "
                f"got {block.shape}")
        width = int(block.shape[1])
        live = self.lengths[self.active]
        if live.size and int(live.max()) + width > self.max_len:
            raise SlotOverflow(
                f"verify width {width} at length {int(live.max())} would "
                f"write past max_len={self.max_len}; the scheduler must "
                f"cap the draft k by remaining slot capacity")
        if self._multi_pending:
            raise RuntimeError(
                "a fused multi-step round is in flight — drain it before "
                "a verify (host mirrors lag the device)")
        return block

    def verify_logits(self, block) -> torch.Tensor:
        """The verify forward without the argmax: (slots, width, vocab)
        f32 logits on the device (``verify_block``)."""
        block = self._check_verify(block)
        width = int(block.shape[1])
        for slot in np.flatnonzero(self.active):
            pos = int(self.lengths[slot])
            self._ensure_writable(int(slot), pos, pos + width)
        d_len = self._dev_cached("lengths", self.lengths)
        positions = d_len[:, None] + torch.arange(
            width, dtype=torch.int32, device=self.device)[None, :]
        # by query column: each column is bitwise the decode step at its
        # prefix (models/gpt.py, ``by_column``)
        return self._step_forward(self._upload(block.astype(np.int64)),
                                  positions, self._decode_bt(self.active),
                                  by_column=True)

    def verify_block(self, block) -> np.ndarray:
        """Score a (slots, width) token block in one forward and return
        the (slots, width) greedy argmaxes (JAX ``verify_block``).  Per
        slot ``block[s] = [pending, d_1, .., d_{width-1}]`` enters at
        positions ``length .. length+width-1``, each query masked to the
        positions up to its own; ``g[s, j]`` is the target's token after
        ``block[s, :j+1]``.  Host lengths and tokens are not touched: the
        scheduler commits, and rejected positions are invalidated by
        length bookkeeping alone.  Greedy only."""
        t0 = time.perf_counter()
        with self._observed(f"verify_w{np.shape(block)[1]}",
                            np.shape(block)[1]):
            g = self.verify_logits(block).argmax(-1).cpu().numpy()
        self._phase_s["decode_s"] += time.perf_counter() - t0
        self.dispatch_count += 1
        return g.astype(np.int32)

    def commit_block(self, slot: int, n: int, last_token: int) -> None:
        """Commit ``n`` verified positions of the last ``verify_block``
        into ``slot``: its length advances by ``n`` and ``last_token`` (the
        target's own token at the acceptance point) becomes its pending
        token.  The rejected tail stays in the table, past the length."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        if n < 1:
            raise ValueError(f"commit_block needs n >= 1, got {n}")
        if int(self.lengths[slot]) + n > self.max_len:
            raise SlotOverflow(
                f"committing {n} positions at length "
                f"{int(self.lengths[slot])} exceeds max_len={self.max_len}")
        self.lengths[slot] += n
        self.tokens[slot] = int(last_token)

    def rewind(self, slot: int, length: int, token: int) -> None:
        """Set a slot's length back to ``length`` and its pending token
        (the draft table's resync after a verify round): positions past
        ``length`` were speculative writes.  A rewind never extends
        validity, and clears ``halted``."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        if length > int(self.lengths[slot]):
            raise ValueError(
                f"rewind cannot extend validity: slot {slot} is at "
                f"{int(self.lengths[slot])}, asked for {length}")
        self.lengths[slot] = int(length)
        self.tokens[slot] = int(token)
        self.halted[slot] = False

    def evict(self, slot: int) -> None:
        """Free a slot.  Monolithic: host bookkeeping only — stale K/V is
        unreachable (validity is length-driven) and the next prefill
        overwrites it."""
        if not self.active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        self.active[slot] = False
        self.lengths[slot] = 0
        self.tokens[slot] = 0
        self._reset_multi_slot(slot)

    def phase_times(self) -> dict[str, float]:
        """Cumulative host-observed seconds in prefill and decode forwards
        (each ends in a device→host read of its sampled tokens, so device
        time is included)."""
        return dict(self._phase_s)

    # ------------------------------------------------------------ forwards
    def _forward(self, tokens: np.ndarray, positions: np.ndarray, kv,
                 **kw) -> torch.Tensor:
        """One model forward over (B, L) host tokens at (B, L) positions,
        writing ``kv`` in place; returns the logits."""
        with torch.no_grad():
            return self.model(self._upload(tokens.astype(np.int64)),
                              positions=self._upload(
                                  positions.astype(np.int32)),
                              pools=kv, **kw)

    def _step_forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                      bt, by_column: bool = False) -> torch.Tensor:
        """A decode or verify forward of every slot over (slots, L) device
        tokens at (slots, L) int32 positions (``bt``: the paged table's
        masked block tables, None for the monolithic table; ``by_column``:
        the model's verify mode)."""
        kw = ({} if bt is None
              else dict(block_tables=bt, paged_fused=self.paged_fused))
        with torch.no_grad():
            return self.model(tokens, positions=positions, pools=self.cache,
                              by_column=by_column, **kw)

    def _decode_bt(self, mask):
        """The block tables of a forward of ``mask`` (None: monolithic)."""
        return None

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
        """One decode step's forward over the device slot vectors."""
        return self._step_forward(
            self._dev_cached("tokens", self.tokens)[:, None],
            self._dev_cached("lengths", self.lengths)[:, None],
            self._decode_bt(mask))

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

    def _drop_pool(self) -> None:
        """Empty the prefix pool (its accounting stays)."""
        self._prefix_pool.clear()

    def reset_prefix_cache(self) -> None:
        """Drop pooled blocks and zero the accounting."""
        self._drop_pool()
        for k in self.prefix_stats:
            self.prefix_stats[k] = 0

    # --------------------------------------------------------- accounting
    def _leaf_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for layer in self.cache for t in layer.values())

    def kv_bytes_per_slot(self) -> int:
        """Stored KV-table bytes per slot: every leaf (K/V and, under
        int8, the f32 scales) over the slot count, the scratch column
        left out."""
        return (self._leaf_bytes() * self.max_len // (self.max_len + 1)
                // self.slots)

    def timeline_gauges(self) -> dict[str, float]:
        """Host gauge snapshot for the timeline sampler (JAX's keys): sums
        over the host numpy slot table and pool lengths, no device read
        (the leaves give only their sizes).  ``kv_live_bytes`` is tokens
        actually valid × stored bytes per token (K/V and, under int8, the
        scales; the scratch column left out)."""
        per_tok = getattr(self, "_tl_token_bytes", None)
        if per_tok is None:
            per_tok = self._tl_token_bytes = self._leaf_bytes() / (
                self.slots * (self.max_len + 1))
        live_tokens = int(self.lengths.sum())
        return {
            "kv_active_slots": int(self.active.sum()),
            "kv_reserved_slots": int(self.reserved.sum()),
            "kv_live_tokens": live_tokens,
            "kv_live_bytes": live_tokens * per_tok,
            "kv_prefix_pool_blocks": len(self._prefix_pool),
        }


class PagedSlotKVCache(SlotKVCache):
    """Paged KV layout: one physical block pool per layer shared by every
    slot + host-owned per-slot block tables (module docstring).
    ``paged_block`` (default ``prefix_block``) must divide ``max_len`` and
    equal ``prefix_block`` when the prefix pool is on: a hit aliases pool
    blocks by id."""

    _PROGRAM = "kv_paged"

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

    def _init_cache(self) -> list[dict]:
        self._drop_graphs()
        return [self._layer_cache((self.num_blocks + 1, self.paged_block),
                                  ("key_pool", "value_pool",
                                   "key_scale_pool", "value_scale_pool"),
                                  kvh)
                for kvh in self._kv_heads]

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
        wholly to scratch, in one static buffer (``_dev_cached``: an
        unchanged table is not uploaded again)."""
        bt = np.where(np.asarray(mask, np.bool_)[:, None],
                      self.block_tables_np, np.int32(self._scratch))
        return self._dev_cached("bt", bt)

    _decode_bt = _masked_bt

    def _multi_prepare(self, mask: np.ndarray, k: int) -> None:
        """Cover every masked slot's growth in flight — undrained rounds
        (``_inflight``) plus this round's ``k`` — so that no fused write
        lands outside the slot's own blocks, then stage the masked block
        table (JAX ``kv_cache.py:2040-2050``).  A slot the device stops
        mid-round keeps writing at its frozen length: into its own
        covered block, or past the snapshot's coverage into scratch."""
        for slot in np.flatnonzero(mask):
            start = int(self.lengths[slot])
            end = min(start + int(self._inflight[slot]) + k, self.max_len)
            self._ensure_writable(int(slot), start, end)
        self._masked_bt(mask)

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
        bt_row = self._upload(self.block_tables_np[slot:slot + 1])
        return self._forward(tokens, positions, self.cache,
                             block_tables=bt_row, paged_fused=False)

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

    def _drop_pool(self) -> None:
        """Release the pool's pins and empty it."""
        while self._prefix_pool:
            _, bid = self._prefix_pool.popitem(last=False)
            self._release_block(bid)

    def reset_prefix_cache(self) -> None:
        """Release the pool's pins and zero the pool and zero-copy/CoW
        accounting."""
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

    def timeline_gauges(self) -> dict[str, float]:
        """Paged gauge snapshot (JAX's keys): the base slot-table gauges
        plus pool occupancy and refcounts, all host numpy.
        ``kv_live_bytes`` is allocated blocks × stored bytes per block
        (aliased blocks counted once; int8 scales included)."""
        per_block = getattr(self, "_tl_block_bytes", None)
        if per_block is None:
            per_block = self._tl_block_bytes = (
                self._leaf_bytes() // (self.num_blocks + 1))
        live_tokens = int(self.lengths.sum())
        return {
            "kv_active_slots": int(self.active.sum()),
            "kv_reserved_slots": int(self.reserved.sum()),
            "kv_live_tokens": live_tokens,
            "kv_live_bytes": self.blocks_in_use * per_block,
            "kv_prefix_pool_blocks": len(self._prefix_pool),
            "kv_blocks_in_use": self.blocks_in_use,
            "kv_pool_refcount_total": int(self._block_refs.sum()),
            "kv_free_blocks": len(self._free_list),
        }

    def paged_stats(self) -> dict:
        """Pool utilization + the zero-copy/CoW ledger (cumulative)."""
        return {"num_blocks": self.num_blocks,
                "block": self.paged_block,
                "blocks_in_use": self.blocks_in_use,
                "utilization": self.blocks_in_use / self.num_blocks,
                **dict(self._paged_counters)}
