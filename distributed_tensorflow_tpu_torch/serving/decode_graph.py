"""The fused k-step decode round as one CUDA graph.

``SlotKVCache.dispatch_multi(k)`` runs ``k`` decode steps of the whole
slot table with token feedback and the stop conditions on the device (the
JAX package's ``lax.scan`` over the decode step, ``kv_cache.py:1017-…``).
Run eagerly, the round is bound by the host's dispatch of its kernels, as
the training chunk was (``engines/sync.py`` ``_ChunkGraph``); here it is
captured once per ``(table, k)`` and replayed.

``RoundGraph`` captures ``SlotKVCache._round_body(k)``: it reads the
table's static input buffers (the host edits, the EOS ids, the device
carry and, paged, the masked block table), writes the KV table in place,
the carry back into its buffers and the ``(3, k, slots)`` stack of tokens,
active and done flags into its output buffer.  Every address it touches
is the table's, so it replays for that table only.  The table's sampling
generator is registered with the graph, so that a replay advances its
Philox offset by what ``k`` eager steps draw.  A TP table's round holds
NCCL calls and is never captured: its ``eager_rounds`` runs it eagerly.
With the table's program ledger each capture is recorded there under
JAX's name of the round (``kv_decode_multi_k<k>``, paged
``kv_paged_decode_multi_k<k>``).

A capture sets the launch counters back by what it recorded, and a replay
adds it, under ``ops.COUNT_LOCK``.  The counts are exact only if no other
thread launches during a capture, so a serving fleet captures every
replica's rounds before its threads start (``SlotKVCache.prepare_round``,
``serving.fleet.ReplicaSet``): ``torch.cuda.graph`` also synchronizes the
device and empties the allocator's cache on entering, and all captures
share one capture stream.
"""

from __future__ import annotations

import contextlib

import torch

from distributed_tensorflow_tpu_torch.ops import COUNT_LOCK


def _launch_counters() -> list[tuple[object, str]]:
    """Every launch counter a decode step can move: (holder, attribute)."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as pa

    return [(pa.paged_attention, name)
            for name in sorted(vars(pa.paged_attention))
            if name.endswith("launches")]


class RoundGraph:
    """One table's fused round of ``k`` steps captured as a CUDA graph.
    The capture launches nothing, so the launch counters are put back
    after it and move by what it recorded at each replay.  ``captures``
    and ``replays`` count the class's graphs and their launches, in every
    table."""

    captures = 0
    replays = 0

    def __init__(self, kv, k: int):
        self.kv = kv
        self.k = int(k)
        self.graph = torch.cuda.CUDAGraph()
        if not kv.greedy:
            self.graph.register_generator_state(kv.generator)
        counters = _launch_counters()
        with COUNT_LOCK:
            before = [getattr(fn, name) for fn, name in counters]
        observed = (contextlib.nullcontext() if kv._ledger is None else
                    kv._ledger.observe(f"{kv._PROGRAM}_decode_multi_k{k}",
                                       kv.device))
        try:
            # thread-local: the capture forbids unsafe calls to this thread
            # only
            with observed, torch.cuda.graph(
                    self.graph, capture_error_mode="thread_local"):
                kv._round_body(self.k)
        finally:
            with COUNT_LOCK:
                self.counts = []
                for (fn, name), was in zip(counters, before):
                    self.counts.append((fn, name, getattr(fn, name) - was))
                    setattr(fn, name, was)
        with COUNT_LOCK:
            RoundGraph.captures += 1

    def replay(self, kv) -> None:
        if kv is not self.kv:
            raise ValueError("this decode round's CUDA graph was captured "
                             "for another slot table")
        self.graph.replay()
        with COUNT_LOCK:
            RoundGraph.replays += 1
            for fn, name, n in self.counts:
                setattr(fn, name, getattr(fn, name) + n)
