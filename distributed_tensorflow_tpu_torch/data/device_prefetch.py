"""Host→device prefetch over any host batch iterator (port of
``data/device_prefetch.py``).

``iter_batches`` produces host numpy batches; this wrapper keeps a small
buffer of batches already placed on the device (by the engine's
``shard_batch``), so the copy of batch N+1 overlaps the compute of batch N.

On the card the placement runs on a side stream: ``shard_batch`` copies
from pinned host memory with ``non_blocking=True`` (a non-blocking copy
from pageable numpy memory would be synchronous), an event marks the end
of each batch's copies, and the consumer's stream waits on that event and
``record_stream``s the batch's tensors before it uses them, so the caching
allocator does not hand their memory to another stream too early.  On the
CPU the class is the same bounded queue with no stream.

The wrapped iterable MAY expose ``close()`` (generators do); the
prefetcher reads ahead of its consumer, so a consumer that stops early
must ``close()`` it, which closes the source.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Iterable, Iterator

import torch


def _tensors(batch):
    return batch if isinstance(batch, (tuple, list)) else (batch,)


class DevicePrefetch:
    """Iterator of device-placed batches with a bounded read-ahead buffer.

    ``place`` maps one host batch to its device form (typically
    ``engine.shard_batch``); placement is issued for up to ``depth``
    batches beyond the one the consumer holds.  ``device`` (a CUDA device)
    puts the placement on a side stream; ``None`` or a CPU device places
    on the caller's thread and stream.

    Gauges, read by the Trainer at chunk boundaries:

    * ``fill_wait_s``: consumer-path seconds inside the refill, waiting on
      host batch production (and, on the card, on issuing the copies);
    * ``starvation``: hand-offs that left zero batches staged ahead (with
      ``depth == 1`` every hand-off; with ``depth >= 2`` only source
      exhaustion);
    * ``queue_depth``: batches staged ahead of the consumer.
    """

    def __init__(self, batches: Iterable, place: Callable, depth: int = 2,
                 device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source: Iterator | None = iter(batches)
        self._place = place
        self._depth = depth
        self._stream = (torch.cuda.Stream(device)
                        if device is not None
                        and torch.device(device).type == "cuda" else None)
        self._buf: collections.deque = collections.deque()
        self.starvation = 0
        self.fill_wait_s = 0.0
        self.consumed = 0
        self._fill()  # constructor prefill is not consumer wait time
        self.fill_wait_s = 0.0

    def _stage(self, host):
        if self._stream is None:
            return self._place(host), None
        # the side stream's copies need not wait for the consumer: their
        # outputs are fresh blocks of the side stream's pool, and a block
        # comes back to it only after the consumer's recorded use ends
        with torch.cuda.stream(self._stream):
            out = self._place(host)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _fill(self) -> None:
        t0 = time.perf_counter()
        while self._source is not None and len(self._buf) < self._depth:
            try:
                host = next(self._source)
            except StopIteration:
                self._release_source()
                break
            self._buf.append(self._stage(host))
        self.fill_wait_s += time.perf_counter() - t0

    def __iter__(self) -> "DevicePrefetch":
        return self

    def __next__(self):
        if not self._buf:
            self._fill()
        if not self._buf:
            raise StopIteration
        out, ready = self._buf.popleft()
        if ready is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(ready)
            for t in _tensors(out):
                t.record_stream(consumer)
        self.consumed += 1
        if not self._buf and self._source is not None:
            # nothing staged ahead of the batch just handed out
            self.starvation += 1
        # issue the replacement copy BEFORE handing the batch over: the
        # device computes on `out` while this one stages
        self._fill()
        return out

    @property
    def queue_depth(self) -> int:
        """Batches currently staged on the device ahead of the consumer."""
        return len(self._buf)

    @property
    def depth(self) -> int:
        """Configured read-ahead bound (the --prefetch knob)."""
        return self._depth

    def stats(self) -> dict:
        return {"depth": self._depth, "queue_depth": len(self._buf),
                "starvation": self.starvation,
                "fill_wait_s": self.fill_wait_s,
                "consumed": self.consumed}

    def take(self, n: int) -> list:
        """Up to ``n`` next batches (fewer at exhaustion, [] when done) —
        the chunk-assembly call of the Trainer's multi-step drain."""
        out: list = []
        while n > 0 and len(out) < n:
            try:
                out.append(next(self))
            except StopIteration:
                break
        return out

    def _release_source(self) -> None:
        src, self._source = self._source, None
        if src is not None:
            close = getattr(src, "close", None)
            if close is not None:
                close()

    def close(self) -> None:
        """Drop buffered batches and close the source iterator."""
        self._buf.clear()
        self._release_source()

    def __del__(self):  # pragma: no cover - GC-timing safety net
        try:
            self.close()
        except Exception:
            pass

