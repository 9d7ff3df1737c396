"""Continuous-batching inference serving (port of
``distributed_tensorflow_tpu.serving``).

* ``kv_cache.SlotKVCache`` — the device half.  ``kv_layout="paged"``
  builds ``PagedSlotKVCache``: a refcounted physical block pool with
  per-slot block tables; prefill reads it by gather, decode through the
  Hopper kernel of ``ops.paged_attention``.
* ``scheduler.ContinuousBatcher`` — the host half: iteration-level
  admission/eviction, chunked prefill, TTFT/ITL percentile accounting.

The fleet (``fleet.ReplicaSet``) is not ported yet (ROADMAP Queue 1).
"""

from distributed_tensorflow_tpu_torch.serving.kv_cache import (  # noqa: F401
    BlockPoolExhausted, PagedSlotKVCache, SlotKVCache, SlotOverflow)
from distributed_tensorflow_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatcher, Request, RequestQueue, RequestResult, VirtualClock,
    WallClock)
