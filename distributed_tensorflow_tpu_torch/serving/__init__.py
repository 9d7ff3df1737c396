"""Continuous-batching inference serving (port of
``distributed_tensorflow_tpu.serving``).

* ``kv_cache.SlotKVCache`` — the device half.  The default layout is
  monolithic (one K/V row per slot, dense masked read);
  ``kv_layout="paged"`` builds ``PagedSlotKVCache``: a refcounted physical
  block pool with per-slot block tables; prefill reads it by gather,
  decode through the Hopper kernel of ``ops.paged_attention``.  Both take
  a prefix pool (``prefix_cache_blocks``), ``kv_dtype="int8"`` and
  temperature sampling (``greedy=False``).
* ``scheduler.ContinuousBatcher`` — the host half: iteration-level
  admission/eviction, chunked prefill, TTFT/ITL percentile accounting.

* ``fleet.ReplicaSet`` — N replicas behind a journaled least-loaded
  router: failover with bounded retry, seeded fault injection
  (``FaultInjector``), the stall watchdog and the weight hot swap
  (``SlotKVCache.swap_params``).  Disaggregation, affinity routing and
  autoscale are not ported yet (ROADMAP Queue 1, item 10b).
"""

from distributed_tensorflow_tpu_torch.serving.kv_cache import (  # noqa: F401
    BlockPoolExhausted, PagedSlotKVCache, SlotKVCache, SlotOverflow)
from distributed_tensorflow_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatcher, Request, RequestQueue, RequestResult, VirtualClock,
    WallClock)
from distributed_tensorflow_tpu_torch.serving.fleet import (  # noqa: F401
    CorruptionDetected, FaultInjector, FaultSpec, InjectedFault, ReplicaSet,
    RequestJournal, build_replica_kvs)
