"""Elastic training (port of ``distributed_tensorflow_tpu.elastic``):
a run as a resumable object.

Ported so far:

* **Exactly-once data resume** (``data_state.py``, a copy of the JAX
  module): the batch iterator's (epoch, offset, seed) position rides each
  checkpoint as the elastic sidecar; resume continues the identical batch
  sequence, prefetch read-ahead discounted.
* **Elastic restore** (``reshard.py``): ``elastic_restore`` of a
  checkpoint onto this run's ranks, policy-aware, with the sidecar, and
  ``preemption_lost_s``.

The graceful lease drain (``lease.py``), the straggler detector and the
restore of a per-rank engine (local SGD, gossip) onto another rank count
are later work (ROADMAP Queue 1).
"""

from distributed_tensorflow_tpu_torch.elastic.data_state import (  # noqa: F401
    DATA_STATE_VERSION, DataState, ResumableBatches, consumer_state)
from distributed_tensorflow_tpu_torch.elastic.reshard import (  # noqa: F401
    ElasticRestoreError, elastic_restore, preemption_lost_s)

__all__ = [
    "DATA_STATE_VERSION",
    "DataState",
    "ResumableBatches",
    "consumer_state",
    "ElasticRestoreError",
    "elastic_restore",
    "preemption_lost_s",
]
