"""Elastic training (port of ``distributed_tensorflow_tpu.elastic``):
a run as a resumable object.

* **Exactly-once data resume** (``data_state.py``, a copy of the JAX
  module): the batch iterator's (epoch, offset, seed) position rides each
  checkpoint as the elastic sidecar; resume continues the identical batch
  sequence, prefetch read-ahead discounted.
* **Elastic restore** (``reshard.py``): ``elastic_restore`` of a
  checkpoint onto this run's ranks, policy-aware, with the sidecar, and
  ``preemption_lost_s``.
* **Graceful lease drain** (``lease.py``, a copy of the JAX module):
  ``--max-steps-per-lease`` and a SIGTERM handler finish the in-flight
  chunk, write a final checkpoint and end the run with a ``preempted``
  reason; under ``cli -n N`` the harness has the ranks agree on a
  signal's stop (``utils/harness.py``).
* **Straggler detection** (``stragglers.py``, a copy of the JAX module):
  step-time outliers against a running median as ``straggler`` trace
  events.

Like JAX's, the restore of a per-rank engine (local SGD, gossip) onto
another rank count is refused.
"""

from distributed_tensorflow_tpu_torch.elastic.data_state import (  # noqa: F401
    DATA_STATE_VERSION, DataState, ResumableBatches, consumer_state)
from distributed_tensorflow_tpu_torch.elastic.lease import (  # noqa: F401
    LeaseManager)
from distributed_tensorflow_tpu_torch.elastic.reshard import (  # noqa: F401
    ElasticRestoreError, elastic_restore, preemption_lost_s)
from distributed_tensorflow_tpu_torch.elastic.stragglers import (  # noqa: F401
    StragglerDetector)

__all__ = [
    "DATA_STATE_VERSION",
    "DataState",
    "ResumableBatches",
    "consumer_state",
    "LeaseManager",
    "ElasticRestoreError",
    "elastic_restore",
    "preemption_lost_s",
    "StragglerDetector",
]
