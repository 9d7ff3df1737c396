"""Step engines (port of ``distributed_tensorflow_tpu.engines``).

Ported: ``sync`` (``SyncEngine`` on one device) and ``allreduce`` (the same
engine, driven through the Keras-fit-like ``Trainer``).  The other engines
of the JAX registry raise ``NotImplementedError`` naming their ROADMAP
Queue 1 item.
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch import not_ported
from distributed_tensorflow_tpu_torch.engines.allreduce import (  # noqa: F401
    Trainer)
from distributed_tensorflow_tpu_torch.engines.base import (  # noqa: F401
    Engine, TrainState)
from distributed_tensorflow_tpu_torch.engines.sync import (  # noqa: F401
    SyncEngine)

ENGINES = {"sync": SyncEngine, "allreduce": SyncEngine}
_LATER = {"async": "remaining engines", "gossip": "remaining engines",
          "fsdp": "remaining engines"}


def create_engine(name: str, *args, **kw):
    if name in _LATER:
        not_ported(f"engine '{name}'", _LATER[name])
    if name not in ENGINES:
        raise KeyError(f"unknown engine '{name}'; known: "
                       f"{sorted(ENGINES) + sorted(_LATER)}")
    return ENGINES[name](*args, **kw)
