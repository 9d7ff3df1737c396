"""Step engines (port of ``distributed_tensorflow_tpu.engines``).

Ported: ``sync`` (``SyncEngine``: one device, or one rank of a
``torch.distributed`` group), ``allreduce`` (the same engine, driven
through the Keras-fit-like ``Trainer``), ``async`` (``AsyncLocalEngine``:
local SGD with a parameter mean every ``sync_every`` steps) and ``gossip``
(``GossipEngine``: a ring mix of degree ``degree``), and
``SeqParallelEngine`` (data × sequence parallelism over a (data, seq)
mesh) and ``ExpertParallelEngine`` (data × expert parallelism of MoE
models over a (data, expert) mesh), both outside the ``ENGINES`` table as
in JAX.  ``fsdp`` raises
``NotImplementedError`` naming its ROADMAP Queue 1 item.
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch import not_ported
from distributed_tensorflow_tpu_torch.engines.allreduce import (  # noqa: F401
    Trainer)
from distributed_tensorflow_tpu_torch.engines.async_local import (  # noqa: F401
    AsyncLocalEngine)
from distributed_tensorflow_tpu_torch.engines.base import (  # noqa: F401
    Engine, TrainState)
from distributed_tensorflow_tpu_torch.engines.expert_parallel import (  # noqa: F401,E501
    ExpertParallelEngine)
from distributed_tensorflow_tpu_torch.engines.gossip import (  # noqa: F401
    GossipEngine)
from distributed_tensorflow_tpu_torch.engines.seq_parallel import (  # noqa: F401
    SeqParallelEngine)
from distributed_tensorflow_tpu_torch.engines.sync import (  # noqa: F401
    SyncEngine)

ENGINES = {"sync": SyncEngine, "allreduce": SyncEngine,
           "async": AsyncLocalEngine, "gossip": GossipEngine}
_LATER = {"fsdp": "remaining engines"}


def check_engine(name: str) -> None:
    """Raise unless ``name`` is a ported engine: ``NotImplementedError``
    naming its ROADMAP item for the JAX registry's others, ``KeyError``
    for an unknown name."""
    if name in _LATER:
        not_ported(f"engine '{name}'", _LATER[name])
    if name not in ENGINES:
        raise KeyError(f"unknown engine '{name}'; known: "
                       f"{sorted(ENGINES) + sorted(_LATER)}")


def create_engine(name: str, *args, **kw):
    check_engine(name)
    return ENGINES[name](*args, **kw)
