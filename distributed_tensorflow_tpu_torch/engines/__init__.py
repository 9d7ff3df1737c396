"""Step engines (port of ``distributed_tensorflow_tpu.engines``).

Every name of the JAX ``ENGINES`` table is ported: ``sync``
(``SyncEngine``: one device, or one rank of a ``torch.distributed``
group), ``allreduce`` (the same engine, driven through the Keras-fit-like
``Trainer``), ``async`` (``AsyncLocalEngine``: local SGD with a parameter
mean every ``sync_every`` steps), ``gossip`` (``GossipEngine``: a ring mix
of degree ``degree``) and ``fsdp`` (``FSDPEngine``: ZeRO-3 sharding over
'data', or fsdp × tp over a (data, model) mesh).  Outside the table, as
in JAX: ``SeqParallelEngine`` (data × sequence parallelism over a (data,
seq) mesh), ``ExpertParallelEngine`` (data × expert parallelism of MoE
models over a (data, expert) mesh), ``TensorParallelEngine`` (Megatron
data × model parallelism over a (data, model) mesh, with ``TPMLP``) and
``PipelineEngine`` (GPipe and 1F1B over a (data, pipe) mesh, with
'model', 'seq' and, for MoE stages under GPipe, 'expert' inside the
stages) and
``CompositeEngine`` (tp×sp, ep×sp and ep×tp×sp over a ('data', 'model',
'seq'[, 'expert']) mesh).
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.engines.allreduce import (  # noqa: F401
    Trainer)
from distributed_tensorflow_tpu_torch.engines.async_local import (  # noqa: F401
    AsyncLocalEngine)
from distributed_tensorflow_tpu_torch.engines.base import (  # noqa: F401
    Engine, TrainState)
from distributed_tensorflow_tpu_torch.engines.composite import (  # noqa: F401
    CompositeEngine)
from distributed_tensorflow_tpu_torch.engines.expert_parallel import (  # noqa: F401,E501
    ExpertParallelEngine)
from distributed_tensorflow_tpu_torch.engines.fsdp import (  # noqa: F401
    FSDPEngine)
from distributed_tensorflow_tpu_torch.engines.gossip import (  # noqa: F401
    GossipEngine)
from distributed_tensorflow_tpu_torch.engines.pipeline import (  # noqa: F401
    PipelineEngine)
from distributed_tensorflow_tpu_torch.engines.seq_parallel import (  # noqa: F401
    SeqParallelEngine)
from distributed_tensorflow_tpu_torch.engines.sync import (  # noqa: F401
    SyncEngine)
from distributed_tensorflow_tpu_torch.engines.tensor_parallel import (  # noqa: F401,E501
    TPMLP, TensorParallelEngine)

ENGINES = {"sync": SyncEngine, "allreduce": SyncEngine,
           "async": AsyncLocalEngine, "gossip": GossipEngine,
           "fsdp": FSDPEngine}


def check_engine(name: str) -> None:
    """Raise ``KeyError`` unless ``name`` is an engine of the table."""
    if name not in ENGINES:
        raise KeyError(f"unknown engine '{name}'; known: {sorted(ENGINES)}")


def create_engine(name: str, *args, **kw):
    check_engine(name)
    return ENGINES[name](*args, **kw)
