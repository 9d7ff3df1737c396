"""Tensor-parallel (Megatron) training over a (data, model) mesh (port of
``engines/tensor_parallel.py``).

JAX annotates the parameters with ``with_partitioning`` and lets GSPMD
insert the collectives.  Here every rank is one process of a row-major
``(data, model)`` mesh (``parallel/mesh.py``) and the collectives are
explicit: the engine binds its mesh to the model
(``models.layers.bind_model_mesh``), whose partitioned layers keep this
rank's slice of each annotated parameter and run the Megatron conjugate
pair (``parallel.collectives.copy_to_model`` before a column-parallel
layer, ``reduce_from_model`` after a row-parallel one).  Unannotated
parameters are whole on every rank.

Rank (d, m) takes rows ``[d·B/dp, (d+1)·B/dp)`` of every global batch
(the same rows on every rank of a 'model' group).  The loss is the mean
over the rank's rows, scaled by ``1/dp``; every gradient, sliced or whole,
is then summed over the data axis in one all-reduce of a flat buffer
(``SyncEngine._step`` with ``grad_axis`` 'data'), the loss and accuracy
packed behind f32 gradients.  The conjugate pair makes a whole
parameter's gradient the same on every rank of a 'model' group, so it
needs no 'model' reduce.  ``grad_accum`` K, the precision policies (fp16
loss scaling included), ``evaluate`` and ``eval_params`` are
``SyncEngine``'s: ``eval_params`` hands over the bound module, which
samples and serves Megatron-cut (TP decode, ``models.gpt.generate(mesh=
...)``, ``SlotKVCache(mesh=...)``); the steps are eager (no CUDA graph)
and the Adam not capturable.

Dropout: every rank of a 'model' group draws from one stream (seeded from
the seed, the step and the data index), so a replicated activation (the
residual stream, the embeddings, a row-parallel output) gets the same
mask on each; a sharded one (TPMLP's hidden layer, BERT's attention
probabilities) draws the whole mask and keeps its slice
(``models.layers.sharded_dropout``).  JAX draws one mask over its global
array, which per-rank generators cannot reproduce, so parity with JAX
holds at dropout 0.

A gradient codec (JAX ``tensor_parallel.py:119-124``): after the exact
data-axis reduce, ``codec.roundtrip`` over whole leaves with a
rank-invariant stream (``Engine._roundtrip_whole``).  The recipe's
``--clip-norm`` takes the global norm (``Engine._global_norm``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import resolve_device
from distributed_tensorflow_tpu_torch.engines.base import Engine
from distributed_tensorflow_tpu_torch.engines.sync import SyncEngine
from distributed_tensorflow_tpu_torch.models.layers import (
    ColumnParallelLinear, RowParallelLinear, bind_model_mesh, flax_init_,
    sharded_dropout, tp_specs)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    SEQ_PARALLEL)


class TPMLP(nn.Module):
    """The reference's default model (Flatten → Dense(512) → ReLU →
    Dropout → Dense(10), JAX ``tensor_parallel.py:33-68``) with its hidden
    layer sharded over 'model': a column-parallel first Dense (its input
    width taken from the first input, as flax infers it), a row-parallel
    second Dense (whose whole bias is added once, by 'model' rank 0).  The
    hidden activation is sharded, so its dropout keeps this rank's
    columns of the whole mask.  Unbound it is the MLP; the parameter
    names are the MLP's (``fc1``, ``fc2``)."""

    tp_mesh = None    # the (data, model) mesh bound by an engine

    def __init__(self, num_classes: int = 10, hidden: int = 512,
                 dropout_rate: float = 0.2, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.hidden = num_classes, hidden
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.fc1 = ColumnParallelLinear(None, hidden, device=device)
        self.fc2 = RowParallelLinear(hidden, num_classes, device=device)

    def bind_tp(self, mesh, prefix: str = "") -> None:
        if self.tp_mesh is None:
            self.fc1.bind(mesh, f"{prefix}.fc1".lstrip("."))
            self.fc2.bind(mesh, f"{prefix}.fc2".lstrip("."))
            self.tp_mesh = mesh

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers (``flax_init_``): the MLP's draws."""
        return flax_init_(self, generator)

    def forward(self, x, train: bool = False, generator=None):
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        if self.tp_mesh is not None:
            x = coll.copy_to_model(x, self.tp_mesh)
        x = F.relu(self.fc1(x, self.dtype))
        x = sharded_dropout(x, self.dropout_rate, train, generator,
                            self.tp_mesh, -1)
        return self.fc2(x, self.dtype).float()


class TensorParallelEngine(SyncEngine):
    """Data × model parallel sync training (module docstring).

    ``mesh`` must have the axes ('data', 'model'); the model's
    partitioned layers (``partition_model=True``, ``TPMLP``) shard over
    'model', every other parameter is whole on every rank."""

    supports_loss_scaling = True
    captures_chunks = False
    codec_roundtrip = True
    build_overlap_probe_fns = None
    grad_axis = meshlib.DATA_AXIS

    def __init__(self, model, optimizer=None, mesh=None,
                 learning_rate: float = 1e-3, grad_accum: int = 1,
                 grad_compression: str = "none", grad_bucket_mb: float = 0.0,
                 precision: str = "f32", device=None):
        if mesh is None or set(mesh.axis_names) != {meshlib.DATA_AXIS,
                                                    meshlib.MODEL_AXIS}:
            raise ValueError(
                "TensorParallelEngine requires a ('data','model') mesh")
        if getattr(model, "attention_impl", None) in SEQ_PARALLEL:
            raise ValueError(
                "TensorParallelEngine runs dense or flash attention; a "
                "sequence-parallel attention needs a 'seq' mesh axis")
        super().__init__(model, optimizer, mesh, learning_rate,
                         grad_accum=grad_accum,
                         grad_compression=grad_compression,
                         grad_bucket_mb=grad_bucket_mb, precision=precision,
                         device=device)
        self.tp = mesh.axis_size(meshlib.MODEL_AXIS)
        bind_model_mesh(self.model, mesh)
        self.param_specs = {k: v for k, v in tp_specs(self.model).items()
                            if v}

    @property
    def codec_stream_words(self) -> tuple[int, ...]:
        """One codec stream for every rank: the roundtrip quantizes the
        reduced gradients' whole leaves."""
        return ()

    def _roundtrip_grads(self, state) -> None:
        self._roundtrip_whole(state)

    def many_step(self, state, xs_seq, ys_seq):
        """Eager steps (``Engine.many_step``): no CUDA graph."""
        return Engine.many_step(self, state, xs_seq, ys_seq)

    def _reduce_totals(self, totals: torch.Tensor) -> None:
        # every rank of a 'model' group scored the same rows
        coll.all_reduce_(totals, self.mesh, axis=meshlib.DATA_AXIS)
