"""Composed parallelism over a ('data', 'model', 'seq'[, 'expert']) mesh
(port of ``engines/composite.py``).

JAX runs one program: GSPMD over 'data', 'model' and 'expert', manual
over 'seq' inside a partial ``shard_map``.  Here every rank is one
process of a row-major mesh (``parallel/mesh.py``; the harness's orders:
(data, model, seq) for tp×sp, (data, expert, seq) for ep×sp, (data,
expert, seq, model) for ep×tp×sp) and every collective is explicit:

* 'data' shards the batch: rank (d, ...) takes rows ``[d·B/dp,
  (d+1)·B/dp)`` of every global batch;
* 'seq' shards the sequence: seq rank s takes token columns ``[s·L/sp,
  (s+1)·L/sp)`` (an LM's labels with them), and the model's ring or
  Ulysses attention runs over the 'seq' sub-group
  (``models.layers.bind_seq_mesh``);
* 'model' cuts the Megatron layers (``partition_model``,
  ``models.layers.bind_model_mesh``), whose conjugate pair carries the
  activations' gradients; the attention runs on the rank's local heads;
* 'expert' cuts the experts of the MoE layers with ``partition_experts``
  (``models.moe.shard_experts``; under 'model' too, the 2-D expert
  layout).  Tokens are replicated over 'expert', as over 'model': every
  rank of an expert line routes the same tokens, runs its own experts and
  the combine is summed over 'expert' (the layers' ``replicated`` route).
  A MoE layer routes the tokens of its seq block over every data rank as
  JAX's GSPMD-global 'data' axis sees them: its group size comes from the
  global ``B × L/sp`` tokens (``models.moe.moe_ffn``), and the ranks of a
  data line gather their counts.

Gradient bookkeeping: the ranks that hold different tokens of the same
parameter slice are the 'data' × 'seq' ranks, so every leaf, whole or
cut, is summed over 'data' and over 'seq' (one all-reduce of the flat
gradient per axis larger than 1, the metrics packed behind it), never
over 'model' or 'expert', whose ranks hold the same tokens.  Each rank
differentiates its task mean scaled by ``1/(dp·sp)`` (an LM's seq rank
scores its own block; a classifier's seq ranks hold the same loss, the
``[CLS]`` row broadcast from seq rank 0, whose backward sums their
cotangents) plus ``1/sp`` of the router terms, whose values are the
block's global ones and whose gradients are the rank's share (JAX
``composite.py:186-226``: ``total / sp`` for an LM, the router terms'
``pmean`` over 'seq' for a classifier).  The reported ``loss``,
``accuracy``, ``total_loss`` and ``overflow`` are the global means (JAX
``:305-312``).

``grad_accum`` K: ``shard_batch`` lays a training batch out as JAX's
(K, B/K) reshape of the global batch, so each of a rank's K chunks is its
share of one microbatch, which routes on its own.  Dropout: each rank's
stream is seeded from (seed, step, data index, seq index), so every
token block draws its own masks and the ranks of a 'model' or 'expert'
line draw alike (JAX ``:283-286``).  A gradient codec is a roundtrip
after the exact reduces with one stream for every rank, over whole
leaves (``Engine._roundtrip_whole``; JAX ``:276-282, 297-302``).  The
bf16 policies ride the base class; ``fp16-f32master`` is rejected.  The
steps are eager (``Engine.many_step``): no CUDA graph.

At seq size 1 JAX swaps ring and Ulysses attention for the dense twin
(``:119-124``); here the model keeps its sequence-parallel attention on
the mesh's 'seq' axis of one rank, as ``SeqParallelEngine`` does at
sp = 1: a ring of one block is the whole causal attention, so the flash
block kernels stay on the card's path.  ``evaluate`` sums the masked
totals over 'data' (and 'seq' for an LM).  ``eval_params`` (what
sampling and serving decode) is a copy of the model with its experts
gathered and its MoE layers routing alone; its Megatron cut stays.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, all_reduce_grads_, cross_entropy)
from distributed_tensorflow_tpu_torch.engines.expert_parallel import (
    _OverflowMonitor, router_losses, whole_experts)
from distributed_tensorflow_tpu_torch.models.layers import (
    bind_model_mesh, bind_seq_mesh, tp_specs)
from distributed_tensorflow_tpu_torch.models.moe import (
    bind_expert_mesh, expert_specs, shard_experts)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    SEQ_PARALLEL)


class CompositeEngine(Engine):
    """Sync training over a ('data', 'model', 'seq'[, 'expert']) mesh
    (module docstring).  Any axis but 'data' may be absent or of size 1;
    'seq' > 1 needs a model whose ``attention_impl`` is 'ring',
    'ring_flash', 'ulysses' or 'ulysses_flash'; an 'expert' axis needs
    MoE blocks built with ``partition_experts``."""

    seq_axis = meshlib.SEQ_AXIS
    supports_loss_scaling = False
    captures_chunks = False

    @property
    def codec_stream_words(self) -> tuple[int, ...]:
        """One codec stream for every rank: the roundtrip quantizes the
        reduced gradients' whole leaves."""
        return ()

    def __init__(self, model, optimizer=None, mesh=None,
                 learning_rate: float = 1e-3, aux_weight: float = 0.01,
                 router_z_weight: float = 0.0,
                 overflow_warn_threshold: float = 0.25,
                 overflow_window: int = 50, grad_accum: int = 1,
                 grad_compression: str = "none", grad_bucket_mb: float = 0.0,
                 precision: str = "f32", device=None):
        # JAX composite.py:70-97, its checks and messages
        if mesh is None or meshlib.DATA_AXIS not in mesh.axis_names:
            raise ValueError("CompositeEngine requires a mesh with a 'data' "
                             "axis (plus optional 'model'/'seq'/'expert')")
        extra = set(mesh.axis_names) - {meshlib.DATA_AXIS, meshlib.MODEL_AXIS,
                                        meshlib.SEQ_AXIS, meshlib.EXPERT_AXIS}
        if extra:
            raise ValueError(f"unsupported mesh axes {sorted(extra)}; "
                             f"CompositeEngine composes data×model×seq×expert")
        self.moe = getattr(model, "moe_experts", 0) > 0
        self.ep_n = mesh.shape.get(meshlib.EXPERT_AXIS, 1)
        if self.ep_n > 1:
            if not self.moe:
                raise ValueError(
                    "mesh has an 'expert' axis but the model has no MoE "
                    "blocks (moe_experts == 0); experts would silently "
                    "replicate")
            if not getattr(model, "partition_experts", False):
                raise ValueError(
                    "an 'expert' mesh axis needs partition_experts=True on "
                    "the model — without the with_partitioning('expert') "
                    "annotations the expert weights replicate and no "
                    "expert parallelism happens")
            if getattr(model, "moe_experts", 0) % self.ep_n:
                raise ValueError(
                    f"moe_experts {model.moe_experts} not divisible by "
                    f"expert axis size {self.ep_n}")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.grad_accum = grad_accum
        self.aux_weight = aux_weight
        self.router_z_weight = router_z_weight
        self.overflow_monitor = _OverflowMonitor(overflow_warn_threshold,
                                                 overflow_window)
        super().__init__(model, optimizer, mesh, learning_rate,
                         grad_compression=grad_compression,
                         grad_bucket_mb=grad_bucket_mb, precision=precision,
                         device=device)
        self.seq_n = mesh.shape.get(meshlib.SEQ_AXIS, 1)
        self.tp_n = mesh.shape.get(meshlib.MODEL_AXIS, 1)
        impl = getattr(model, "attention_impl", "dense")
        if self.seq_n > 1 and impl not in SEQ_PARALLEL:
            raise ValueError(
                f"seq axis size {self.seq_n} needs attention_impl 'ring', "
                f"'ring_flash', 'ulysses' or 'ulysses_flash', got "
                f"'{impl}'")
        if impl in SEQ_PARALLEL and meshlib.SEQ_AXIS not in mesh.axis_names:
            raise ValueError(
                f"attention_impl '{impl}' runs over a 'seq' mesh axis "
                f"(size 1 is fine); this mesh has {mesh.axis_names}")
        self.seq_index = (mesh.axis_index(meshlib.SEQ_AXIS)
                          if meshlib.SEQ_AXIS in mesh.axis_names else 0)
        # the axes whose ranks hold different tokens of the same slice
        self.grad_axes = tuple(a for a in mesh.axis_names
                               if a in (meshlib.DATA_AXIS, meshlib.SEQ_AXIS))
        # causal LMs: (B, L) per-token labels shard over 'seq' with the
        # inputs, and each seq rank's logits are its own block's
        self.lm = bool(getattr(model, "causal_lm", False))
        if meshlib.MODEL_AXIS in mesh.axis_names:
            bind_model_mesh(self.model, mesh)
        if impl in SEQ_PARALLEL:
            bind_seq_mesh(self.model, mesh)
        self.param_specs = {k: v for k, v in tp_specs(self.model).items()
                            if v}
        self.param_specs.update(expert_specs(self.model, mesh))

    @property
    def stream_words(self) -> tuple[int, ...]:
        """Dropout streams fold in the data and the seq index: every token
        block draws its own masks, the ranks of a 'model' or 'expert'
        line the same ones."""
        return (self.rank, self.seq_index)

    # ---------------------------------------------------------------- init
    def _own_params(self, model: nn.Module) -> None:
        """Keep this rank's slice of the ``partition_experts`` layers
        (once; a later init draws into the slice) and bind the mesh to
        every MoE layer: tokens sharded over 'data', replicated over
        'expert'."""
        if self.moe:
            shard_experts(model, self.mesh)
            bind_expert_mesh(model, self.mesh, (meshlib.DATA_AXIS,),
                             route="replicated")

    # ------------------------------------------------------------- batches
    def shard_batch(self, x, y, mask=None, process_local: bool = False):
        """This rank's rows (by data index) and, when 'seq' > 1, token
        columns (by seq index) of a global batch (JAX ``:145-166``); an
        LM's (B, L) labels are cut like the inputs, a classifier's labels
        and the row mask by rows only.  A training batch (no row mask)
        under ``grad_accum`` K is cut into K microbatches of B/K rows
        first, as JAX reshapes it.  ``process_local=True``: the rows
        given are already this rank's."""
        if self.seq_n > 1:
            if x.ndim < 2:
                raise ValueError("seq sharding needs (batch, seq, ...) input")
            if x.shape[1] % self.seq_n:
                raise ValueError(f"sequence length {x.shape[1]} not "
                                 f"divisible by seq axis size {self.seq_n}")
        k = self.grad_accum if mask is None else 1

        def rows(a):
            if process_local:
                return a
            n, r = self.n_devices, self.rank
            if len(a) % (n * k):
                raise ValueError(f"batch of {len(a)} rows does not split "
                                 f"over {n} data ranks × {k} microbatches")
            b = len(a) // (n * k)
            a = np.asarray(a).reshape((k, n, b) + a.shape[1:])[:, r]
            return a.reshape((k * b,) + a.shape[2:])

        def cols(a):
            c = a.shape[1] // self.seq_n
            return a[:, self.seq_index * c:(self.seq_index + 1) * c]

        xs = self._put(cols(rows(x)))
        ys = self._put(cols(rows(y)) if self.lm and y.ndim >= 2
                       else rows(y))
        if mask is None:
            return xs, ys
        return xs, ys, self._put(rows(mask))

    # ---------------------------------------------------------------- step
    def step(self, state: TrainState, x, y):
        state, metrics = super().step(state, x, y)
        if self.moe:
            self.overflow_monitor.observe(metrics["overflow"])
        return state, metrics

    def _step(self, state: TrainState, x, y):
        """One step on this rank's block ``x``, ``y``; updates ``state`` in
        place and returns the global metrics as 0-dim device tensors."""
        k, dp, sp = self.grad_accum, self.n_devices, self.seq_n
        if x.shape[0] % k:
            raise ValueError(f"per-device batch {x.shape[0]} not divisible "
                             f"by grad_accum {k}")
        model = state.model
        gen = self.step_generator(state)
        state.optimizer.zero_grad(set_to_none=True)
        zero = torch.zeros((), device=self.device)
        sums = 0.0
        for xc, yc in zip(x.chunk(k), y.chunk(k)):
            logits = model(xc, train=True, generator=gen)
            task = cross_entropy(logits, yc).mean()
            acc = (logits.argmax(-1) == yc).float().mean()
            aux, z, overflow = (router_losses(model) if self.moe
                                else (zero, zero, zero))
            # this rank's share: the task mean over its tokens, the router
            # terms' global values with their shares of the gradient
            ((task / (dp * sp) + (self.aux_weight * aux
                                  + self.router_z_weight * z) / sp)
             / k).backward()
            sums = sums + torch.stack([task.detach(), acc, aux.detach(),
                                       z.detach(), overflow]) / (dp * sp)
        sums = all_reduce_grads_(list(model.parameters()), self.mesh,
                                 sums / k, axis=self.grad_axes)
        if self.grad_codec.name != "none":
            self._roundtrip_whole(state)
        state.optimizer.step()
        state.step += 1
        task, acc, aux, z, overflow = sums
        metrics = {"loss": task, "accuracy": acc}
        if self.moe:
            metrics["total_loss"] = (task + self.aux_weight * aux
                                     + self.router_z_weight * z)
            metrics["overflow"] = overflow
        return state, metrics

    # ---------------------------------------------------------------- eval
    def _eval_module(self, state: TrainState) -> nn.Module:
        return state.model

    def _reduce_totals(self, totals: torch.Tensor) -> None:
        # an LM's seq ranks scored their own token blocks; a classifier's
        # hold the same logits, as the ranks of a 'model' or 'expert' line
        for axis in self.grad_axes if self.lm else (meshlib.DATA_AXIS,):
            if self.mesh.axis_size(axis) > 1:
                coll.all_reduce_(totals, self.mesh, axis=axis)

    def eval_params(self, state: TrainState) -> nn.Module:
        """The model that sampling and serving decode: a copy whose MoE
        layers hold every expert whole and route alone
        (``expert_parallel.whole_experts``, a collective: every rank calls
        it); the state's own module when it has no MoE layer.  A 'model'
        axis's Megatron cut stays: it decodes over the mesh (TP decode,
        ``models.gpt.generate(mesh=...)``), or the harness serves its
        gathered twin."""
        if not self.moe:
            return state.model
        return whole_experts(self, state)
