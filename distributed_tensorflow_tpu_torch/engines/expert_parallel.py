"""Expert-parallel (MoE) training engine over a (data, expert) mesh (port
of ``engines/expert_parallel.py``).

JAX runs one GSPMD program: the batch shards over both mesh axes, the
stacked expert weights over ``expert``, and XLA lowers the dispatch and
combine einsums to all-to-alls.  Here every rank is one process of a
row-major ``(data, expert)`` mesh (``parallel/mesh.py``): rank r holds
token shard r of every global batch (``[r·B/n, (r+1)·B/n)``, n = dp·ep),
every replicated parameter (embed, gates, head) and, of each MoE layer,
the experts ``[x·E/ep, (x+1)·E/ep)`` of its expert index x
(``MoELayer.keep_experts``, from the same full draw on every rank).  The
engine binds its mesh to the layers (``models.moe.bind_expert_mesh``),
which then route their rank's tokens as one group of the GLOBAL batch,
as JAX's layer sees it, and run the kept tokens on the experts' ranks of
the data row through ``all_to_all`` (``models/moe.py``).

Loss = task cross-entropy + ``aux_weight`` × the Switch load-balancing
loss + ``router_z_weight`` × the router z-loss (``router_losses``).
Gradient bookkeeping: each rank differentiates its task mean over its
1/n of the tokens, scaled by 1/n, plus the router terms, whose values are
global and whose gradients are the rank's share of the global gradient.
One all-reduce SUM over the whole group of the replicated parameters'
flat gradient (with the task loss and accuracy packed behind it, as
``SyncEngine`` packs them) gives the global-batch gradient; each expert
shard already holds the cotangents of every token of its data row (the
``all_to_all`` backward), so its gradient is summed over the ``data``
axis only.  The metrics are the task ``loss``, ``accuracy``,
``total_loss`` and ``overflow`` (the share of routing assignments dropped
at capacity); ``step`` feeds the overflow to an ``_OverflowMonitor``,
which warns once per episode of sustained overflow.

``grad_accum`` K splits the global batch into K microbatches of B/K rows,
as JAX reshapes it to (K, B/K): ``shard_batch`` gives each rank its token
shard of every microbatch, and each microbatch routes on its own.  The
steps are eager (``Engine.many_step``): no CUDA graph.  Precision: the
bf16 policies; ``fp16-f32master`` is rejected (the router terms do not
thread a loss scale).

ep×tp (JAX ``harness.py:1410-1464``): a third mesh axis, 'model', in the
order (data, expert, model).  Tokens shard over (data, expert) and are
replicated over 'model', so the n = dp·ep token shards set the task
loss's scale and ``shard_batch``'s split, and the ranks of a 'model'
line route alike.  A model built with ``partition_model`` (and
``partition_experts``) keeps the 2-D expert layout (``models/moe.py``):
each rank holds its 'model' slice of every expert's hidden width, and
the Megatron pair sums the partial outputs over 'model'.  The replicated
parameters' gradients are summed over the token shards only (one
all-reduce per token axis), the experts' over 'data', and nothing over
'model', whose ranks hold the same tokens.

A gradient codec (JAX ``expert_parallel.py:203-223``): after the exact
reduces, ``codec.roundtrip`` encodes and decodes the gradients with a
rank-invariant stream (``codec_stream_words`` is ()), so the replicas
stay equal.  JAX's roundtrip sees each stacked expert leaf whole (one
scale and one draw over every expert); here an expert gradient is first
gathered along the expert axis, the whole leaf goes through the codec,
and each rank keeps its slice (``Engine._roundtrip_whole``).  The
recipe's ``--clip-norm`` takes the global norm (``Engine._global_norm``):
the experts' squared norms summed over 'expert', the replicated leaves'
counted once.
"""

from __future__ import annotations

import collections
import copy
import warnings

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, all_reduce_grads_, cross_entropy)
from distributed_tensorflow_tpu_torch.models.moe import (
    MoELayer, bind_expert_mesh, expert_specs, shard_experts)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib


class _OverflowMonitor:
    """Rolling watch over the per-step expert-overflow fraction.

    Buffers the (device-scalar) metric and evaluates the window mean every
    ``window`` observations — fetching only at that cadence keeps the step
    loop's async dispatch intact.  When the mean exceeds ``threshold`` it
    emits ONE ``warnings.warn`` per sustained-high episode (re-arming after
    the mean drops back under), and keeps totals for the run summary."""

    def __init__(self, threshold: float = 0.25, window: int = 50):
        self.threshold = threshold
        self.window = max(int(window), 1)
        self._buf: collections.deque = collections.deque(maxlen=self.window)
        self._count = 0
        self._armed = True
        self.last_window_mean: float | None = None
        self.warning_count = 0

    def observe(self, overflow) -> None:
        self._buf.append(overflow)
        self._count += 1
        if self._count % self.window:
            return
        mean = float(sum(float(v) for v in self._buf) / len(self._buf))
        self.last_window_mean = mean
        if mean > self.threshold:
            if self._armed:
                self._armed = False
                self.warning_count += 1
                warnings.warn(
                    f"MoE expert overflow averaged {mean:.1%} over the last "
                    f"{len(self._buf)} steps (threshold "
                    f"{self.threshold:.0%}): tokens are being dropped at "
                    f"expert capacity — the router may have collapsed; "
                    f"raise capacity_factor or aux_weight",
                    stacklevel=3)
        else:
            self._armed = True

    def report(self) -> dict:
        """Summary fields for the harness run() output."""
        return {
            "expert_overflow_window_mean": self.last_window_mean,
            "expert_overflow_warnings": self.warning_count,
        }


def whole_experts(engine: Engine, state: TrainState) -> nn.Module:
    """A copy of ``state.model`` whose MoE layers hold every expert whole
    (gathered over 'expert', and over 'model' under the 2-D layout:
    ``Engine._whole``, a collective, every rank calls it) and route their
    tokens alone, unbound: what sampling and serving decode.  Any Megatron
    cut of the other layers stays."""
    whole = copy.deepcopy(state.model, memo={id(engine.mesh): engine.mesh})
    with torch.no_grad():
        for name, m in whole.named_modules():
            if not isinstance(m, MoELayer):
                continue
            for pname in ("w1", "w2"):
                full = f"{name}.{pname}"
                setattr(m, pname, nn.Parameter(engine._whole(
                    full, state.model.get_parameter(full).detach())))
            m.experts, m.hidden_cols = (0, m.num_experts), (0, m.hidden)
            m.expert_mesh, m.token_axes = None, ()
    return whole


def router_losses(model: nn.Module):
    """``(aux_loss_sum, z_loss_sum, overflow_mean)`` over the MoE layers of
    ``model``, from their last call (JAX ``router_losses`` over the sown
    intermediates): the aux and z terms differentiable, the overflow a
    detached diagnostic.  Zeros for a model with no MoE layer."""
    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    zero = torch.zeros((), device=next(model.parameters()).device)
    if not layers:
        return zero, zero, zero
    if any(m.aux_loss is None for m in layers):
        raise ValueError("router_losses reads the MoE layers' last call: "
                         "run the model first")
    aux = sum((m.aux_loss for m in layers), zero)
    z = sum((m.z_loss for m in layers), zero)
    overflow = sum((m.overflow for m in layers), zero) / len(layers)
    return aux, z, overflow.detach()


class ExpertParallelEngine(Engine):
    """data × expert parallel sync training.

    ``mesh`` must have the axes ('data', 'expert'[, 'model']); tokens
    shard over ('data', 'expert'), the experts of every MoE layer over
    'expert' (replicated over 'data'; under the 2-D layout their hidden
    width over 'model' too: ``param_specs``).  Parameters are loaded whole and
    sliced: ``load_full_state_dict`` and ``full_state_dict`` (the base
    class's) move a whole model's ``state_dict`` in and out of a state,
    and a checkpoint holds whole leaves."""

    supports_loss_scaling = False
    captures_chunks = False

    @property
    def codec_stream_words(self) -> tuple[int, ...]:
        """One codec stream for every rank: the roundtrip quantizes the
        reduced, replicated gradients."""
        return ()

    def __init__(self, model, optimizer=None, mesh=None,
                 learning_rate: float = 1e-3, aux_weight: float = 0.01,
                 router_z_weight: float = 0.0,
                 overflow_warn_threshold: float = 0.25,
                 overflow_window: int = 50, grad_accum: int = 1,
                 grad_compression: str = "none", grad_bucket_mb: float = 0.0,
                 precision: str = "f32", device=None):
        valid = ({meshlib.DATA_AXIS, meshlib.EXPERT_AXIS},
                 {meshlib.DATA_AXIS, meshlib.EXPERT_AXIS, meshlib.MODEL_AXIS})
        if mesh is None or set(mesh.axis_names) not in valid:
            raise ValueError(
                "ExpertParallelEngine requires a ('data','expert'[,'model']) "
                "mesh")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.aux_weight = aux_weight
        self.router_z_weight = router_z_weight
        self.grad_accum = grad_accum
        self.overflow_monitor = _OverflowMonitor(overflow_warn_threshold,
                                                 overflow_window)
        super().__init__(model, optimizer, mesh, learning_rate,
                         grad_compression=grad_compression,
                         grad_bucket_mb=grad_bucket_mb, precision=precision,
                         device=device)
        self.ep = mesh.axis_size(meshlib.EXPERT_AXIS)
        self.dp = mesh.axis_size(meshlib.DATA_AXIS)
        # the token shards: the batch splits over (data, expert), and a
        # 'model' axis replicates each shard
        self.token_axes = (meshlib.DATA_AXIS, meshlib.EXPERT_AXIS)
        self.n_devices = self.dp * self.ep
        self.rank = (mesh.axis_index(meshlib.DATA_AXIS) * self.ep
                     + mesh.axis_index(meshlib.EXPERT_AXIS))
        self.moe_layers = {name: m for name, m in self.model.named_modules()
                           if isinstance(m, MoELayer)}
        for m in self.moe_layers.values():
            if m.num_experts % self.ep:
                raise ValueError(
                    f"num_experts {m.num_experts} not divisible by "
                    f"expert_parallel {self.ep}")
        self.expert_params = {f"{name}.{p}" for name in self.moe_layers
                              for p in ("w1", "w2")}
        # the stacked experts are cut along their leading (expert) dim,
        # and under the 2-D layout their hidden width over 'model'
        self.param_specs = expert_specs(self.model, mesh, every_layer=True)

    # ---------------------------------------------------------------- init
    def _own_params(self, model: nn.Module) -> None:
        """Keep this rank's slice of every layer's experts (once; a later
        init draws into the slice) and bind the mesh to the layers."""
        shard_experts(model, self.mesh, every_layer=True)
        bind_expert_mesh(model, self.mesh, self.token_axes)

    # ------------------------------------------------------------- batches
    def shard_batch(self, x, y, mask=None, process_local: bool = False):
        """This rank's token shard of a global batch.  A training batch (no
        row mask) under ``grad_accum`` K is cut into K microbatches of B/K
        rows first, as JAX reshapes it, and the rank takes its shard of
        each, so that its K chunks are its shares of the K microbatches;
        an evaluation batch (with its row mask) splits in one piece.
        ``process_local=True``: the rows given are already this rank's."""
        k = self.grad_accum if mask is None else 1

        def put(a):
            if not process_local:
                n, r = self.n_devices, self.rank
                if len(a) % (n * k):
                    raise ValueError(f"batch of {len(a)} rows does not "
                                     f"split over {n} ranks × {k} "
                                     f"microbatches")
                b = len(a) // (n * k)
                a = np.asarray(a).reshape((k, n, b) + a.shape[1:])[:, r]
                a = a.reshape((k * b,) + a.shape[2:])
            return self._put(a)

        if mask is None:
            return put(x), put(y)
        return put(x), put(y), put(mask)

    # ---------------------------------------------------------------- step
    def step(self, state: TrainState, x, y):
        state, metrics = super().step(state, x, y)
        self.overflow_monitor.observe(metrics["overflow"])
        return state, metrics

    def _step(self, state: TrainState, x, y):
        """One step on this rank's token shard ``x``, ``y``; updates
        ``state`` in place and returns the global metrics as 0-dim device
        tensors."""
        k, n = self.grad_accum, self.n_devices
        if x.shape[0] % k:
            raise ValueError(f"per-device batch {x.shape[0]} not divisible "
                             f"by grad_accum {k}")
        model = state.model
        gen = self.step_generator(state)
        state.optimizer.zero_grad(set_to_none=True)
        sums = 0.0
        for xc, yc in zip(x.chunk(k), y.chunk(k)):
            logits = model(xc, train=True, generator=gen)
            task = cross_entropy(logits, yc).mean()
            acc = (logits.argmax(-1) == yc).float().mean()
            aux, z, overflow = router_losses(model)
            # this rank's share of the global loss: the task mean over its
            # 1/n of the tokens, the router terms' own shares
            ((task / n + self.aux_weight * aux
              + self.router_z_weight * z) / k).backward()
            sums = sums + torch.stack([task.detach() / n, acc / n,
                                       aux.detach(), z.detach(), overflow])
        sums = sums / k
        task, acc = self._reduce(model, sums[:2])
        aux, z, overflow = sums[2], sums[3], sums[4]
        if self.grad_codec.name != "none":
            self._roundtrip_whole(state)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": task, "accuracy": acc,
                       "total_loss": (task + self.aux_weight * aux
                                      + self.router_z_weight * z),
                       "overflow": overflow}

    def _reduce(self, model: nn.Module, metrics: torch.Tensor):
        """Sum the replicated parameters' gradients over the token shards
        (every rank without a 'model' axis; the metrics with them) and
        the experts' over the data axis; returns the summed metrics."""
        named = list(model.named_parameters())
        shared = [p for name, p in named if name not in self.expert_params]
        experts = [p for name, p in named if name in self.expert_params]
        axes = (None if meshlib.MODEL_AXIS not in self.mesh.axis_names
                else self.token_axes)
        summed = all_reduce_grads_(shared, self.mesh, metrics, axis=axes)
        if self.dp > 1 and experts:
            all_reduce_grads_(experts, self.mesh, axis=meshlib.DATA_AXIS)
        return summed

    def eval_params(self, state: TrainState) -> nn.Module:
        """The model that sampling and serving decode: every expert
        gathered whole, the MoE layers routing alone
        (``whole_experts``)."""
        return whole_experts(self, state) if self.moe_layers else state.model

    def _eval_module(self, state: TrainState) -> nn.Module:
        # evaluation routes this rank's rows over the bound mesh
        return state.model

    def _reduce_totals(self, totals: torch.Tensor) -> None:
        # the ranks of a 'model' line scored the same rows
        if meshlib.MODEL_AXIS not in self.mesh.axis_names:
            coll.all_reduce_(totals, self.mesh)
            return
        for axis in self.token_axes:
            coll.all_reduce_(totals, self.mesh, axis=axis)
