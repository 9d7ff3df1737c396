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
thread a loss scale), and an ep×tp ``model`` axis and the composites with
other model-parallel axes are not ported.

A gradient codec (JAX ``expert_parallel.py:203-223``): after the exact
reduces, ``codec.roundtrip`` encodes and decodes the gradients with a
rank-invariant stream (``codec_stream_words`` is ()), so the replicas
stay equal.  JAX's roundtrip sees each stacked expert leaf whole (one
scale and one draw over every expert); here an expert gradient is first
gathered along the expert axis, the whole leaf goes through the codec,
and each rank keeps its slice.
"""

from __future__ import annotations

import collections
import warnings

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_tpu_torch import not_ported
from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, all_reduce_grads_, cross_entropy)
from distributed_tensorflow_tpu_torch.models.moe import (
    MoELayer, bind_expert_mesh)
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

    ``mesh`` must have the axes ('data', 'expert'); tokens shard over the
    whole mesh, the experts of every MoE layer over 'expert' (replicated
    over 'data').  Parameters are loaded whole and sliced here:
    ``load_full_state_dict`` and ``full_state_dict`` move a whole model's
    ``state_dict`` in and out of a state."""

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
                 {meshlib.DATA_AXIS, meshlib.EXPERT_AXIS, "model"})
        if mesh is None or set(mesh.axis_names) not in valid:
            raise ValueError(
                "ExpertParallelEngine requires a ('data','expert'[,'model']) "
                "mesh")
        if "model" in mesh.axis_names:
            not_ported("a 'model' mesh axis (ep×tp)", "remaining engines")
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
        # every rank holds a token shard: the batch splits over both axes
        self.n_devices, self.rank = mesh.world_size, mesh.rank
        self.ep = mesh.axis_size(meshlib.EXPERT_AXIS)
        self.dp = mesh.axis_size(meshlib.DATA_AXIS)
        self.expert_index = mesh.axis_index(meshlib.EXPERT_AXIS)
        self.moe_layers = {name: m for name, m in self.model.named_modules()
                           if isinstance(m, MoELayer)}
        for m in self.moe_layers.values():
            if m.num_experts % self.ep:
                raise ValueError(
                    f"num_experts {m.num_experts} not divisible by "
                    f"expert_parallel {self.ep}")
        self.expert_params = {f"{name}.{p}" for name in self.moe_layers
                              for p in ("w1", "w2")}

    # ---------------------------------------------------------------- init
    def _own_params(self, model: nn.Module) -> None:
        """Keep this rank's experts of every layer (once; a later init
        draws into the slice) and bind the mesh to the layers."""
        for m in self.moe_layers.values():
            per = m.num_experts // self.ep
            lo = self.expert_index * per
            if m.experts != (lo, lo + per):
                m.keep_experts(lo, lo + per)
        bind_expert_mesh(model, self.mesh)

    def _slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if name not in self.expert_params:
            return t
        per = t.shape[0] // self.ep
        return t[self.expert_index * per:(self.expert_index + 1) * per]

    def load_full_state_dict(self, state: TrainState, full: dict) -> None:
        """Load a whole model's ``state_dict`` (every expert) into this
        rank's parameters, keeping its slice of the experts."""
        state.model.load_state_dict(
            {k: self._slice(k, v) for k, v in full.items()})

    def full_state_dict(self, state: TrainState) -> dict:
        """The whole model's ``state_dict``: every rank's experts gathered
        along the expert axis (a collective: every rank calls it)."""
        out = {}
        for k, v in state.model.state_dict().items():
            if k in self.expert_params and self.ep > 1:
                v = coll.all_gather(v.contiguous(), self.mesh, tiled=True,
                                    axis=meshlib.EXPERT_AXIS)
            out[k] = v.detach().clone()
        return out

    # ---------------------------------------------------------- checkpoint
    def _expert_key(self, key: str) -> bool:
        """A checkpoint entry cut along the expert axis: an expert
        weight, its master, or an optimizer entry of its shape."""
        kind, _, rest = key.partition("/")
        name = rest.rsplit("/", 1)[0] if kind == "opt" else rest
        return kind in ("model", "master", "opt") and name in \
            self.expert_params

    def checkpoint_state(self, state: TrainState) -> dict:
        """``Engine.checkpoint_state`` of the whole model: every rank's
        experts gathered along the expert axis, as ``full_state_dict``
        gathers the parameters (a collective: every rank calls it)."""
        d = super().checkpoint_state(state)
        full = self.full_state_dict(state)
        for k, v in d.items():
            if not isinstance(v, torch.Tensor) or not self._expert_key(k):
                continue
            if k.startswith("model/"):
                d[k] = full[k[len("model/"):]]
            elif v.dim() and self.ep > 1:
                d[k] = coll.all_gather(v.contiguous(), self.mesh,
                                       tiled=True, axis=meshlib.EXPERT_AXIS)
        return d

    def load_checkpoint_state(self, state, d: dict):
        """Load a whole model's checkpoint, keeping this rank's slice of
        every expert entry (``load_full_state_dict``'s cut)."""
        d = {k: (self._slice(k.split("/")[1], v)
                 if isinstance(v, torch.Tensor) and v.dim()
                 and self._expert_key(k) else v)
             for k, v in d.items()}
        return super().load_checkpoint_state(state, d)

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
            self._roundtrip_grads(state)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": task, "accuracy": acc,
                       "total_loss": (task + self.aux_weight * aux
                                      + self.router_z_weight * z),
                       "overflow": overflow}

    def _roundtrip_grads(self, state: TrainState) -> None:
        """``codec.roundtrip`` of the reduced gradients with the
        rank-invariant stream, over the whole model's leaves: an expert
        gradient is gathered along the expert axis first and this rank
        keeps its slice of the result."""
        named = [(n, p) for n, p in state.model.named_parameters()
                 if p.grad is not None]
        whole = []
        for name, p in named:
            g = p.grad
            if name in self.expert_params and self.ep > 1:
                g = coll.all_gather(g.contiguous(), self.mesh, tiled=True,
                                    axis=meshlib.EXPERT_AXIS)
            whole.append(g)
        out = self.grad_codec.roundtrip(
            whole, generator=self.codec_step_generator(state))
        for (name, p), g in zip(named, out):
            p.grad = self._slice(name, g)

    def _exchanged_leaves(self, state: TrainState) -> list:
        """The whole model's parameters (JAX's global leaves): an expert
        leaf counts at its full (E, ...) shape."""
        out = []
        for name, p in state.model.named_parameters():
            if name in self.expert_params:
                shape = (p.shape[0] * self.ep, *p.shape[1:])
                p = torch.empty(shape, dtype=p.dtype, device="meta")
            out.append(p)
        return out

    def _reduce(self, model: nn.Module, metrics: torch.Tensor):
        """Sum the replicated parameters' gradients over every rank (the
        metrics with them) and the experts' over the data axis; returns
        the summed metrics."""
        named = list(model.named_parameters())
        shared = [p for name, p in named if name not in self.expert_params]
        experts = [p for name, p in named if name in self.expert_params]
        summed = all_reduce_grads_(shared, self.mesh, metrics)
        if self.dp > 1 and experts:
            all_reduce_grads_(experts, self.mesh, axis=meshlib.DATA_AXIS)
        return summed
