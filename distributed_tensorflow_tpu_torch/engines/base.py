"""Shared engine machinery: TrainState, loss, eval, batch placement (port of
``engines/base.py``).

The JAX engines are jitted SPMD programs over a mesh with a pure
``TrainState`` value.  The port runs eagerly, one process per device: the
state holds the live ``nn.Module`` and ``torch.optim`` optimizer, and a
step updates them in place.  With a ``mesh`` (``parallel/mesh.py``) the
ranks of a ``torch.distributed`` group each take their rows of every
global batch and sum their gradients with one collective; without one the
engine runs on one device.

``precision`` (``parallel/precision.py``) is resolved here: ``init_state``
stores the parameters in the policy's dtype before it builds the
optimizer, a master policy wraps the optimizer in ``MasterWeights``, and
under fp16 loss scaling ``step`` adds the scale after the step and the
skip flag (``loss_scale``, ``ls_skipped``) to the metrics, which stack
through ``many_step`` like the loss.  On the card an engine that
captures its drained chunk as a CUDA graph (``captures_chunks``:
``SyncEngine``) builds the default Adam ``capturable`` (its step counts
live on the device), so the same update runs eagerly and inside the
graph; the others keep the plain default.

``grad_compression``/``grad_bucket_mb`` resolve to ``self.grad_codec``
(``parallel/overlap.make_overlap_codec``): the codec each engine runs its
exchange through.  Its rounding stream is a second generator,
``TrainState.codec_generator`` (``codec_step_generator``): on the CPU it
is reseeded every step from (seed, step, stream words, the codec's tag),
as the dropout stream is; on the card it is a Philox stream seeded once
by ``init_state``, registered with every captured chunk beside the
dropout stream, and checkpointed under ``codec_generator/<rank>``.  It is
a stream of its own, so a codec leaves the dropout masks as they were.
``grad_collective_bytes`` and ``grad_collective_bytes_raw`` are the
payload of one exchange under the codec and without it.

``checkpoint_state``/``load_checkpoint_state`` turn a ``TrainState`` into
the flat dict a checkpoint holds (``utils/checkpoint.py``) and back, in
place: every tensor is copied into the live one (``copy_``), so a CUDA
graph captured over the state and ``MasterWeights``' flat views stay
valid.

An engine whose ranks hold slices of the parameters (FSDP, TP, EP) sets
``param_specs``: each parameter's layout over the mesh, by name, a tuple
with the axis its slice is cut along at each sharded dim (None
elsewhere; ``()`` replicated; for a leaf in ``stacked_params``, one
entry more than its rank: the axis its slices stack over, then its own
layout, e.g. a pipeline stage's Megatron cut).  From it the base class writes a
checkpoint of whole leaves (gathered, every rank calling it) and
restores one by cutting each rank's slice, so a checkpoint does not
depend on the layout (``full_state_dict``/``load_full_state_dict`` do
the same for a ``state_dict``); the codec's roundtrip sees whole leaves
(``_roundtrip_whole``), as JAX's sees its global arrays; and the recipe
optimizer's clip takes the global norm (``_global_norm``): every rank's
squared norms gathered, a leaf replicated over an axis counted on that
axis's rank 0 only.

``enable_health`` (``--health on``, before ``init_state``) installs the
health capture of ``observability/health.py`` on the optimizer
``init_state`` builds (outside a master policy's ``MasterWeights``), so
every step's metrics gain the six health keys, computed on the device
(inside a replayed chunk too) and stacked through ``many_step`` like the
loss.  The loss EMA behind ``loss_spike`` is a pair of device tensors the
engine holds (fresh at every ``init_state``, so it restarts on a
resume); the capture's step count is a checkpoint entry.  Where ranks
hold slices, the stats are the whole model's (``_health_reduce``, the
recipe clip's weighting); where they hold their own copies, the worst
rank's norms and ratio and the sum of the counts.  With health off
nothing is wrapped and nothing extra runs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import is_lazy

from distributed_tensorflow_tpu_torch import resolve_device
from distributed_tensorflow_tpu_torch.observability import health as hl
from distributed_tensorflow_tpu_torch.observability.roofline import (
    GPTCostModel)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import compression
from distributed_tensorflow_tpu_torch.parallel import overlap
from distributed_tensorflow_tpu_torch.parallel import precision as precisionlib
from distributed_tensorflow_tpu_torch.parallel.mesh import DATA_AXIS


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState`` (step, params, opt_state, rng) as live
    objects: ``model`` holds the parameters, ``optimizer`` the optimizer
    state (a ``MasterWeights`` under a master policy), ``generator`` the
    stream on the device that dropout draws from
    (``Engine.step_generator``), ``codec_generator`` the gradient codec's
    rounding stream (``Engine.codec_step_generator``).  Engines update it
    in place."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    codec_generator: torch.Generator | None = None
    seed: int = 0
    # the engine whose init_state built it: a checkpoint manager saves and
    # restores the state through it
    engine: Any = dataclasses.field(default=None, repr=False, compare=False)


def _seed_of(*words: int) -> int:
    """A 63-bit generator seed drawn from ``words``."""
    seq = np.random.SeedSequence(list(words))
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element sparse categorical cross-entropy from logits (computed in
    f32), for integer labels of any leading shape — the counterpart of
    ``optax.softmax_cross_entropy_with_integer_labels``."""
    v = logits.shape[-1]
    ce = F.cross_entropy(logits.reshape(-1, v).float(),
                         labels.reshape(-1).long(), reduction="none")
    return ce.reshape(labels.shape)


def token_weights(mask: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-element eval weights: broadcast the pipeline's per-ROW validity
    flag (B,) over the label's trailing dims, so eval counts tokens for LMs
    and examples for classifiers."""
    mask = mask.reshape(mask.shape + (1,) * (y.ndim - mask.ndim))
    return mask.expand(y.shape)


def all_reduce_grads_(params: list, mesh, metrics: torch.Tensor | None = None,
                      axis: str | tuple[str, ...] | None = None
                      ) -> torch.Tensor | None:
    """Sum the gradients of ``params`` over ``axis`` of ``mesh`` (None:
    every rank; a tuple of axes: each in turn, one of size 1 skipped)
    with one all-reduce of a flat buffer per axis; each ``.grad`` then
    becomes a view of its slice.  ``metrics`` (an f32 vector) rides
    behind f32 gradients, and goes in an f32 all-reduce of its own behind
    16-bit ones; returns the summed metrics (None without)."""
    axes = ((axis,) if not isinstance(axis, tuple) else
            tuple(a for a in axis if mesh.axis_size(a) > 1))
    packed = metrics is not None and all(p.dtype == metrics.dtype
                                         for p in params)
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params] + ([metrics] if packed else []))
    for a in axes:
        coll.all_reduce_(flat, mesh, axis=a)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    if metrics is None:
        return None
    if packed:
        return flat[off:]
    for a in axes:
        metrics = coll.all_reduce_(metrics, mesh, axis=a)
    return metrics


def make_loss_fn(model: nn.Module) -> Callable:
    """``loss_fn(x, y, generator) -> (mean loss, mean accuracy)`` over every
    label element, with the model in training mode (dropout on)."""

    def loss_fn(x, y, generator):
        logits = model(x, train=True, generator=generator)
        loss = cross_entropy(logits, y).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, acc

    return loss_fn


def spec_axes(spec: tuple) -> list[tuple[int, str]]:
    """(dim, axis) of each sharded dim of a layout ``spec``."""
    return [(d, a) for d, a in enumerate(spec) if a is not None]


class Engine:
    """Base: owns model, optimizer factory, mesh and device; subclasses
    implement ``step``.

    ``optimizer`` is a callable ``params -> torch.optim.Optimizer``; the
    default ``torch.optim.Adam(lr=learning_rate)`` is the counterpart of the
    JAX default ``optax.adam(learning_rate)`` (same betas, eps 1e-8 outside
    the square root, same bias correction; the two round differently), with
    ``capturable=True`` on the card where the engine ``captures_chunks``.
    A master ``precision`` policy builds
    the optimizer over the f32 master (``MasterWeights``).
    ``mesh`` (``parallel.mesh.create_mesh``) makes this process one rank of
    a data-parallel group and puts the model on the mesh's device;
    without one, ``device=None`` means the CUDA card."""

    # engines whose step multiplies its loss by the dynamic loss scale set
    # this; the constructor rejects a scaling policy on the others
    supports_loss_scaling = False
    # engines that replay their drained chunk as a CUDA graph set this: on
    # the card their default Adam keeps its step counts on the device
    captures_chunks = False
    # engines whose ranks hold different states (local SGD, gossip) set
    # this: a checkpoint then holds every rank's state, and restores only
    # onto the rank count that wrote it
    checkpoint_per_rank = False
    # engines whose ranks hold slices of parameters set each one's layout
    # (module docstring); empty: every rank holds every parameter whole
    param_specs: dict = {}
    # the parameters whose whole leaf stacks one slice per rank of the
    # axis its spec names first, along a new leading dim (a pipeline
    # stage's block)
    stacked_params: frozenset = frozenset()
    # the health layer's config (enable_health); None: health off
    health = None
    # the program ledger (observability/xla_stats.ProgramLedger) a
    # capturing engine records its chunk graphs in; None: off
    ledger = None

    def __init__(self, model, optimizer: Callable | None = None, mesh=None,
                 learning_rate: float = 1e-3, grad_compression: str = "none",
                 grad_bucket_mb: float = 0.0, precision: str = "f32",
                 device=None):
        # the exchange's codec: 'none' at bucket 0 keeps every engine's
        # pre-codec program (compression.codec_active)
        self.grad_codec = overlap.make_overlap_codec(grad_compression,
                                                     grad_bucket_mb)
        self.precision = precisionlib.make_policy(precision)
        if self.precision.loss_scaling and not self.supports_loss_scaling:
            raise ValueError(
                f"precision '{self.precision.name}' needs dynamic loss "
                f"scaling, which {type(self).__name__} does not thread "
                f"into its loss — use a bf16 policy (bf16/bf16-f32master: "
                f"bfloat16 shares f32's exponent range, no scaling "
                f"needed), or train with a loss-scaling engine "
                f"(sync/allreduce/fsdp/tensor_parallel)")
        if mesh is not None:
            want = torch.device(mesh.device if device is None else device)
            if (want.type, want.index or mesh.device.index) != (
                    mesh.device.type, mesh.device.index):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        # the data axis: its size and this rank's index on it (the whole
        # group on a 1-D mesh)
        self.n_devices = mesh.axis_size(DATA_AXIS) if mesh is not None else 1
        self.rank = mesh.axis_index(DATA_AXIS) if mesh is not None else 0
        self.model = model.to(self.device)
        capturable = self.device.type == "cuda" and self.captures_chunks
        self.make_optimizer = self.precision.wrap_optimizer(
            optimizer if optimizer is not None else
            lambda params: torch.optim.Adam(params, lr=learning_rate,
                                            capturable=capturable))
        self._state_built = False
        self._health_ema = None

    # -------------------------------------------------------------- health
    def enable_health(self, config=None):
        """Turn on the numeric-health layer (``--health on``; JAX
        ``Engine.enable_health``): the optimizer that ``init_state``
        builds gets the capture of ``observability/health.py``, so every
        later step's metrics carry ``grad_norm``, ``param_norm``,
        ``update_norm``, ``update_ratio``, ``nonfinite_count`` and
        ``loss_spike``, computed on the device.  Must run before
        ``init_state``/the first step.  Returns the config."""
        if self.health is not None:
            return self.health
        if self._state_built:
            raise RuntimeError(
                "enable_health() must run before the engine builds its "
                "step program or initializes state (the optimizer tree "
                "gains capture slots at tx.init)")
        self.health = config if config is not None else hl.HealthConfig()
        return self.health

    def _install_health(self, optimizer) -> None:
        scale = (precisionlib.loss_scale_from(optimizer)
                 if self.precision.loss_scaling else None)
        hl.wrap_optimizer(optimizer, self.health,
                          list(self.model.parameters()),
                          reduce=self._health_reduce, loss_scale=scale)
        self._health_ema = hl.ema_init(self.device)

    def _health_reduce(self, gsq, psq, usq, flags) -> dict:
        """The five captured stats from this rank's per-parameter squared
        norms and non-finite flags (``health.local_stats``), over the
        whole model where ranks hold slices (each leaf's squares weighted
        by ``_norm_weights`` and summed over every rank; a leaf non-finite
        where any rank's slice is, counted once), and as the worst rank's
        norms and ratio and the sum of the counts where ranks hold their
        own copies (``checkpoint_per_rank``).  One gather of this rank's
        values, only over more than one rank."""
        if self.mesh is None or self.mesh.world_size == 1:
            return hl.local_stats(gsq, psq, usq, flags)
        if self.checkpoint_per_rank:
            local = hl.local_stats(gsq, psq, usq, flags)
            row = torch.stack([local[k].float() for k in hl.HEALTH_KEYS[:5]])
            rows = coll.all_gather(row, self.mesh).reshape(-1, 5)
            worst = rows[:, :4].amax(0)
            return {"grad_norm": worst[0], "param_norm": worst[1],
                    "update_norm": worst[2], "update_ratio": worst[3],
                    "nonfinite_count": rows[:, 4].sum().to(torch.int32)}
        if not self.param_specs:
            return hl.local_stats(gsq, psq, usq, flags)
        w = self._norm_w > 0
        sq = torch.stack([torch.where(w, v, torch.zeros_like(v))
                          for v in (gsq, psq, usq)] + [flags.float()])
        every = coll.all_gather(sq, self.mesh).reshape(-1, *sq.shape)
        sums = every[:, :3].sum(0)
        return hl.local_stats(sums[0], sums[1], sums[2],
                              every[:, 3].amax(0) > 0)

    def _health_metrics(self, state: TrainState, metrics: dict) -> dict:
        """The step's health keys: the capture's stats and the loss spike
        against the engine's EMA (updated in place)."""
        stats = hl.from_opt_state(state.optimizer)
        if "loss" in metrics:
            stats["loss_spike"] = hl.ema_update_(
                metrics["loss"], self._health_ema, self.health)
        return stats

    def roofline_model(self):
        """Analytic cost model of this engine's model for ``--roofline``
        (``observability/roofline.py``), or None for families the analytic
        accounting does not cover (CNN, MLP, BERT: their MFU then reports
        None, never a GPT formula applied to another architecture)."""
        return GPTCostModel.from_model(self.model)

    @property
    def stream_words(self) -> tuple[int, ...]:
        """What this rank's dropout stream is seeded from, beside the seed
        (and the step on the CPU): its data index."""
        return (self.rank,)

    @property
    def codec_stream_words(self) -> tuple[int, ...]:
        """What this rank's codec stream is seeded from, beside the seed
        and the codec's tag: the dropout stream's words, as each rank
        quantizes its own value.  The engines whose codec quantizes a
        replicated value return () (one stream for every rank)."""
        return self.stream_words

    # ---------------------------------------------------------------- init
    def init_state(self, generator: torch.Generator,
                   sample_x=None) -> TrainState:
        """Fresh parameters drawn from ``generator`` (a CPU generator:
        ``model.reset_parameters``), stored in the precision policy's
        dtype, a fresh optimizer over them, and a dropout seed drawn from
        ``generator`` (on the card it seeds this rank's dropout stream
        once, ``step_generator``).  Every rank passes a generator seeded alike, so
        every rank starts from the same parameters.  A model with lazy
        layers (MLP, CNN) first takes its input widths from ``sample_x``,
        as flax's ``init`` does."""
        if any(is_lazy(p) for p in self.model.parameters()):
            if sample_x is None:
                raise ValueError(f"{type(self.model).__name__} infers its "
                                 f"input widths: pass sample_x")
            with torch.no_grad():
                self.model(self._put(np.asarray(sample_x[:1])), train=False)
        self.model.reset_parameters(generator)
        self._own_params(self.model)
        # the storage cast comes before the optimizer, which (and a master
        # policy's f32 copy) is built over the parameters the steps train
        self.precision.cast_params(self.model)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        stream = torch.Generator(device=self.device)
        codec_stream = torch.Generator(device=self.device)
        if self.device.type == "cuda":
            stream.manual_seed(_seed_of(seed, *self.stream_words))
            codec_stream.manual_seed(_seed_of(
                seed, *self.codec_stream_words, compression.RNG_TAG))
        optimizer = self.make_optimizer(list(self.model.parameters()))
        inner = precisionlib.strip_master(optimizer)
        if self.param_specs and self.mesh is not None:
            # the weights on the device once: a step reads no host value
            self._norm_w = self._norm_weights()
            if hasattr(inner, "global_norm"):
                inner.global_norm = self._global_norm
        if self.health is not None:
            self._install_health(optimizer)
        self._state_built = True
        return TrainState(step=0, model=self.model, optimizer=optimizer,
                          generator=stream, codec_generator=codec_stream,
                          seed=seed, engine=self)

    def _own_params(self, model: nn.Module) -> None:
        """Hook between the fresh parameters and the optimizer: an engine
        that keeps a slice of them on each rank takes it here (every
        rank's parameters alike otherwise)."""

    # -------------------------------------------------------- sharded leaves
    def _spec(self, name: str) -> tuple:
        return self.param_specs.get(name, ())

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf of which ``t`` (shaped like parameter ``name``'s
        slice) is this rank's slice: gathered along each sharded dim (a
        collective: every rank calls it); a stacked leaf's slices are
        gathered along the dims its spec cuts after the first, then
        stacked along a new leading dim."""
        spec = self._spec(name)
        stacked = name in self.stacked_params
        for dim, axis in spec_axes(spec[1:] if stacked else spec):
            if self.mesh.axis_size(axis) > 1:
                t = coll.all_gather(t.contiguous(), self.mesh, tiled=True,
                                    axis=axis, dim=dim)
        if not stacked:
            return t
        if self.mesh.axis_size(spec[0]) == 1:
            return t.unsqueeze(0)
        return coll.all_gather(t.contiguous(), self.mesh, axis=spec[0])

    def _part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole leaf of parameter ``name`` (of a
        stacked leaf, its index along the leading dim, which must hold
        one slice per rank of the axis, then cut like a leaf)."""
        spec = self._spec(name)
        if name in self.stacked_params:
            axis, spec = spec[0], spec[1:]
            n = self.mesh.axis_size(axis)
            if t.shape[0] != n:
                raise ValueError(
                    f"{name} is stacked over {t.shape[0]} slices, this "
                    f"mesh's '{axis}' axis has {n} ranks")
            t = t[self.mesh.axis_index(axis)]
        for dim, axis in spec_axes(spec):
            n = self.mesh.axis_size(axis)
            w = t.shape[dim] // n
            t = t.narrow(dim, self.mesh.axis_index(axis) * w, w)
        return t

    def _whole_shape(self, name: str, shape) -> tuple:
        spec = self._spec(name)
        stacked = name in self.stacked_params
        shape = list(shape)
        for dim, axis in spec_axes(spec[1:] if stacked else spec):
            shape[dim] *= self.mesh.axis_size(axis)
        if stacked:
            shape.insert(0, self.mesh.axis_size(spec[0]))
        return tuple(shape)

    def full_state_dict(self, state: TrainState) -> dict:
        """The whole model's ``state_dict`` (a collective where the ranks
        hold slices: every rank calls it)."""
        return {k: self._whole(k, v).detach().clone()
                for k, v in state.model.state_dict().items()}

    def load_full_state_dict(self, state: TrainState, full: dict) -> None:
        """Load a whole model's ``state_dict`` into this rank's parameters,
        keeping its slice of each."""
        state.model.load_state_dict(
            {k: self._part(k, v) for k, v in full.items()})

    def _entry_param(self, key: str) -> str | None:
        """The parameter a checkpoint entry belongs to, when it is cut
        like the parameter (``model/``, ``master/``, ``opt/<name>/<key>``)
        and the parameter is sharded; else None."""
        kind, _, rest = key.partition("/")
        name = rest.rsplit("/", 1)[0] if kind == "opt" else rest
        if kind in ("model", "master", "opt") and spec_axes(
                self._spec(name)):
            return name
        return None

    def _roundtrip_whole(self, state: TrainState) -> None:
        """``codec.roundtrip`` of the reduced gradients, with the
        rank-invariant codec stream, over whole leaves (JAX's global
        arrays): a sliced gradient is gathered first and this rank keeps
        its slice of the result."""
        named = [(n, p) for n, p in state.model.named_parameters()
                 if p.grad is not None]
        out = self.grad_codec.roundtrip(
            [self._whole(n, p.grad) for n, p in named],
            generator=self.codec_step_generator(state))
        for (n, p), g in zip(named, out):
            p.grad = self._part(n, g).contiguous()

    def _norm_weights(self) -> torch.Tensor:
        """1 for each parameter (in the optimizer's order) whose squared
        norm this rank adds to the global one: every rank holding a slice
        of it, and of the ranks holding the same value (those differing
        along an axis it is not cut along) the one at index 0 there."""
        coords = dict(zip(self.mesh.axis_names, self.mesh.coords()))
        out = []
        for name, _ in self.model.named_parameters():
            cut = {a for _, a in spec_axes(self._spec(name))}
            out.append(float(all(i == 0 for a, i in coords.items()
                                 if a not in cut)))
        return torch.tensor(out, device=self.device)

    def _global_norm(self, grads: list) -> torch.Tensor:
        """The recipe clip's norm over the whole model (optax's
        ``clip_by_global_norm`` under GSPMD): each parameter's gradient
        norm on this rank (the gradients, or one flat master's cut per
        parameter), weighted by ``_norm_weights``, gathered from every
        rank, and the norm of them all."""
        params = list(self.model.parameters())
        if len(grads) == 1 and len(params) > 1:
            grads = list(grads[0].split([p.numel() for p in params]))
        norms = torch.stack(torch._foreach_norm(grads)).float()
        norms = norms * self._norm_w
        if self.mesh.world_size > 1:
            norms = coll.all_gather(norms, self.mesh)
        return torch.linalg.vector_norm(norms.reshape(-1))

    # ------------------------------------------------------------- batches
    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            # a non-blocking copy is asynchronous only from pinned memory
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def shard_batch(self, x: np.ndarray, y: np.ndarray,
                    mask: np.ndarray | None = None,
                    process_local: bool = False):
        """Place a batch on this rank's device with its leading dim split
        over the ranks, as JAX's ``data_sharding`` splits it: every rank
        passes the same global batch and keeps rows ``[r·B/n, (r+1)·B/n)``.
        ``process_local=True``: the rows given are already this rank's."""
        def put(a):
            if self.mesh is not None and not process_local:
                n, r = self.n_devices, self.rank
                if len(a) % n:
                    raise ValueError(f"batch of {len(a)} rows does not "
                                     f"split over {n} ranks")
                b = len(a) // n
                a = a[r * b:(r + 1) * b]
            return self._put(a)

        if mask is None:
            return put(x), put(y)
        return put(x), put(y), put(mask)

    def step_generator(self, state: TrainState) -> torch.Generator:
        """This step's dropout stream on this rank: the counterpart of
        JAX's ``_per_device_rng``.  On the CPU it is reseeded from (seed,
        step, rank) every step.  On the card it is the rank's Philox
        stream, seeded once from (seed, rank) by ``init_state``, and runs
        on through the steps: a CUDA graph cannot reseed between the steps
        it replays, but a replay advances the generator registered with it
        by what its steps draw (``SyncEngine``'s ``_ChunkGraph``), so the
        steps of an eager chunk and of a replayed one draw the same
        masks."""
        if state.generator.device.type == "cuda":
            return state.generator
        return state.generator.manual_seed(
            _seed_of(state.seed, state.step, *self.stream_words))

    def codec_step_generator(self, state: TrainState) -> torch.Generator:
        """This step's codec rounding stream (JAX ``codec_rng``): on the
        CPU reseeded from (seed, step, ``codec_stream_words``, the codec's
        tag) every step; on the card the Philox stream ``init_state``
        seeded, run on through the steps as ``step_generator``'s is."""
        gen = state.codec_generator
        if gen.device.type == "cuda":
            return gen
        return gen.manual_seed(_seed_of(state.seed, state.step,
                                        *self.codec_stream_words,
                                        compression.RNG_TAG))

    # ---------------------------------------------------------------- step
    def step(self, state: TrainState, x, y):
        """One training step (the subclass's ``_step``); under fp16 loss
        scaling the metrics gain ``loss_scale`` (the scale after the step)
        and ``ls_skipped`` (1 where non-finite gradients skipped it), read
        from the device like the loss (JAX ``_precision_wrap``), and with
        health on the six health keys (JAX ``_health_wrap``)."""
        state, metrics = self._step(state, x, y)
        if self.precision.loss_scaling:
            metrics.update(precisionlib.scale_stats_from(state.optimizer))
        if self.health is not None:
            metrics.update(self._health_metrics(state, metrics))
        return state, metrics

    def _step(self, state: TrainState, x, y):
        raise NotImplementedError

    def many_step(self, state: TrainState, xs_seq, ys_seq):
        """``len(xs_seq)`` steps back to back (the chunk of the Trainer's
        drain): returns the state and each metric stacked over the steps
        on the device, so the host reads the chunk once.  Here eager: the
        JAX package's ``lax.scan`` drain as a Python loop (``SyncEngine``
        replays it as a CUDA graph on the card)."""
        per_step = []
        for x, y in zip(xs_seq, ys_seq):
            state, m = self.step(state, x, y)
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    # ---------------------------------------------------------- checkpoint
    def _checkpoint_entries(self, state: TrainState) -> dict:
        """The live tensors a checkpoint holds, by name: ``model/<key>``
        for every parameter and buffer of the module, and the optimizer's
        state (``precision.optimizer_entries``)."""
        out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
        out.update(precisionlib.optimizer_entries(state.model,
                                                  state.optimizer))
        return out

    def checkpoint_state(self, state: TrainState) -> dict:
        """``state`` as a checkpoint's flat dict: the live tensors of
        ``_checkpoint_entries`` (copy them before the next step changes
        them), ``step``, ``seed``, the policy's name under ``precision``
        and, on the card, the dropout and codec generators' states under
        ``generator/<rank>`` and ``codec_generator/<rank>`` (every rank's,
        one gather).  On the CPU both streams are reseeded from (seed,
        step, rank) every step, so seed and step are all of them."""
        d: dict = dict(self._checkpoint_entries(state))
        for k, v in d.items():
            name = self._entry_param(k)
            if name is not None and v.dim():
                d[k] = self._whole(name, v)
        if state.generator.device.type == "cuda":
            gen = (state.generator.get_state(),
                   state.codec_generator.get_state())
            if self.mesh is not None and self.mesh.world_size > 1:
                gens = [None] * self.mesh.world_size
                torch.distributed.all_gather_object(gens, gen)
            else:
                gens = [gen]
            for r, (g, c) in enumerate(gens):
                d[f"generator/{r}"] = g
                d[f"codec_generator/{r}"] = c
        d.update(step=int(state.step), seed=int(state.seed),
                 precision=self.precision.name)
        return d

    @torch.no_grad()
    def load_checkpoint_state(self, state, d: dict):
        """Copy a checkpoint's dict ``d`` into ``state`` in place and
        return it.  Every tensor of the state must be in ``d`` at its
        shape and dtype, and nothing else: a mismatch raises
        ``ValueError`` before anything is written.  ``state`` may be a
        ``precision.F32Template`` (an f32 run's checkpoint adopted into a
        master policy).  Entries of sliced parameters are whole leaves:
        this rank's slice of each is cut first."""
        d = {k: (self._part(self._entry_param(k), v)
                 if isinstance(v, torch.Tensor) and v.dim()
                 and self._entry_param(k) is not None else v)
             for k, v in d.items()}
        f32 = isinstance(state, precisionlib.F32Template)
        target = state.state if f32 else state
        want = d.get("precision", "f32")
        if not f32 and want != self.precision.name:
            raise ValueError(f"checkpoint written under precision "
                             f"'{want}', this engine runs "
                             f"'{self.precision.name}'")
        if f32 and want != "f32":
            raise ValueError(f"an f32 template reads f32 checkpoints, "
                             f"this one was written under '{want}'")
        if any(k.startswith("opt/") for k in d):
            precisionlib.materialize_optimizer_state(target.optimizer)
        if f32:
            layout = precisionlib.f32_layout(target)
        else:
            live = self._checkpoint_entries(target)
            layout = {k: (v.shape, v.dtype) for k, v in live.items()}
        got = {k for k, v in d.items() if isinstance(v, torch.Tensor)
               and not k.startswith(("generator/", "codec_generator/"))}
        missing, extra = sorted(set(layout) - got), sorted(got - set(layout))
        if missing or extra:
            raise ValueError(f"checkpoint does not match this state's "
                             f"layout: missing {missing[:8]}, unexpected "
                             f"{extra[:8]}")
        for k, (shape, dtype) in layout.items():
            if d[k].shape != shape or d[k].dtype != dtype:
                raise ValueError(
                    f"checkpoint entry {k} is {d[k].dtype} "
                    f"{tuple(d[k].shape)}, this state's is {dtype} "
                    f"{tuple(shape)}")
        if f32:
            precisionlib.adopt_f32_checkpoint(target, d, self.precision)
        else:
            for k, t in live.items():
                t.copy_(d[k])
        target.step, target.seed = int(d["step"]), int(d["seed"])
        rank = self.mesh.rank if self.mesh is not None else 0
        if target.generator.device.type == "cuda":
            for name in ("generator", "codec_generator"):
                gen = d.get(f"{name}/{rank}")
                if gen is not None:
                    getattr(target, name).set_state(gen)
        return target

    # --------------------------------------------------------------- bytes
    def _exchanged_leaves(self, state: TrainState) -> list:
        """What one gradient exchange moves, leaf by leaf (anything with
        ``.shape`` and ``.dtype``): the parameters (gradients share their
        shapes and dtypes), a sliced one at its whole shape (JAX's global
        leaves)."""
        return [p if not spec_axes(self._spec(n)) else
                torch.empty(self._whole_shape(n, p.shape), dtype=p.dtype,
                            device="meta")
                for n, p in state.model.named_parameters()]

    def grad_collective_bytes_raw(self, state: TrainState) -> int:
        """Uncompressed bytes of one gradient collective round, from the
        parameters' real dtypes (0 without a state)."""
        if state is None:
            return 0
        return int(sum(compression._numel(a.shape) * a.dtype.itemsize
                       for a in self._exchanged_leaves(state)))

    def grad_collective_bytes(self, state: TrainState) -> int:
        """Wire bytes of one gradient collective round under the codec
        (bf16 halves the raw figure, int8 is one byte an element plus 4
        per leaf or per bucket).  On the sync, async and gossip engines it
        is what the collective moves; on the sequence- and
        expert-parallel engines, whose all-reduce stays exact and whose
        codec is a roundtrip, it is the codec's accounting."""
        if state is None:
            return 0
        return self.grad_codec.wire_bytes(self._exchanged_leaves(state))

    def param_bytes_per_device(self, state: TrainState) -> int:
        """This rank's parameter bytes: what 16-bit storage halves."""
        return sum(p.numel() * p.element_size()
                   for p in state.model.parameters())

    def opt_state_bytes_per_device(self, state: TrainState) -> int:
        """This rank's optimizer-state bytes: a master policy adds the f32
        copy, the pure ``bf16`` policy halves the moments."""
        return precisionlib.optimizer_state_bytes(state.optimizer)

    # ---------------------------------------------------------------- eval
    def eval_params(self, state: TrainState) -> nn.Module:
        """The module to evaluate with (one device: the trained one), and
        the one sampling and serving decode."""
        return state.model

    def _eval_module(self, state: TrainState) -> nn.Module:
        """The module ``evaluate`` runs on this rank's rows: the
        ``eval_params`` one (an engine whose evaluation runs its bound,
        sliced model returns the state's own)."""
        return self.eval_params(state)

    def _reduce_totals(self, totals: torch.Tensor) -> None:
        """Sum the evaluation's (correct, loss, count) over the ranks, in
        place."""
        coll.all_reduce_(totals, self.mesh)

    @torch.no_grad()
    def evaluate(self, state: TrainState, dataset,
                 batch_size: int = 100) -> dict:
        """Full-test-set eval: accuracy and loss per valid label element,
        padded rows of the last batch masked out.  Over a mesh the batch
        rounds down to a multiple of the ranks, each rank evaluates its
        rows, and one collective sums the three totals."""
        model = self._eval_module(state)
        n = self.n_devices
        bs = (max(batch_size, n) // n) * n
        correct = loss_sum = count = torch.zeros((), device=self.device)
        for bx, by, bm in dataset.batches(bs, shuffle=False):
            x, y, m = self.shard_batch(bx, by, bm)
            logits = model(x, train=False)
            w = token_weights(m, y)
            correct = correct + ((logits.argmax(-1) == y) * w).sum()
            loss_sum = loss_sum + (cross_entropy(logits, y) * w).sum()
            count = count + w.sum()
        totals = torch.stack([correct, loss_sum, count])
        if self.mesh is not None:
            self._reduce_totals(totals)
        tot_correct, tot_loss, tot_count = totals.tolist()
        return {
            "accuracy": tot_correct / max(tot_count, 1.0),
            "loss": tot_loss / max(tot_count, 1.0),
            "count": int(tot_count),
        }
