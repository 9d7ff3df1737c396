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
graph; the others keep the plain default.  The gradient codecs,
bucketing and the health layer are not ported and raise
``NotImplementedError``.

``checkpoint_state``/``load_checkpoint_state`` turn a ``TrainState`` into
the flat dict a checkpoint holds (``utils/checkpoint.py``) and back, in
place: every tensor is copied into the live one (``copy_``), so a CUDA
graph captured over the state and ``MasterWeights``' flat views stay
valid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import is_lazy

from distributed_tensorflow_tpu_torch import not_ported, resolve_device
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import precision as precisionlib
from distributed_tensorflow_tpu_torch.parallel.mesh import DATA_AXIS


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState`` (step, params, opt_state, rng) as live
    objects: ``model`` holds the parameters, ``optimizer`` the optimizer
    state (a ``MasterWeights`` under a master policy), ``generator`` the
    stream on the device that dropout draws from
    (``Engine.step_generator``).  Engines update it in place."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
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
                      axis: str | None = None) -> torch.Tensor | None:
    """Sum the gradients of ``params`` over ``axis`` of ``mesh`` (None:
    every rank) with one all-reduce of a flat buffer; each ``.grad`` then
    becomes a view of its slice.  ``metrics`` (an f32 vector) rides behind
    f32 gradients, and goes in an f32 all-reduce of its own behind 16-bit
    ones; returns the summed metrics (None without)."""
    packed = metrics is not None and all(p.dtype == metrics.dtype
                                         for p in params)
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params] + ([metrics] if packed else []))
    coll.all_reduce_(flat, mesh, axis=axis)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    if metrics is None:
        return None
    if packed:
        return flat[off:]
    return coll.all_reduce_(metrics, mesh, axis=axis)


def make_loss_fn(model: nn.Module) -> Callable:
    """``loss_fn(x, y, generator) -> (mean loss, mean accuracy)`` over every
    label element, with the model in training mode (dropout on)."""

    def loss_fn(x, y, generator):
        logits = model(x, train=True, generator=generator)
        loss = cross_entropy(logits, y).mean()
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, acc

    return loss_fn


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

    def __init__(self, model, optimizer: Callable | None = None, mesh=None,
                 learning_rate: float = 1e-3, grad_compression: str = "none",
                 grad_bucket_mb: float = 0.0, precision: str = "f32",
                 device=None):
        if grad_compression != "none":
            not_ported(f"grad_compression={grad_compression!r}",
                       "remaining engines")
        if grad_bucket_mb:
            not_ported("grad_bucket_mb > 0 (bucketed overlap)",
                       "remaining engines")
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

    @property
    def stream_words(self) -> tuple[int, ...]:
        """What this rank's dropout stream is seeded from, beside the seed
        (and the step on the CPU): its data index."""
        return (self.rank,)

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
        if self.device.type == "cuda":
            stream.manual_seed(_seed_of(seed, *self.stream_words))
        return TrainState(step=0, model=self.model,
                          optimizer=self.make_optimizer(
                              list(self.model.parameters())),
                          generator=stream, seed=seed, engine=self)

    def _own_params(self, model: nn.Module) -> None:
        """Hook between the fresh parameters and the optimizer: an engine
        that keeps a slice of them on each rank takes it here (every
        rank's parameters alike otherwise)."""

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

    # ---------------------------------------------------------------- step
    def step(self, state: TrainState, x, y):
        """One training step (the subclass's ``_step``); under fp16 loss
        scaling the metrics gain ``loss_scale`` (the scale after the step)
        and ``ls_skipped`` (1 where non-finite gradients skipped it), read
        from the device like the loss (JAX ``_precision_wrap``)."""
        state, metrics = self._step(state, x, y)
        if self.precision.loss_scaling:
            metrics.update(precisionlib.scale_stats_from(state.optimizer))
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
        and, on the card, the dropout generator's state under
        ``generator/<rank>`` (every rank's, one gather).  On the CPU the
        stream is reseeded from (seed, step, rank) every step, so seed and
        step are all of it."""
        d: dict = dict(self._checkpoint_entries(state))
        if state.generator.device.type == "cuda":
            gen = state.generator.get_state()
            if self.mesh is not None and self.mesh.world_size > 1:
                gens = [None] * self.mesh.world_size
                torch.distributed.all_gather_object(gens, gen)
            else:
                gens = [gen]
            for r, g in enumerate(gens):
                d[f"generator/{r}"] = g
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
        master policy)."""
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
               and not k.startswith("generator/")}
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
        gen = d.get(f"generator/{rank}")
        if gen is not None and target.generator.device.type == "cuda":
            target.generator.set_state(gen)
        return target

    # --------------------------------------------------------------- bytes
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
        """The module to evaluate with (one device: the trained one)."""
        return state.model

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
        model = self.eval_params(state)
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
