"""Shared engine machinery: TrainState, loss, eval, batch placement (port of
``engines/base.py`` for one device).

The JAX engines are jitted SPMD programs over a mesh with a pure
``TrainState`` value.  The port runs eagerly on one device: the state holds
the live ``nn.Module`` and ``torch.optim`` optimizer, and a step updates
them in place.  Multi-GPU sync over ``torch.distributed``, the gradient
codecs, bucketing, mixed-precision policies and the health layer are later
work (ROADMAP Queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import not_ported, resolve_device

_MULTI_GPU = "training with the CNN/MLP sync path"
_ENGINES = "remaining engines"


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState`` (step, params, opt_state, rng) as live
    objects: ``model`` holds the parameters, ``optimizer`` the optimizer
    state, ``generator`` the random stream dropout draws from.  Engines
    update it in place."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator


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
    """Base: owns model, optimizer factory and device; subclasses implement
    ``step``.

    ``optimizer`` is a callable ``params -> torch.optim.Optimizer``; the
    default ``torch.optim.Adam(lr=learning_rate)`` is the counterpart of the
    JAX default ``optax.adam(learning_rate)`` (same betas, eps 1e-8 outside
    the square root, same bias correction; the two round differently).
    ``device=None`` means the CUDA card; the model is moved there."""

    def __init__(self, model, optimizer: Callable | None = None, mesh=None,
                 learning_rate: float = 1e-3, grad_compression: str = "none",
                 grad_bucket_mb: float = 0.0, precision: str = "f32",
                 device=None):
        if mesh is not None:
            not_ported("a device mesh (multi-GPU sync over "
                       "torch.distributed)", _MULTI_GPU)
        if grad_compression != "none":
            not_ported(f"grad_compression={grad_compression!r}", _ENGINES)
        if grad_bucket_mb:
            not_ported("grad_bucket_mb > 0 (bucketed overlap)", _ENGINES)
        if precision != "f32":
            not_ported(f"precision={precision!r}", _ENGINES)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.make_optimizer = (optimizer if optimizer is not None else
                               lambda params: torch.optim.Adam(
                                   params, lr=learning_rate))

    # ---------------------------------------------------------------- init
    def init_state(self, generator: torch.Generator,
                   sample_x=None) -> TrainState:
        """Fresh parameters drawn from ``generator`` (a CPU generator:
        ``model.reset_parameters``), a fresh optimizer over them, and a
        dropout generator on the device seeded from ``generator``.
        ``sample_x`` is accepted for the JAX signature; a module's shapes do
        not depend on it."""
        del sample_x
        self.model.reset_parameters(generator)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        dropout = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(step=0, model=self.model,
                          optimizer=self.make_optimizer(
                              self.model.parameters()),
                          generator=dropout)

    # ------------------------------------------------------------- batches
    def shard_batch(self, x: np.ndarray, y: np.ndarray,
                    mask: np.ndarray | None = None):
        """Move a host batch to the engine's device (one device: no split)."""
        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        if mask is None:
            return put(x), put(y)
        return put(x), put(y), put(mask)

    # ---------------------------------------------------------------- step
    def step(self, state: TrainState, x, y):
        raise NotImplementedError

    # ---------------------------------------------------------------- eval
    def eval_params(self, state: TrainState) -> nn.Module:
        """The module to evaluate with (one device: the trained one)."""
        return state.model

    @torch.no_grad()
    def evaluate(self, state: TrainState, dataset,
                 batch_size: int = 100) -> dict:
        """Full-test-set eval: accuracy and loss per valid label element,
        padded rows of the last batch masked out."""
        model = self.eval_params(state)
        correct = loss_sum = count = torch.zeros((), device=self.device)
        for bx, by, bm in dataset.batches(batch_size, shuffle=False):
            x, y, m = self.shard_batch(bx, by, bm)
            logits = model(x, train=False)
            w = token_weights(m, y)
            correct = correct + ((logits.argmax(-1) == y) * w).sum()
            loss_sum = loss_sum + (cross_entropy(logits, y) * w).sum()
            count = count + w.sum()
        tot_correct, tot_loss, tot_count = (float(t) for t in
                                            (correct, loss_sum, count))
        return {
            "accuracy": tot_correct / max(tot_count, 1.0),
            "loss": tot_loss / max(tot_count, 1.0),
            "count": int(tot_count),
        }
