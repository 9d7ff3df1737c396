"""Sync data-parallel engine (port of ``engines/sync.py``).

Each rank differentiates ``loss / (n·K)`` over its rows of the global
batch (n ranks, K microbatches), so the sum of the gradients over ranks
and microbatches is the global-batch mean.  After all K microbatches the
gradients are packed into one flat buffer, with the step's loss and
accuracy in two slots at its end, and ONE all-reduce sums it; each
``.grad`` then becomes a view of its slice, and every rank applies the
same optimizer update.  The metrics come out as the mean over ranks (JAX
``sync.py:158``).  Without a mesh (n = 1) there is no collective.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, make_loss_fn)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll


class SyncEngine(Engine):
    """``grad_accum`` K > 1 splits each rank's rows into K microbatches and
    accumulates their gradients before the one reduce and optimizer
    update: the same update as K = 1 on the same batch, with about 1/K of
    the activation memory."""

    def __init__(self, *args, grad_accum: int = 1, **kw):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        super().__init__(*args, **kw)
        self.grad_accum = grad_accum

    def step(self, state: TrainState, x, y):
        """One training step on this rank's rows ``x``, ``y``.  Updates
        ``state`` IN PLACE (its module's parameters, its optimizer state
        and ``step``) and returns ``(state, metrics)`` as the JAX engine
        does; ``metrics`` holds the global batch's mean ``loss`` and
        ``accuracy`` as 0-dim device tensors, so no host sync happens
        here."""
        k, n = self.grad_accum, self.n_devices
        if x.shape[0] % k:
            raise ValueError(f"per-device batch {x.shape[0]} not divisible "
                             f"by grad_accum {k}")
        loss_fn = make_loss_fn(state.model)
        gen = self.step_generator(state)
        state.optimizer.zero_grad(set_to_none=True)
        if k == 1:
            loss, acc = loss_fn(x, y, gen)
            (loss / n if n > 1 else loss).backward()
        else:
            loss = acc = 0.0
            for xc, yc in zip(x.chunk(k), y.chunk(k)):
                lc, ac = loss_fn(xc, yc, gen)
                (lc / (n * k)).backward()
                loss, acc = loss + lc.detach(), acc + ac
            loss, acc = loss / k, acc / k
        loss, acc = loss.detach(), acc.detach()
        if self.mesh is not None:
            loss, acc = self._all_reduce(state.model, loss, acc) / n
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc}

    def _all_reduce(self, model, loss, acc) -> torch.Tensor:
        """Sum every gradient and the two metrics over the ranks with one
        collective; returns the summed (loss, accuracy)."""
        params = list(model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params] + [torch.stack([loss, acc])])
        coll.all_reduce_(flat, self.mesh)
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        return flat[off:]
