"""Sync data-parallel engine (port of ``engines/sync.py`` on one device).

The JAX step differentiates ``loss / (n·K)`` so the cross-device and
cross-microbatch sum of gradients is the global-batch mean, then applies
one optimizer update.  On one device (n = 1) that is: K = 1, one backward
of the mean loss; K > 1, the batch split into K equal microbatches whose
``loss / K`` gradients accumulate before the single update — the same
math as ``sync.py``'s accumulation scan.  Multi-GPU sync over
``torch.distributed`` is later work (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, make_loss_fn)


class SyncEngine(Engine):
    """``grad_accum`` K > 1 splits each batch into K microbatches and
    accumulates their gradients before the one optimizer update: the same
    update as K = 1 on the same batch, with about 1/K of the activation
    memory."""

    def __init__(self, *args, grad_accum: int = 1, **kw):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        super().__init__(*args, **kw)
        self.grad_accum = grad_accum

    def step(self, state: TrainState, x, y):
        """One training step.  Updates ``state`` IN PLACE (its module's
        parameters, its optimizer state, its generator and ``step``) and
        returns ``(state, metrics)`` as the JAX engine does; ``metrics``
        holds the batch's mean ``loss`` and ``accuracy`` as 0-dim device
        tensors (averaged over the K microbatches), so no host sync
        happens here."""
        k = self.grad_accum
        if x.shape[0] % k:
            raise ValueError(f"per-device batch {x.shape[0]} not divisible "
                             f"by grad_accum {k}")
        loss_fn = make_loss_fn(state.model)
        state.optimizer.zero_grad(set_to_none=True)
        if k == 1:
            loss, acc = loss_fn(x, y, state.generator)
            loss.backward()
        else:
            loss = acc = 0.0
            for xc, yc in zip(x.chunk(k), y.chunk(k)):
                lc, ac = loss_fn(xc, yc, state.generator)
                (lc / k).backward()
                loss, acc = loss + lc.detach(), acc + ac
            loss, acc = loss / k, acc / k
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": acc.detach()}
