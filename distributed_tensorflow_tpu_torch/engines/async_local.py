"""Local SGD with periodic parameter averaging (port of
``engines/async_local.py``): the reference's async parameter server as the
JAX package renders it on a mesh.

Every rank keeps its own parameters and optimizer state, takes the plain
gradient of its own rows (not scaled by ``1/n``: JAX's device
differentiates its own loss), applies its own optimizer step, and every
``sync_every`` steps the ranks replace their parameters by their mean.
The JAX engine stacks the per-device states on a leading device axis; here
each process holds its row, so rank r's module is JAX's row r.

One collective per step, on a mesh of any size, a group of one included:
on a sync step every parameter and the step's loss and accuracy go in one
flat buffer through one all-reduce; on the other steps only the two
metrics (JAX means them every step).  The optimizer state is never
averaged.  Whether a step syncs is a host-side int, so no device sync.

``eval_params`` returns a separate module holding the ranks' mean (one
all-reduce): local SGD goes on from the unaveraged copies, as JAX's
``eval_params`` returns a new tree.

With a codec or bucketing active (``compression.codec_active``) the
parameter mean of a sync step goes through ``codec.all_reduce_mean`` with
this rank's codec stream (each rank quantizes its own copy, JAX
``async_local.py:95-122``), and the loss and accuracy through an f32
all-reduce of their own.  The wire bytes are those of one copy of the
parameters.

Precision: the bf16 policies apply; ``fp16-f32master`` raises, as in JAX
(this engine does not multiply its loss by a scale).  The mean replaces
the STORED parameters, exactly as JAX's ``pmean`` of ``params`` does, and
a master policy's f32 master is never averaged: the next step's
``MasterWeights`` writes ``cast(master')`` of each rank's own master back
into the parameters, so the average is lost there, as it is in the JAX
engine (JAX ``precision.py:261-265``).  With 16-bit parameters the mean
is taken over their f32 widening (one buffer with the f32 metrics) and
rounded once on the way back.

The drained chunk stays eager (``Engine.many_step``) by design: whether a
step carries the parameter mean depends on ``step % sync_every``, so the
place of the collective inside a chunk moves from chunk to chunk, and one
captured graph per phase is not worth it at one collective per step.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, make_loss_fn)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import compression


def _pack(model: nn.Module, *extra: torch.Tensor) -> torch.Tensor:
    """Every parameter of ``model`` and then ``extra`` in one flat buffer
    (a copy; f32 when ``extra``'s f32 metrics join 16-bit parameters)."""
    parts = [p.detach().reshape(-1) for p in model.parameters()]
    if extra:
        parts.append(torch.stack(extra))
    return torch.cat(parts)


@torch.no_grad()
def _unpack(model: nn.Module, flat: torch.Tensor) -> torch.Tensor:
    """Copy the leading slices of ``flat`` into ``model``'s parameters;
    returns what follows them."""
    off = 0
    for p in model.parameters():
        p.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()
    return flat[off:]


class AsyncLocalEngine(Engine):
    # the ranks' parameters and optimizer states differ between averages:
    # a checkpoint holds each rank's (JAX saves the per-device stacked
    # state) and restores onto the rank count that wrote it
    checkpoint_per_rank = True

    def __init__(self, *args, sync_every: int = 10, **kw):
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        super().__init__(*args, **kw)
        self.sync_every = sync_every

    def _local_step(self, state: TrainState, x, y):
        """Loss, backward and optimizer step on this rank's rows alone;
        returns the detached local (loss, accuracy)."""
        loss_fn = make_loss_fn(state.model)
        gen = self.step_generator(state)
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(x, y, gen)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach(), acc.detach()

    def _mean_params_and(self, state: TrainState, loss, acc):
        """Replace the state's parameters by the ranks' mean, and mean the
        metrics: with one all-reduce at the plain codec, else the codec's
        mean of the parameters and an f32 all-reduce of the metrics;
        returns the mean (loss, accuracy)."""
        model = state.model
        if not compression.codec_active(self.grad_codec):
            flat = coll.all_reduce_(_pack(model, loss, acc), self.mesh)
            flat /= self.n_devices
            return _unpack(model, flat)
        params = list(model.parameters())
        mean = self.grad_codec.all_reduce_mean(
            [p.detach() for p in params], self.mesh,
            generator=self.codec_step_generator(state))
        with torch.no_grad():
            for p, m in zip(params, mean):
                p.copy_(m)
        return self._mean_metrics(loss, acc)

    def _mean_metrics(self, loss, acc) -> torch.Tensor:
        metrics = coll.all_reduce_(torch.stack([loss, acc]), self.mesh)
        return metrics / self.n_devices

    def _step(self, state: TrainState, x, y):
        """One local step on this rank's rows, then the step's one
        collective.  Updates ``state`` IN PLACE and returns ``(state,
        metrics)``, the metrics the ranks' mean as 0-dim device tensors."""
        loss, acc = self._local_step(state, x, y)
        if self.mesh is not None:
            if state.step % self.sync_every == 0:
                loss, acc = self._mean_params_and(state, loss, acc)
            else:
                loss, acc = self._mean_metrics(loss, acc)
        return state, {"loss": loss, "accuracy": acc}

    def eval_params(self, state: TrainState) -> nn.Module:
        """The consensus model: a copy of the module holding the mean of
        the ranks' parameters (one all-reduce); the training module keeps
        its local parameters."""
        if self.mesh is None:
            return state.model
        model = copy.deepcopy(state.model)
        flat = coll.all_reduce_(_pack(model), self.mesh)
        _unpack(model, flat / self.n_devices)
        return model
