"""Gossip data parallelism over a ring (port of ``engines/gossip.py``).

The reference declares its ``graph`` and ``custom`` decentralized
strategies and a ``-d`` node degree but never implements them; the JAX
package does: each device trains locally (``AsyncLocalEngine``'s step)
and, every ``mix_every`` steps, replaces its parameters by the mean of
its own and its ``degree`` nearest ring neighbours' on each side.  Here
the parameters go as one flat buffer through ``collectives.neighbor_mean``
(``2·degree`` point-to-point exchanges per mix), then the step's loss and
accuracy through one all-reduce.  Where the neighbourhood covers the ring
(``2·degree + 1 >= n``, every run on one card included) the mix is the
full mean, and parameters and metrics share one all-reduce.  A ring mix
runs in the stored parameters' dtype, as JAX's does; precision and the
eager drain as in ``AsyncLocalEngine``.  With a codec or bucketing active
the mix is ``codec.neighbor_mean`` with this rank's codec stream (JAX
``gossip.py:37-57``; at a covering neighbourhood the codec's mean), and
the metrics go in an f32 all-reduce of their own.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.engines.async_local import (
    AsyncLocalEngine, _pack, _unpack)
from distributed_tensorflow_tpu_torch.engines.base import TrainState
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import compression


class GossipEngine(AsyncLocalEngine):
    def __init__(self, *args, degree: int = 1, mix_every: int = 1, **kw):
        kw.setdefault("sync_every", 1 << 30)  # no global sync; gossip only
        if mix_every < 1:
            raise ValueError(f"mix_every must be >= 1, got {mix_every}")
        super().__init__(*args, **kw)
        self.degree = degree
        self.mix_every = mix_every

    def _step(self, state: TrainState, x, y):
        """One local step, then on a mix step the ring mix of the
        parameters; the metrics come out as the ranks' mean."""
        loss, acc = self._local_step(state, x, y)
        if self.mesh is None:
            return state, {"loss": loss, "accuracy": acc}
        mix = self.degree > 0 and state.step % self.mix_every == 0
        if mix and compression.codec_active(self.grad_codec):
            params = list(state.model.parameters())
            mixed = self.grad_codec.neighbor_mean(
                [p.detach() for p in params], self.mesh, self.degree,
                generator=self.codec_step_generator(state))
            with torch.no_grad():
                for p, m in zip(params, mixed):
                    p.copy_(m)
            loss, acc = self._mean_metrics(loss, acc)
        elif mix and 2 * self.degree + 1 >= self.n_devices:
            loss, acc = self._mean_params_and(state, loss, acc)
        else:
            if mix:
                _unpack(state.model, coll.neighbor_mean(
                    _pack(state.model), self.mesh, self.degree))
            loss, acc = self._mean_metrics(loss, acc)
        return state, {"loss": loss, "accuracy": acc}
