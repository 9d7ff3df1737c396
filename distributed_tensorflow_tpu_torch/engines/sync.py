"""Sync data-parallel engine (port of ``engines/sync.py``).

Each rank differentiates ``loss / (n·K)`` over its rows of the global
batch (n ranks, K microbatches), so the sum of the gradients over ranks
and microbatches is the global-batch mean.  After all K microbatches the
gradients are packed into one flat buffer and ONE all-reduce sums it; each
``.grad`` then becomes a view of its slice, and every rank applies the
same optimizer update.  The metrics come out as the mean over ranks (JAX
``sync.py:158``).  Without a mesh (n = 1) there is no collective.

With f32 parameters the step's loss and accuracy ride in two slots at the
end of the gradient buffer.  Under a 16-bit precision policy the gradients
are 16-bit, so the buffer moves 2 bytes per parameter (JAX
``precision.py:53-56``), and the two metrics go through a second
all-reduce of their own, in f32, so that they lose no precision.  Under
fp16 loss scaling the differentiated loss is ``loss · scale / (n·K)``
with the scale the step entered with; the reported loss is unscaled (JAX
``sync.py:60-66, 89-95``).

On the card ``many_step`` runs a chunk of k > 1 steps as a CUDA graph
(``_ChunkGraph``): the JAX drain is one compiled ``lax.scan`` per chunk,
and the port's eager chunk is bound by the host's dispatch of its
kernels.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, make_loss_fn)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import precision as precisionlib


def _launch_counters() -> list[tuple[object, str]]:
    """Every launch counter a train step can move: (holder, attribute)."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    return [(fn, name)
            for fn in (coll.all_reduce_, fa.flash_attention)
            for name in sorted(vars(fn)) if name.endswith("launches")]


class _ChunkGraph:
    """A chunk of k steps of one ``TrainState`` captured as one CUDA
    graph, with the static buffers it reads (the k batches) and writes
    (the stacked metrics).  The graph reads and writes that state's
    tensors (parameters, optimizer state, the dropout generator registered
    with it), so it replays for that state only.  A replay copies the
    staged batches into the static buffers and launches the graph, which
    advances the dropout generator by what its steps draw; the launch
    counters then move by what the capture recorded, since the capture
    itself launched nothing.  ``captures`` and ``replays`` count the
    class's graphs and launches of them, in every engine."""

    captures = 0
    replays = 0

    def __init__(self, engine: "SyncEngine", state: TrainState, xs, ys):
        self.state = state
        self.xs = [x.clone() for x in xs]
        self.ys = [y.clone() for y in ys]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        counters = _launch_counters()
        before = [getattr(fn, name) for fn, name in counters]
        host_step = state.step
        try:
            # thread-local: the capture forbids unsafe calls to this thread
            # only, not to the NCCL watchdog's or the autograd engine's
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                _, self.metrics = Engine.many_step(engine, state, self.xs,
                                                   self.ys)
        finally:
            state.step = host_step
            self.counts = []
            for (fn, name), was in zip(counters, before):
                self.counts.append((fn, name, getattr(fn, name) - was))
                setattr(fn, name, was)
        _ChunkGraph.captures += 1

    def replay(self, state: TrainState, xs, ys):
        if state is not self.state:
            raise ValueError("this chunk's CUDA graph was captured for "
                             "another TrainState")
        for static, x in zip(self.xs + self.ys, list(xs) + list(ys)):
            static.copy_(x)
        self.graph.replay()
        _ChunkGraph.replays += 1
        state.step += len(self.xs)
        for fn, name, n in self.counts:
            setattr(fn, name, getattr(fn, name) + n)
        return state, {k: v.clone() for k, v in self.metrics.items()}


class SyncEngine(Engine):
    """``grad_accum`` K > 1 splits each rank's rows into K microbatches and
    accumulates their gradients before the one reduce and optimizer
    update: the same update as K = 1 on the same batch, with about 1/K of
    the activation memory."""

    supports_loss_scaling = True
    captures_chunks = True

    def __init__(self, *args, grad_accum: int = 1, **kw):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        super().__init__(*args, **kw)
        self.grad_accum = grad_accum
        # the ranks whose summed gradients make the global-batch mean
        self.reduce_n = self.n_devices
        self._graphs: dict[tuple, _ChunkGraph] = {}
        self._eager_chunks: set[tuple] = set()

    def init_state(self, *args, **kw) -> TrainState:
        """``Engine.init_state``; the graphs of an earlier state (which
        replay that state's tensors) are dropped, and the new state's
        chunks warm up and are captured anew."""
        self._graphs.clear()
        self._eager_chunks.clear()
        return super().init_state(*args, **kw)

    def _step(self, state: TrainState, x, y):
        """One training step on this rank's rows ``x``, ``y``.  Updates
        ``state`` IN PLACE (its module's parameters, its optimizer state
        and ``step``) and returns ``(state, metrics)`` as the JAX engine
        does; ``metrics`` holds the global batch's mean ``loss`` and
        ``accuracy`` as 0-dim device tensors, so no host sync happens
        here."""
        k, n = self.grad_accum, self.reduce_n
        if x.shape[0] % k:
            raise ValueError(f"per-device batch {x.shape[0]} not divisible "
                             f"by grad_accum {k}")
        loss_fn = make_loss_fn(state.model)
        gen = self.step_generator(state)
        # the entering state's loss scale (fp16-f32master), else None
        ls = (precisionlib.loss_scale_from(state.optimizer)
              if self.precision.loss_scaling else None)
        state.optimizer.zero_grad(set_to_none=True)
        if k == 1:
            loss, acc = loss_fn(x, y, gen)
            if ls is not None:
                (loss * ls / n).backward()
            else:
                (loss / n if n > 1 else loss).backward()
        else:
            loss = acc = 0.0
            for xc, yc in zip(x.chunk(k), y.chunk(k)):
                lc, ac = loss_fn(xc, yc, gen)
                ((lc if ls is None else lc * ls) / (n * k)).backward()
                loss, acc = loss + lc.detach(), acc + ac
            loss, acc = loss / k, acc / k
        loss, acc = loss.detach(), acc.detach()
        if self.mesh is not None:
            loss, acc = self._all_reduce(state.model, loss, acc) / n
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc}

    def _all_reduce(self, model, loss, acc) -> torch.Tensor:
        """Sum every gradient over the ranks with one collective, and the
        two metrics with it (f32 gradients) or in a second f32 one (16-bit
        gradients); returns the summed (loss, accuracy)."""
        params = list(model.parameters())
        metrics = torch.stack([loss, acc])
        packed = all(p.dtype == metrics.dtype for p in params)
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params] + ([metrics] if packed else []))
        coll.all_reduce_(flat, self.mesh)
        off = 0
        for p in params:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        if packed:
            return flat[off:]
        return coll.all_reduce_(metrics, self.mesh)

    def many_step(self, state: TrainState, xs_seq, ys_seq):
        """``Engine.many_step``; on the card, for k > 1, as a CUDA graph
        per (k, batch shapes): the first chunk of a shape runs eagerly on
        a side stream (it creates what a capture must find in place: the
        optimizer state, the library handles, the NCCL communicator), the
        second is captured and replayed, and every later one replays the
        graph.  Eager and replayed chunks run the same kernels on the same
        values, dropout masks included, so they agree bitwise.  A capture
        or replay that fails raises, as does a chunk of a state other than
        the one the graph was captured for."""
        k = len(xs_seq)
        if k == 1 or self.device.type != "cuda":
            return super().many_step(state, xs_seq, ys_seq)
        key = (k, *((tuple(t.shape), t.dtype) for t in (*xs_seq, *ys_seq)))
        chunk = self._graphs.get(key)
        if chunk is None:
            if key not in self._eager_chunks:
                self._eager_chunks.add(key)
                return self._warm_up(state, xs_seq, ys_seq)
            chunk = self._graphs[key] = _ChunkGraph(self, state, xs_seq,
                                                    ys_seq)
        return chunk.replay(state, xs_seq, ys_seq)

    def _warm_up(self, state: TrainState, xs_seq, ys_seq):
        """The eager chunk before a capture, on a side stream as PyTorch's
        CUDA-graph recipe warms up; the caller's stream waits for it."""
        here = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            state, metrics = super().many_step(state, xs_seq, ys_seq)
        here.wait_stream(side)
        for v in metrics.values():
            v.record_stream(here)
        return state, metrics
