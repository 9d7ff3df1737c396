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

With a gradient codec or bucketing (``compression.codec_active``) the
step is the counterpart of JAX ``_build_step_compressed``
(``_codec_step``): the loss is scaled by ``1/(n·K)`` (times the entering
loss scale under ``fp16-f32master``), the gradients go through
``codec.all_reduce_sum`` with this rank's codec stream, and the loss and
accuracy go in an f32 all-reduce of their own, never through the codec.
A bucketed codec reduces each bucket as soon as the backward pass has
produced every gradient in it (``_BucketReducer``: post-accumulate-grad
hooks), on a side stream on the card, and with K > 1 reduces each
microbatch's buckets as its backward produces them, summing the K
reduced gradients.  Buckets are launched in plan order on every rank, so
the ranks' collectives pair up whatever order the hooks fire in.  At
``none`` without bucketing the step is the flat-buffer program above,
unchanged.
"""

from __future__ import annotations

import gc

import torch

from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, all_reduce_grads_, make_loss_fn)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import compression
from distributed_tensorflow_tpu_torch.parallel import overlap
from distributed_tensorflow_tpu_torch.parallel import precision as precisionlib


def _launch_counters() -> list[tuple[object, str]]:
    """Every launch counter a train step can move: (holder, attribute)."""
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    return [(fn, name)
            for fn in (coll.all_reduce_, compression.all_to_all_,
                       compression.all_gather_, coll.gather_shards,
                       coll.copy_to_model, coll.reduce_from_model,
                       coll.gather_from_model, fa.flash_attention)
            for name in sorted(vars(fn)) if name.endswith("launches")]


class _BucketReducer:
    """The bucketed exchange of one step: each bucket of ``codec``'s plan
    over ``params`` is packed, reduced by the inner codec and added into
    its sum as soon as the backward pass has produced every gradient it
    holds (``register_post_accumulate_grad_hook``), in plan order.  On
    the card the reduce runs on ``side`` (which first waits on the stream
    that produced the gradients); on the CPU in line.  ``finish`` reduces
    what a backward left (a parameter without a gradient counts as zeros)
    and makes the caller's stream wait; ``grads`` unpacks the sums."""

    def __init__(self, engine, codec, params: list, generator, side):
        self.codec, self.params = codec, params
        self.mesh, self.generator, self.side = engine.mesh, generator, side
        self.plan = codec.plan_for(params)
        self.of: list[list[int]] = [[] for _ in params]
        for b, bucket in enumerate(self.plan):
            for leaf in sorted({s.leaf for s in bucket.slices}):
                self.of[leaf].append(b)
        self.need = [len({s.leaf for s in b.slices}) for b in self.plan]
        self.sums: list = [None] * len(self.plan)
        self.handles = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: self._ready(i)) for i, p in enumerate(params)]

    def begin(self) -> None:
        """A microbatch's backward starts: no gradient is in yet."""
        for p in self.params:
            p.grad = None
        self.left = list(self.need)
        self.seen = [False] * len(self.params)
        self.next = 0

    def _ready(self, i: int) -> None:
        if self.seen[i]:
            raise RuntimeError("a parameter's gradient was accumulated "
                               "twice in one backward pass: a bucket "
                               "would have been reduced too early")
        self.seen[i] = True
        for b in self.of[i]:
            self.left[b] -= 1
        while self.next < len(self.plan) and self.left[self.next] == 0:
            self._launch(self.next)

    def _launch(self, b: int) -> None:
        self.next = b + 1
        leaves = {s.leaf for s in self.plan[b].slices}
        grads = [None] * len(self.params)
        for i in leaves:
            p = self.params[i]
            grads[i] = p.grad if p.grad is not None else torch.zeros_like(p)
        if self.side is None:
            self._add(b, grads)
            return
        here = torch.cuda.current_stream(self.side.device)
        self.side.wait_stream(here)
        with torch.cuda.stream(self.side):
            for i in leaves:
                grads[i].record_stream(self.side)
            self._add(b, grads)

    def _add(self, b: int, grads: list) -> None:
        flat = overlap.pack_bucket(grads, self.plan[b])
        red = self.codec.inner.all_reduce_sum([flat], self.mesh,
                                              generator=self.generator)[0]
        if self.sums[b] is None:
            self.sums[b] = red
        else:
            self.sums[b] += red

    def finish(self) -> None:
        while self.next < len(self.plan):
            self._launch(self.next)
        if self.side is not None:
            here = torch.cuda.current_stream(self.side.device)
            here.wait_stream(self.side)
            for t in self.sums:
                t.record_stream(here)

    def grads(self) -> list:
        return overlap.unpack_buckets(self.sums, self.plan, self.params)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


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
        if compression.codec_active(engine.grad_codec):
            # the codec's rounding stream advances with each replay too
            self.graph.register_generator_state(state.codec_generator)
        counters = _launch_counters()
        before = [getattr(fn, name) for fn, name in counters]
        host_step = state.step
        # no garbage collection inside the capture: a dead cycle holding an
        # earlier graph frees its memory pool there, an operation a
        # capture forbids (torch no longer collects before a capture)
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            # thread-local: the capture forbids unsafe calls to this thread
            # only, not to the NCCL watchdog's or the autograd engine's
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                _, self.metrics = Engine.many_step(engine, state, self.xs,
                                                   self.ys)
        finally:
            if gc_was_on:
                gc.enable()
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
    # engines whose gradient all-reduce stays exact and whose codec is a
    # roundtrip after it (JAX's compiler-inserted collectives)
    codec_roundtrip = False
    # the mesh axis the gradients are summed over (None: every rank)
    grad_axis = None

    def __init__(self, *args, grad_accum: int = 1, **kw):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        super().__init__(*args, **kw)
        self.grad_accum = grad_accum
        # the ranks whose summed gradients make the global-batch mean
        self.reduce_n = self.n_devices
        self._graphs: dict[tuple, _ChunkGraph] = {}
        self._eager_chunks: set[tuple] = set()
        self._side = None

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
        if (not self.codec_roundtrip
                and compression.codec_active(self.grad_codec)):
            return self._codec_step(state, x, y, self.grad_codec)
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
            # every gradient summed over the ranks in one collective, the
            # two metrics with it (f32 gradients) or in an f32 one of their
            # own (16-bit gradients)
            loss, acc = all_reduce_grads_(list(state.model.parameters()),
                                          self.mesh,
                                          torch.stack([loss, acc]),
                                          axis=self.grad_axis) / n
        if self.codec_roundtrip and self.grad_codec.name != "none":
            self._roundtrip_grads(state)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "accuracy": acc}

    def _roundtrip_grads(self, state: TrainState) -> None:
        """The codec's encode and decode of the reduced gradients with the
        rank-invariant codec stream: every rank holds the same value and
        quantizes it alike, so the replicas stay equal."""
        params = [p for p in state.model.parameters() if p.grad is not None]
        out = self.grad_codec.roundtrip(
            [p.grad for p in params],
            generator=self.codec_step_generator(state))
        for p, g in zip(params, out):
            p.grad = g

    def _side_stream(self):
        """The stream the bucketed reduces run on (the card; None on the
        CPU), made once, outside any capture."""
        if self.device.type != "cuda":
            return None
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _codec_step(self, state: TrainState, x, y, codec):
        """The codec-active step (JAX ``_build_step_compressed``): the
        gradients of ``loss · 1/(n·K)`` (times the entering loss scale)
        summed over the ranks by ``codec`` (per bucket as the backward
        produces them when it is bucketed, else after the K microbatches
        in one ``all_reduce_sum``) with this rank's codec stream; the loss
        and accuracy in an f32 all-reduce of their own."""
        k, n = self.grad_accum, self.reduce_n
        if x.shape[0] % k:
            raise ValueError(f"per-device batch {x.shape[0]} not divisible "
                             f"by grad_accum {k}")
        loss_fn = make_loss_fn(state.model)
        gen = self.step_generator(state)
        cgen = self.codec_step_generator(state)
        ls = (precisionlib.loss_scale_from(state.optimizer)
              if self.precision.loss_scaling else None)
        params = list(state.model.parameters())
        state.optimizer.zero_grad(set_to_none=True)
        reducer = (_BucketReducer(self, codec, params, cgen,
                                  self._side_stream())
                   if getattr(codec, "bucketed", False) else None)
        loss = acc = 0.0
        try:
            for xc, yc in (zip(x.chunk(k), y.chunk(k)) if k > 1
                           else [(x, y)]):
                if reducer is not None:
                    reducer.begin()
                lc, ac = loss_fn(xc, yc, gen)
                scaled = lc / (n * k)
                if ls is not None:
                    scaled = scaled * ls
                scaled.backward()
                if reducer is not None:
                    reducer.finish()
                loss, acc = loss + lc.detach(), acc + ac.detach()
        finally:
            if reducer is not None:
                reducer.remove()
        if reducer is not None:
            grads = reducer.grads()
        else:
            grads = codec.all_reduce_sum(
                [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params], self.mesh, generator=cgen)
        for p, g in zip(params, grads):
            p.grad = g
        metrics = torch.stack([loss, acc])
        if k > 1:
            metrics = metrics / k
        if self.mesh is not None:
            metrics = coll.all_reduce_(metrics, self.mesh) / n
        state.optimizer.step()
        state.step += 1
        return state, {"loss": metrics[0], "accuracy": metrics[1]}

    def build_overlap_probe_fns(self):
        """The three callables ``overlap.probe_engine_overlap`` times
        (JAX ``build_overlap_probe_fns``): ``full``, the codec step (the
        plain codec's when no codec is active, so there is always a
        collective to take away); ``compute``, the same step with every
        collective elided (``ProbeLocalCodec``); ``collective``, the
        gradient exchange alone over parameter-shaped values."""
        codec = (self.grad_codec
                 if compression.codec_active(self.grad_codec)
                 else compression.GradCodec())
        local = overlap.ProbeLocalCodec()
        return {
            "full": lambda state, x, y: self._codec_step(state, x, y,
                                                         codec),
            "compute": lambda state, x, y: self._codec_step(state, x, y,
                                                            local),
            "collective": lambda params: codec.all_reduce_sum(params,
                                                              self.mesh),
        }

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
