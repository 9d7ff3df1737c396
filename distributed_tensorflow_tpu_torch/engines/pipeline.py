"""Pipeline parallelism: GPipe and 1F1B microbatch schedules over a
(data, pipe) mesh (port of ``engines/pipeline.py``).

JAX writes the pipeline as one SPMD program: the stage parameters are
stacked over a leading stage dim and sharded over 'pipe', a ``lax.scan``
of ticks rotates the activations with ``ppermute``, and the backward pass
is AD through the scan (GPipe) or a hand-scheduled ``jax.vjp`` per tick
(1F1B).  Here every rank of a row-major ``(data, pipe)`` mesh
(``parallel/mesh.py``) is one process that holds its stage's block as a
module (``PipelineStages``: ``embed``, ``block``, ``head``), and both
schedules are explicit forward and backward ticks:

* every tick each rank runs its stage on the microbatch that is its own
  at that tick, then the activations move one stage on
  (``collectives.shift_to_next``) and, in the backward ticks, the
  cotangents one stage back (``shift_to_prev``).  The shifts run outside
  autograd, on every rank in the same order, with zeros where a rank has
  nothing to send (a bubble); a tick's backward is
  ``torch.autograd.backward(output, cotangent)`` on that tick's own
  graph.  A ``_Shift`` inside autograd cannot serve: stage 0 discards
  what it receives at injection ticks and a stage's loss does not depend
  on its sends, so autograd would never reach some ranks' shift nodes
  while their peers wait in the matching exchange;
* GPipe (``schedule='gpipe'``): M + S − 1 forward ticks (stage s runs
  microbatch i − s at tick i; stage 0 embeds it, the last stage applies
  the head and the loss), then M + S − 1 backward ticks, stage s taking
  microbatch j at tick j + S − 1 − s.  Each tick keeps its graph (M per
  rank), or under ``remat`` only the block's input, from which the
  backward tick runs the block again;
* 1F1B (``schedule='1f1b'``): JAX's lockstep timetable, ``fwd(s, i)`` at
  ``t = 2i + s`` and ``bwd(s, i)`` at ``t = 2i + 2S − 1 − s``, 2(M + S − 1)
  ticks; the forward runs without a graph and stashes its input in an
  S-slot stash (slot ``i mod S``); the backward runs the stage again from
  the stash under autograd (and stage 0 its embed, the last stage its
  head and loss).

Every tick splits its graph at the stage's edges: the embed's output, the
block and the head each start from a detached input, and a backward tick
runs them in the order head, block, embed.  The schedules and remat then
run the same operations on the same values, and each parameter's
gradient adds up its microbatches in the same order (0 to M − 1: GPipe's
backward ticks run the microbatches forward, as 1F1B does), so GPipe,
GPipe with remat and 1F1B give bitwise equal steps where the kernels are
deterministic.  JAX's GPipe adds them in reverse (AD through the scan),
its 1F1B forward; the port's parity with JAX is a tolerance.

The loss of a microbatch is its mean cross-entropy, scaled by
``1 / (M · n_data · sp)`` (JAX ``pipeline.py:437-440, 572``), so the sums
below are the global-batch mean gradient.  After the schedule the block
gradients are summed over 'data' (and 'seq'); the embed and head
gradients (nonzero on the first and last stage only) and the metrics
(the summed microbatch losses and accuracies and their count) over
'data', 'pipe' (and 'seq'): the psum JAX's AD inserts at the replicated
parameters' boundary.  On a (data, pipe) mesh these are one all-reduce
over 'data' and one over every rank; on a composite mesh one per named
axis larger than 1.  Nothing is summed over 'model', whose ranks hold the
same tokens: a leaf cut over it holds its own slice's gradient, and a
replicated one its whole gradient on every rank already.  ``loss`` and
``accuracy`` are the sums over the count.

The composites (JAX ``:166-170, 227-248, 789-800``): a 'model' axis
(pp×tp) cuts each stage's Megatron layers (stages built with
``partition_model``; ``models.layers.bind_model_mesh``), whose conjugate
collectives run inside the stage's ticks; a 'seq' axis (pp×sp) shards
the sequence: ``shard_batch`` gives each rank its token columns of a
training batch, the carry is that token block, and the stages' ring or
Ulysses attention runs over the 'seq' sub-group
(``models.layers.bind_seq_mesh``).  The rank layouts are JAX's: (data,
pipe, model), (data, pipe, seq) and (data, pipe, seq, model).  The
'model' and 'seq' peers of a stage hold the same stage index, so they
share its tick pattern: a bubble tick is skipped by all of them alike,
and the collectives inside a stage meet.  The pipe shifts pair the ranks
that share their (data, model, seq) coordinates.  1F1B with a 'seq' axis
is refused in JAX's words (its XLA conditionals cannot hold the ring's
collectives; the port keeps the refusal), so pp×sp runs GPipe, with or
without remat.

``init_state`` draws the embed, then every stage's block whole from the
seeded generator, keeping this rank's, then the head: a pipeline model
is the sequential model under the same seed, whatever rank holds which
stage.  Embed and head are replicated over 'pipe' (and 'seq').
``param_specs`` marks each block leaf stacked over 'pipe'
(``Engine.stacked_params``) and then cut as its layer cuts it over
'model' (``tp_specs``): a checkpoint holds it whole as JAX's
``params["blocks"]``, ``(S, ...)``, gathered at save, and a restore
takes this rank's stage and slice (a checkpoint of another stage count
raises, as JAX's restore does); the recipe's clip counts each stage's
block once and embed and head once, as optax sees the stacked tree.

``eval_params`` gathers every leaf whole (over 'pipe' and 'model') into
``SequentialStages`` of the stages' unbound twins (``unbound()``; JAX
``_oracle_stages``): no Megatron cut, no ``seq_axis``, and the
whole-sequence attention of a ring or Ulysses stage (``ring_flash`` and
``ulysses_flash`` keep the flash kernels; JAX's twin is dense
attention).  ``evaluate`` runs it on each rank's rows, whole sequences
(the totals summed over 'data'), and ``generate`` decodes with it.  The
steps are eager: no CUDA graph, the Adam not capturable
(``Engine.many_step``'s loop).

Not ported here: the mesh axis 'expert' (the pp×ep composites) raises
``NotImplementedError``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import PIPELINE_COMPOSITES, not_ported
from distributed_tensorflow_tpu_torch.engines.base import (
    Engine, TrainState, all_reduce_grads_, cross_entropy)
from distributed_tensorflow_tpu_torch.models.layers import (
    LN_EPS, bind_model_mesh, bind_seq_mesh, dense, flax_init_, layer_norm,
    tp_specs)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    SEQ_PARALLEL)


class PipelineEmbed(nn.Module):
    """Input stage: flatten → project to the pipeline's hidden width →
    ReLU (its input width taken from the first input, as flax infers
    it)."""

    def __init__(self, hidden: int = 128, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.LazyLinear(hidden, device=device)

    def forward(self, x):
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        return F.relu(dense(self.fc, x, self.dtype))


class PipelineBlock(nn.Module):
    """One pipeline stage: a pre-norm residual MLP block (width kept, so
    every stage has the same parameters)."""

    def __init__(self, hidden: int = 128, expansion: int = 2,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.ln = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(hidden, hidden * expansion, device=device)
        self.fc2 = nn.Linear(hidden * expansion, hidden, device=device)

    def forward(self, h):
        y = layer_norm(self.ln, h, self.dtype)
        y = F.relu(dense(self.fc1, y, self.dtype))
        return h + dense(self.fc2, y, self.dtype)


class PipelineHead(nn.Module):
    """Output stage: norm → logits, in f32."""

    def __init__(self, num_classes: int = 10, hidden: int = 128,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.ln = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.fc = nn.Linear(hidden, num_classes, device=device)

    def forward(self, h):
        y = layer_norm(self.ln, h, self.dtype)
        return dense(self.fc, y, self.dtype).float()


class SequentialStages(nn.Module):
    """The un-pipelined model: embed, every stage's block in order, head
    (JAX ``_sequential_logits``).  ``forward(x, train=False,
    generator=None)`` takes the engines' model signature; the stages hold
    no dropout."""

    def __init__(self, embed: nn.Module, blocks, head: nn.Module):
        super().__init__()
        self.embed, self.head = embed, head
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, train: bool = False, generator=None):
        h = self.embed(x)
        for block in self.blocks:
            h = block(h)
        return self.head(h)


class PipelineStages(nn.Module):
    """This rank's part of a pipeline: the embed and head (replicated on
    every rank) and its stage's block.  ``reset_parameters`` draws the
    embed, then the blocks of stages 0 to S − 1 in order (keeping stage
    ``stage``'s), then the head.  ``forward`` is the sequential model of
    this one stage (the model at S = 1; ``init_state`` runs it to infer
    lazy widths); the engine's schedules call the three parts apart."""

    def __init__(self, embed: nn.Module, block: nn.Module, head: nn.Module,
                 n_stages: int = 1, stage: int = 0):
        super().__init__()
        self.embed, self.block, self.head = embed, block, head
        self.n_stages, self.stage = n_stages, stage

    @property
    def stacked_params(self) -> set[str]:
        """The block's parameter names: each is one stage's slice of a
        leaf stacked over the stages (JAX's ``params["blocks"]``, one dim
        more)."""
        return {f"block.{n}" for n, _ in self.block.named_parameters()}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        flax_init_(self.embed, generator)
        kept = None
        for s in range(self.n_stages):
            # every stage's draw lands in this rank's block, whose own is
            # put back after (a bound block cannot be copied: its mesh
            # holds process groups)
            flax_init_(self.block, generator)
            if s == self.stage and s < self.n_stages - 1:
                kept = {k: v.clone()
                        for k, v in self.block.state_dict().items()}
        if kept is not None:
            self.block.load_state_dict(kept)
        flax_init_(self.head, generator)
        return self

    def forward(self, x, train: bool = False, generator=None):
        return self.head(self.block(self.embed(x)))


def _parts(carry) -> list:
    """A carry's tensors: a tensor, or a tuple of them (BERT's
    ``(hidden, pad_mask)``)."""
    return list(carry) if isinstance(carry, (tuple, list)) else [carry]


def _join(kind, parts):
    return parts[0] if kind is None else kind(parts)


def _leaf(carry):
    """``carry`` detached, its floating tensors gradient leaves: where a
    part of a tick's graph starts."""
    parts = [t.detach().requires_grad_(t.is_floating_point())
             for t in _parts(carry)]
    return type(carry)(parts) if isinstance(carry, (tuple, list)) \
        else parts[0]


def _grads(carry) -> list:
    """The gradients a backward left on ``carry``'s floating leaves
    (zeros where it left none): the cotangent to send back."""
    return [t.grad if t.grad is not None else torch.zeros_like(t)
            for t in _parts(carry) if t.is_floating_point()]


def _backward(out, grads) -> None:
    """``torch.autograd.backward`` of ``out``'s floating tensors that
    depend on a gradient leaf, with ``grads`` (one per floating
    tensor)."""
    pairs = [(t, g) for t, g in zip(
        [t for t in _parts(out) if t.is_floating_point()], grads)
        if t.requires_grad]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])


class PipelineEngine(Engine):
    """data × pipe parallel training of an embed → S blocks → head model,
    with 'model' and 'seq' inside the stages (module docstring).

    ``mesh`` must have the axes ('data', 'pipe'), and may add 'model' and
    'seq'; the stage count S is the pipe axis's size.  ``microbatches``
    (M) must divide the per-data-shard batch.  ``stages`` plugs in
    (embed, block, head) modules — ``models.gpt.gpt_pipeline_stages``,
    ``models.bert.bert_pipeline_stages`` — whose contract is JAX's:
    ``block(carry) -> carry`` with the carry ``embed(x)`` returns (a
    tensor or a tuple of them), one parameter structure for every stage,
    and no dropout; without it the built-in MLP stages of ``hidden`` and
    ``expansion``.  ``schedule`` is 'gpipe' or '1f1b'; ``remat`` applies
    to 'gpipe' (1F1B recomputes by construction)."""

    def __init__(self, num_classes: int = 10, hidden: int = 128,
                 microbatches: int = 4, optimizer=None, mesh=None,
                 learning_rate: float = 1e-3, expansion: int = 2,
                 dtype=torch.float32, stages=None, schedule: str = "gpipe",
                 remat: bool = False, device=None):
        if mesh is None or not {meshlib.DATA_AXIS,
                                meshlib.PIPE_AXIS} <= set(mesh.axis_names):
            raise ValueError("PipelineEngine requires a ('data','pipe') mesh")
        extra = set(mesh.axis_names) - {meshlib.DATA_AXIS, meshlib.PIPE_AXIS,
                                        meshlib.MODEL_AXIS, meshlib.SEQ_AXIS,
                                        meshlib.EXPERT_AXIS}
        if extra:
            raise ValueError(
                f"unsupported mesh axes {sorted(extra)}; PipelineEngine "
                f"composes data×pipe(×model)(×seq)(×expert)")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule '{schedule}'; "
                             f"choose 'gpipe' or '1f1b'")
        self.sp_n = mesh.shape.get(meshlib.SEQ_AXIS, 1)
        if self.sp_n > 1 and schedule == "1f1b":
            # JAX pipeline.py:238-248
            raise ValueError(
                "schedule='1f1b' does not compose with a 'seq' mesh axis "
                "(ring collectives cannot live inside the schedule's "
                "conditionals); use schedule='gpipe' for pp×sp")
        if meshlib.EXPERT_AXIS in mesh.axis_names:
            not_ported("PipelineEngine over a mesh with an 'expert' axis "
                       "(the pp×ep composites)", PIPELINE_COMPOSITES)
        if microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {microbatches}")
        self.schedule = schedule
        # 1F1B stashes each stage's input and recomputes by construction
        self.remat = remat and schedule == "gpipe"
        self.n_stages = mesh.axis_size(meshlib.PIPE_AXIS)
        self.stage = mesh.axis_index(meshlib.PIPE_AXIS)
        self.microbatches = microbatches
        if stages is None:
            stages = (PipelineEmbed(hidden, dtype, device=mesh.device),
                      PipelineBlock(hidden, expansion, dtype,
                                    device=mesh.device),
                      PipelineHead(num_classes, hidden, dtype,
                                   device=mesh.device))
        self.embed, self.block, self.head = stages
        for part in stages:
            for mod in part.modules():
                if getattr(mod, "dropout_rate", 0.0):
                    raise ValueError(
                        f"pipeline stages must be deterministic (dropout "
                        f"0): the schedules run a stage again in the "
                        f"backward pass; {type(mod).__name__} has "
                        f"dropout_rate {mod.dropout_rate}")
        self.moe = getattr(self.block, "moe_experts", 0) > 0
        self._bind(mesh, stages)
        model = PipelineStages(self.embed, self.block, self.head,
                               self.n_stages, self.stage)
        super().__init__(model, optimizer=optimizer, mesh=mesh,
                         learning_rate=learning_rate, device=device)
        self.stacked_params = model.stacked_params
        cut = tp_specs(model)
        self.param_specs = {
            n: ((meshlib.PIPE_AXIS,) + (cut[n] or (None,) * p.dim())
                if n in self.stacked_params else cut[n])
            for n, p in model.named_parameters()
            if n in self.stacked_params or cut[n]}
        names = mesh.axis_names
        if set(names) == {meshlib.DATA_AXIS, meshlib.PIPE_AXIS}:
            # one all-reduce each: 'data', and every rank
            self._block_axes, self._edge_axes = meshlib.DATA_AXIS, None
        else:
            self._block_axes = tuple(a for a in names if a in (
                meshlib.DATA_AXIS, meshlib.SEQ_AXIS))
            self._edge_axes = tuple(a for a in names if a in (
                meshlib.DATA_AXIS, meshlib.PIPE_AXIS, meshlib.SEQ_AXIS))
        self._carry_specs: dict = {}

    def _bind(self, mesh, stages) -> None:
        """Give the stages the mesh, as ``CompositeEngine`` binds a model:
        its 'model' axis to the Megatron layers, its 'seq' axis to a
        sequence-parallel block's attention and to the embed's and
        block's positions."""
        if meshlib.MODEL_AXIS in mesh.axis_names:
            for part in stages:
                bind_model_mesh(part, mesh)
        impl = getattr(self.block, "attention_impl", "dense")
        if impl in SEQ_PARALLEL:
            if meshlib.SEQ_AXIS not in mesh.axis_names:
                raise ValueError(
                    f"attention_impl '{impl}' runs over a 'seq' mesh axis "
                    f"(size 1 is fine); this mesh has {mesh.axis_names}")
            for part in stages:
                bind_seq_mesh(part, mesh)
        elif self.sp_n > 1:
            raise ValueError(
                f"seq axis size {self.sp_n} needs stages with a seq_axis "
                f"and attention_impl 'ring', 'ring_flash', 'ulysses' or "
                f"'ulysses_flash', got '{impl}'")

    # ------------------------------------------------------------- batches
    def shard_batch(self, x, y, mask=None, process_local: bool = False):
        """This rank's rows (by data index) and, when 'seq' > 1, token
        columns (by seq index) of a training batch (JAX ``:309-326``); an
        LM's (B, L) labels are cut like the inputs.  An evaluation batch
        (``mask`` given) keeps whole sequences: ``evaluate`` runs the
        unbound twins."""
        if self.sp_n > 1:
            if x.ndim < 2 or x.shape[1] % self.sp_n:
                raise ValueError(
                    f"pp×sp needs (batch, seq, ...) input with seq "
                    f"divisible by the seq axis size {self.sp_n}, got "
                    f"shape {x.shape}")
            if mask is None:
                c = x.shape[1] // self.sp_n
                i = self.mesh.axis_index(meshlib.SEQ_AXIS)
                x = x[:, i * c:(i + 1) * c]
                if y.ndim >= 2:
                    y = y[:, i * c:(i + 1) * c]
        return super().shard_batch(x, y, mask, process_local)

    # ------------------------------------------------------------- carries
    def _carry_spec(self, x):
        """The carry ``embed`` makes of a microbatch like ``x``: its kind
        (None for a tensor, else the tuple type) and each tensor's (shape,
        dtype), which the shifts send as zeros where a rank has nothing
        (cached per input shape).  The GPT and BERT embeds say it without
        running (their bound lookup is a collective); another embed runs
        once."""
        key = (tuple(x.shape), x.dtype)
        if key not in self._carry_specs:
            probe = getattr(self.embed, "carry_spec", None)
            if probe is not None:
                self._carry_specs[key] = probe(x)
            else:
                with torch.no_grad():
                    carry = self.embed(x)
                kind = (type(carry) if isinstance(carry, (tuple, list))
                        else None)
                self._carry_specs[key] = (kind, [(t.shape, t.dtype)
                                                 for t in _parts(carry)])
        return self._carry_specs[key]

    def _zero_carry(self, spec):
        kind, shapes = spec
        return _join(kind, [torch.zeros(s, dtype=d, device=self.device)
                            for s, d in shapes])

    def _zero_cotangent(self, spec) -> list:
        return [torch.zeros(s, dtype=d, device=self.device)
                for s, d in spec[1] if d.is_floating_point]

    def _head_loss(self, h, y, sums):
        """The head and this microbatch's mean cross-entropy on the stage
        output ``h`` (detached first: the head's graph starts there); the
        loss and accuracy join ``sums`` with one microbatch.  Returns
        (loss, the head's input leaf)."""
        z = _leaf(h)
        logits = self.head(z)
        loss = cross_entropy(logits, y).mean()
        sums += torch.stack([loss.detach(),
                             (logits.argmax(-1) == y).float().mean(),
                             torch.ones((), device=self.device)])
        return loss, z

    # ----------------------------------------------------------- schedules
    def _gpipe(self, xs, ys, scale: float, sums) -> None:
        """All forward ticks, then all backward ticks (module
        docstring)."""
        S, M, s = self.n_stages, len(xs), self.stage
        first, last = s == 0, s == S - 1
        spec = self._carry_spec(xs[0])
        ticks = M + S - 1
        saved: list = [None] * M
        buf = self._zero_carry(spec)
        for i in range(ticks):
            j, send = i - s, None
            if 0 <= j < M:
                rec = {}
                if first:
                    rec["e"] = self.embed(xs[j])
                    h_in = _leaf(rec["e"])
                else:
                    h_in = _leaf(buf)
                rec["h_in"] = h_in
                if self.remat:
                    with torch.no_grad():
                        send = self.block(h_in)
                else:
                    send = rec["h_out"] = self.block(h_in)
                if last:
                    # the head's graph is kept, not recomputed: JAX's remat
                    # wraps the block alone
                    rec["loss"], rec["z"] = self._head_loss(send, ys[j],
                                                            sums)
                saved[j] = rec
            if i < ticks - 1:
                buf = coll.shift_to_next(
                    send if send is not None else self._zero_carry(spec),
                    self.mesh)
        cot = None
        for i in range(ticks):
            j, send = i - (S - 1 - s), None
            if 0 <= j < M:
                rec, saved[j] = saved[j], None
                if last:
                    (rec["loss"] * scale).backward()
                    cot = _grads(rec["z"])
                h_in = rec["h_in"]
                h_out = self.block(h_in) if self.remat else rec["h_out"]
                _backward(h_out, cot)
                if first:
                    _backward(rec["e"], _grads(h_in))
                else:
                    send = _grads(h_in)
            if i < ticks - 1:
                cot = coll.shift_to_prev(
                    send if send is not None else self._zero_cotangent(spec),
                    self.mesh)

    def _one_f_one_b(self, xs, ys, scale: float, sums) -> None:
        """JAX's lockstep 1F1B timetable (module docstring)."""
        S, M, s = self.n_stages, len(xs), self.stage
        first, last = s == 0, s == S - 1
        spec = self._carry_spec(xs[0])
        ticks = 2 * (M + S - 1)
        stash: list = [None] * S
        fbuf, bbuf = self._zero_carry(spec), self._zero_cotangent(spec)
        for t in range(ticks):
            fwd = bwd = None
            tf = t - s
            if 0 <= tf < 2 * M and tf % 2 == 0:
                i = tf // 2
                with torch.no_grad():
                    h_in = self.embed(xs[i]) if first else fbuf
                    stash[i % S] = h_in
                    fwd = self.block(h_in)
            tb = t - (2 * S - 1 - s)
            if 0 <= tb < 2 * M and tb % 2 == 0:
                i = tb // 2
                h = _leaf(stash[i % S])
                stash[i % S] = None
                h_out = self.block(h)
                if last:
                    loss, z = self._head_loss(h_out, ys[i], sums)
                    (loss * scale).backward()
                    cot = _grads(z)
                else:
                    cot = bbuf
                _backward(h_out, cot)
                if first:
                    _backward(self.embed(xs[i]), _grads(h))
                else:
                    bwd = _grads(h)
            if t < ticks - 1:
                fbuf = coll.shift_to_next(
                    fwd if fwd is not None else self._zero_carry(spec),
                    self.mesh)
                bbuf = coll.shift_to_prev(
                    bwd if bwd is not None else self._zero_cotangent(spec),
                    self.mesh)

    # ---------------------------------------------------------------- step
    def _step(self, state: TrainState, x, y):
        """One training step on this rank's rows (every rank of a 'pipe'
        group holds the same ones); updates ``state`` in place."""
        M = self.microbatches
        if x.shape[0] % M:
            raise ValueError(f"per-data-shard batch {x.shape[0]} not "
                             f"divisible by microbatches {M}")
        xs, ys = x.chunk(M), y.chunk(M)
        scale = 1.0 / (M * self.n_devices * self.sp_n)
        state.optimizer.zero_grad(set_to_none=True)
        # the last stage's summed microbatch losses, accuracies and count
        sums = torch.zeros(3, device=self.device)
        if self.schedule == "1f1b":
            self._one_f_one_b(xs, ys, scale, sums)
        else:
            self._gpipe(xs, ys, scale, sums)
        model = state.model
        all_reduce_grads_(list(model.block.parameters()), self.mesh,
                          axis=self._block_axes)
        sums = all_reduce_grads_(
            list(model.embed.parameters()) + list(model.head.parameters()),
            self.mesh, sums, axis=self._edge_axes)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": sums[0] / sums[2],
                       "accuracy": sums[1] / sums[2]}

    # ---------------------------------------------------------------- eval
    @torch.no_grad()
    def eval_params(self, state: TrainState) -> SequentialStages:
        """The sequential model of every stage: each leaf gathered whole
        (``full_state_dict``: a collective, every rank calls it) into the
        stages' unbound twins (module docstring); the MLP stages, which
        no mesh binds, are copied."""
        from distributed_tensorflow_tpu_torch.models.convert import (
            unstacked_state_dicts)

        embed, blocks, head = unstacked_state_dicts(
            self.full_state_dict(state))

        def twin(part, sd):
            out = (part.unbound() if hasattr(part, "unbound")
                   else copy.deepcopy(part))
            out.load_state_dict(sd)
            return out

        model = state.model
        return SequentialStages(twin(model.embed, embed),
                                [twin(model.block, b) for b in blocks],
                                twin(model.head, head))

    def _sequential_logits(self, model: SequentialStages, x):
        """The un-pipelined forward (``eval_params``' model): embed, every
        stage in order, head; the evaluation path and the parity
        oracle."""
        return model(x)

    def _reduce_totals(self, totals: torch.Tensor) -> None:
        # every rank of a 'pipe' group evaluated the same rows
        coll.all_reduce_(totals, self.mesh, axis=meshlib.DATA_AXIS)

    # ------------------------------------------------------------ generate
    @torch.no_grad()
    def generate(self, state: TrainState, prompt, max_new_tokens: int):
        """Greedy-decode ``max_new_tokens`` per prompt row from GPT stages
        (JAX ``PipelineEngine.generate``): no KV cache, but one
        fixed-length sequential forward (``eval_params``) over a
        zero-padded (B, P + N) buffer per new token, whose token i comes
        from the logits at i − 1 (causal attention keeps the padding
        invisible to the positions already written).  ``prompt`` is (B, P)
        token ids; returns the (B, P + N) int32 array of the prompt and
        its greedy continuation.  Every rank of the mesh calls it."""
        from distributed_tensorflow_tpu_torch.models.gpt import GPTPipeEmbed

        if not isinstance(self.embed, GPTPipeEmbed):
            raise ValueError(
                f"generate needs GPT decoder stages (vocab-head output); "
                f"this engine's embed stage is "
                f"{type(self.embed).__name__}")
        if self.moe:
            raise ValueError(
                "generate does not support MoE stage blocks: the routers' "
                "capacity-limited dispatch sees every position of the "
                "fixed-length buffer, so the zero padding claims expert "
                "capacity and shifts routing — the decode would not be the "
                "true greedy continuation.  Sample from a dense-FFN "
                "pipeline run, or train MoE without -pp and use the "
                "KV-cache sampler")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 2:
            raise ValueError(f"prompt must be (batch, len), got "
                             f"{prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be positive, got {max_new_tokens}")
        p_len = prompt.shape[1]
        total = p_len + int(max_new_tokens)
        if total > self.embed.max_len:
            raise ValueError(
                f"prompt {p_len} + {max_new_tokens} new tokens exceeds the "
                f"stages' max_len {self.embed.max_len}")
        model = self.eval_params(state)
        toks = torch.zeros((prompt.shape[0], total), dtype=torch.long,
                           device=self.device)
        toks[:, :p_len] = torch.as_tensor(prompt, device=self.device)
        for i in range(p_len, total):
            logits = self._sequential_logits(model, toks)
            toks[:, i] = logits[:, i - 1].argmax(-1)
        return toks.cpu().numpy().astype(np.int32)
