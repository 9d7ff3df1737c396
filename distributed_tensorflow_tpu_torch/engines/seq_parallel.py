"""Sequence-parallel (context-parallel) training engine over a (data, seq)
mesh (port of ``engines/seq_parallel.py``).

Token sequences are sharded over the mesh's ``seq`` axis as well as the
batch over ``data`` (``parallel/mesh.py``): rank (d, s) holds rows
``[d·B/dp, (d+1)·B/dp)`` and token columns ``[s·L/sp, (s+1)·L/sp)`` of
every global batch, and the model's ring or Ulysses attention
(``parallel/ring_attention.py``) runs over the ``seq`` sub-group.  An LM's
per-token labels shard with the inputs; a classifier's labels shard over
``data`` only.

Gradient bookkeeping: parameters are replicated on every rank.  Every
rank differentiates its loss scaled by ``1/(dp·sp)``, and one all-reduce
SUM over the whole group of the flat gradient (with the two metrics, as
``SyncEngine`` packs them) gives the global-batch mean.  For an LM each
rank's loss is the mean over its 1/(dp·sp) of the tokens.  For a
classifier every seq rank computes the same loss (the ``[CLS]`` row is
broadcast from seq rank 0, ``models/bert.py``), so the sp copies sum to
its value, and the broadcast's backward sums their cotangents onto rank
0.  The cross-rank cotangents of the attention ride the collectives'
transposes (``parallel/collectives.py``) or the ring-flash backward.
JAX reaches the same mean through ``shard_map``'s typed transposes with
``1/dp`` for a classifier and ``1/(dp·sp)`` for an LM (JAX
``seq_parallel.py:153``).

Dropout: each rank's stream is seeded from (seed, step, data index, seq
index), so every token block draws its own masks (JAX ``:122-127``).  The
step is eager (``Engine.many_step``): its chunks are not captured as CUDA
graphs.  Precision: the bf16 policies; ``fp16-f32master`` is rejected, as
JAX's engine does not thread a loss scale.

A gradient codec (JAX ``seq_parallel.py:113-121, 195-200``): the
gradient is all-reduced exactly, as above, and then ``codec.roundtrip``
encodes and decodes it with a rank-invariant stream, seeded from (seed,
step, the codec's tag) without the rank's words (``codec_stream_words``
is ()), so every rank quantizes the same value alike and the replicas
stay equal.  Its wire bytes are the codec's accounting, as JAX reports
them for its compiler-inserted collective.  The engine has no overlap
probe (JAX's has none).
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.engines.base import Engine
from distributed_tensorflow_tpu_torch.engines.sync import SyncEngine
from distributed_tensorflow_tpu_torch.models.layers import bind_seq_mesh
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    SEQ_PARALLEL)


class SeqParallelEngine(SyncEngine):
    """Data × sequence parallel sync training.

    ``mesh`` must have the axes ('data', 'seq'); the model's
    ``attention_impl`` must be 'ring', 'ring_flash', 'ulysses' or
    'ulysses_flash'.  The engine binds the mesh to the model
    (``models.layers.bind_seq_mesh``).  ``grad_accum`` K splits each
    rank's rows into K microbatches."""

    seq_axis = meshlib.SEQ_AXIS
    supports_loss_scaling = False
    captures_chunks = False
    codec_roundtrip = True
    build_overlap_probe_fns = None

    def __init__(self, model, optimizer=None, mesh=None,
                 learning_rate: float = 1e-3, grad_accum: int = 1,
                 grad_compression: str = "none", grad_bucket_mb: float = 0.0,
                 precision: str = "f32", device=None):
        if mesh is None:
            raise ValueError("SeqParallelEngine requires an explicit "
                             "('data','seq') mesh")
        if set(mesh.axis_names) != {meshlib.DATA_AXIS, meshlib.SEQ_AXIS}:
            raise ValueError(
                f"mesh axes must be (data, seq), got {mesh.axis_names}")
        if getattr(model, "attention_impl", None) not in SEQ_PARALLEL:
            raise ValueError(
                "SeqParallelEngine needs a model with attention_impl "
                "'ring', 'ring_flash', 'ulysses' or 'ulysses_flash' — "
                "dense attention on sequence-sharded activations would "
                "silently attend within local blocks only")
        super().__init__(model, optimizer, mesh, learning_rate,
                         grad_accum=grad_accum,
                         grad_compression=grad_compression,
                         grad_bucket_mb=grad_bucket_mb, precision=precision,
                         device=device)
        self.seq_n = mesh.axis_size(self.seq_axis)
        self.seq_index = mesh.axis_index(self.seq_axis)
        self.reduce_n = self.n_devices * self.seq_n
        # a causal LM's (B, L) labels shard with its inputs, and its eval
        # sums over both axes; a classifier's over data only
        self.lm = bool(getattr(model, "causal_lm", False))
        bind_seq_mesh(self.model, mesh)

    @property
    def stream_words(self) -> tuple[int, ...]:
        """Dropout streams fold in the data and the seq index: every token
        block draws its own masks."""
        return (self.rank, self.seq_index)

    @property
    def codec_stream_words(self) -> tuple[int, ...]:
        """One codec stream for every rank: the reduced gradient is the
        same on every rank and must be quantized alike."""
        return ()

    def shard_batch(self, x, y, mask=None, process_local: bool = False):
        """This rank's rows (by data index) and token columns (by seq
        index) of a global batch; an LM's labels are cut like the inputs,
        a classifier's labels and the row mask by rows only.
        ``process_local=True``: the rows given are already this rank's."""
        def rows(a):
            if process_local:
                return a
            n, r = self.n_devices, self.rank
            if len(a) % n:
                raise ValueError(f"batch of {len(a)} rows does not split "
                                 f"over {n} data ranks")
            b = len(a) // n
            return a[r * b:(r + 1) * b]

        def cols(a):
            width = a.shape[1]
            if width % self.seq_n:
                raise ValueError(f"sequence length {width} does not split "
                                 f"over {self.seq_n} seq ranks")
            c = width // self.seq_n
            return a[:, self.seq_index * c:(self.seq_index + 1) * c]

        xs = self._put(cols(rows(x)))
        ys = self._put(cols(rows(y)) if self.lm and y.ndim >= 2
                       else rows(y))
        if mask is None:
            return xs, ys
        return xs, ys, self._put(rows(mask))

    def many_step(self, state, xs_seq, ys_seq):
        """Eager steps (``Engine.many_step``): no CUDA graph."""
        return Engine.many_step(self, state, xs_seq, ys_seq)

    def _reduce_totals(self, totals: torch.Tensor) -> None:
        # an LM's seq ranks scored their own token blocks; a classifier's
        # all hold the same logits, so only the data axis sums
        coll.all_reduce_(totals, self.mesh,
                         axis=None if self.lm else meshlib.DATA_AXIS)
