"""BERT-tiny sequence classifier (port of ``models/bert.py``): BASELINE
config 5, "BERT-tiny GLUE fine-tune".

Post-LN encoder: token + position embeddings → LayerNorm → dropout →
``layers`` × (``LayerNorm(x + attn(x))``, ``LayerNorm(x + dropout(ffn(x)))``)
→ the ``[CLS]`` readout at position 0 → tanh pooler → f32 logits.  The
published BERT-tiny shape is the default: 2 layers, hidden 128, 2 heads
(head dim 64), FFN 512, max_len 512.

Input is integer token ids (B, L); id 0 is padding, and the model builds
``pad_mask = token_ids > 0`` itself, which masks padded keys out of every
query's attention.  ``attention_impl``:

* ``dense``: ``parallel.ring_attention.dense_attention`` with
  attention-probability dropout through its ``prob_fn``;
* ``flash``: ``ops.flash_attention(q, k, v, kv_mask=pad_mask)``, the
  Hopper ports of the Pallas forward, dQ and dK/dV kernels on their
  non-causal key-masked route (no probability dropout, as in JAX).  A row
  whose keys are all padding gets the mean of V over the row's keys
  (the JAX kernels' answer, ``ops/flash_attention.py``), where ``dense``
  gives the mean over all keys too: every score is ``-1e30``;
* ``ring``, ``ring_flash``, ``ulysses``, ``ulysses_flash``: the sequence
  is sharded over the ``seq`` axis of the mesh ``SeqParallelEngine`` binds
  (``parallel.ring_attention``, no probability dropout): the input is this
  rank's token block, positions are global, the key mask travels with the
  keys, and the ``[CLS]`` row, which only seq rank 0 holds, is broadcast
  from it before the pooler (``broadcast_from``, whose backward sums the
  pooler's cotangents back onto rank 0; JAX ``bert.py:233-271``).

Flax's numerics are kept: f32 parameters, Dense and Embed computing in
``dtype``, LayerNorm epsilon 1e-6 normalised in f32, tanh GELU, logits in
f32.  Dropout draws its masks from the ``generator`` passed to
``forward``.  ``remat=True`` checkpoints each ``TransformerLayer``
(``models.layers.remat``): same parameters, the layer's forward runs
again in the backward pass.  ``models/convert.py`` ``bert_state_dict``
maps a flax param tree onto this module's ``state_dict``.

``moe_experts > 0`` swaps each layer's FFN for a routed MoE layer
(``models/moe.py``, ``moe_ffn``) over the layer's tokens, before the same
dropout and post-LN; the router's losses are left on the layers
(``engines.expert_parallel.router_losses``).

``partition_model=True`` is JAX's Megatron layout (``models/layers.py``
and ``models/gpt.py``): column-parallel QKV, row-parallel ``out``, the
column→row FFN and a vocab-parallel token embedding; the position
embedding, LayerNorms, pooler and classifier stay whole.  Under TP the
attention-probability dropout (``dense``) draws the whole (B, H, L, L)
mask and keeps this rank's heads.

``bert_pipeline_stages`` (``BertPipeEmbed``, ``BertPipeBlock``,
``BertPipeHead``) splits the encoder for ``engines.pipeline``: the
embeddings, ``layers_per_stage`` dropout-free dense-attention layers a
stage over the carry ``(hidden, pad_mask)``, and the ``[CLS]`` pooler;
with ``partition_model`` (pp×tp) the embed and layers take the Megatron
layout and the pooler stays whole.

Under ``CompositeEngine`` the Megatron layers carry ring or Ulysses
attention over 'seq' on the rank's local heads (Ulysses needs them to
split over the 'seq' axis), and ``partition_experts`` (with
``partition_model``, the 2-D layout) lets the engine cut the MoE layers'
experts (``models.moe.shard_experts``).

Not ported here (raises ``NotImplementedError``): the stages'
``moe_experts`` (the pipeline's MoE composites).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import (
    resolve_device)
from distributed_tensorflow_tpu_torch.models.layers import (
    LN_EPS, ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    check_divisible, dense as _dense, dropout as _dropout, flax_init_,
    layer_norm as _layer_norm, remat as _remat, sharded_dropout,
    unbound_kw)
from distributed_tensorflow_tpu_torch.models.moe import MoELayer, moe_ffn
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel.mesh import SEQ_AXIS
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    SEQ_PARALLEL, block_span, dense_attention, seq_parallel_attention)


class SelfAttention(nn.Module):
    """Bidirectional multi-head attention under a (B, L) key mask."""

    seq_mesh = None   # the mesh of a sequence-parallel model (bind_seq_mesh)
    tp_mesh = None    # the mesh of a tensor-parallel model (bind_tp)

    def __init__(self, hidden: int, heads: int, attention_impl: str,
                 dropout_rate: float, dtype, device,
                 partition_model: bool = False):
        super().__init__()
        self.heads, self.head_dim = heads, hidden // heads
        self.attention_impl = attention_impl
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        width = heads * self.head_dim
        col = ColumnParallelLinear if partition_model else nn.Linear
        self.query = col(hidden, width, device=device)
        self.key = col(hidden, width, device=device)
        self.value = col(hidden, width, device=device)
        self.out = (RowParallelLinear if partition_model else nn.Linear)(
            width, hidden, device=device)

    def bind_tp(self, mesh, prefix: str = "") -> None:
        """Column-parallel QKV (``heads/tp`` heads a rank), row-parallel
        ``out`` (JAX ``bert.py:83-88, 114-117``); a width that does not
        split raises JAX's error, heads that do not (whose width does)
        keep the attention whole, as in ``models/gpt.py``."""
        if not isinstance(self.query, ColumnParallelLinear) or \
                self.tp_mesh is not None:
            return
        tp = mesh.axis_size("model")
        for name in ("query", "key", "value"):
            check_divisible(f"{prefix}.{name}.weight",
                            getattr(self, name).whole["weight"], 0, tp)
        check_divisible(f"{prefix}.out.weight", self.out.whole["weight"], 1,
                        tp)
        if self.heads % tp:
            return
        for name in ("query", "key", "value"):
            getattr(self, name).bind(mesh, f"{prefix}.{name}")
        self.out.bind(mesh, f"{prefix}.out")
        self.heads //= tp
        self.tp_mesh = mesh

    def forward(self, x, pad_mask, train: bool = False, generator=None):
        b, lq, _ = x.shape
        if self.tp_mesh is not None:
            x = coll.copy_to_model(x, self.tp_mesh)
        q, k, v = (_dense(lin, x, self.dtype).reshape(
            b, lq, self.heads, self.head_dim)
            for lin in (self.query, self.key, self.value))
        if self.attention_impl == "flash":
            from distributed_tensorflow_tpu_torch.ops.flash_attention import (
                flash_attention)
            out = flash_attention(q, k, v, kv_mask=pad_mask)
        elif self.attention_impl in SEQ_PARALLEL:
            out = seq_parallel_attention(self.attention_impl, q, k, v,
                                         self.seq_mesh, kv_mask=pad_mask)
        else:
            prob_fn = None
            if self.dropout_rate > 0.0:
                # (B, H, Lq, Lk): under TP this rank's heads of the mask
                def prob_fn(p):
                    return sharded_dropout(p, self.dropout_rate, train,
                                           generator, self.tp_mesh, 1)
            out = dense_attention(q, k, v, kv_mask=pad_mask, prob_fn=prob_fn)
        out = out.reshape(b, lq, self.heads * self.head_dim)
        if self.tp_mesh is not None:
            return self.out(out, self.dtype)
        return _dense(self.out, out, self.dtype)


class TransformerLayer(nn.Module):
    """Post-LN encoder layer: LN(x + attn(x)), then LN(x + dropout(ffn))."""

    tp_mesh = None    # the mesh of a tensor-parallel FFN (bind_tp)

    def __init__(self, hidden: int, heads: int, ffn: int,
                 dropout_rate: float, attention_impl: str, dtype, device,
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25,
                 partition_model: bool = False,
                 partition_experts: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.attn = SelfAttention(hidden, heads, attention_impl,
                                  dropout_rate, dtype, device,
                                  partition_model)
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.moe = None
        if moe_experts > 0:
            # the 2-D expert layout needs the expert cut first (JAX
            # bert.py:148-153)
            self.moe = MoELayer(hidden, moe_experts, ffn,
                                moe_capacity_factor, moe_top_k,
                                partition_experts,
                                partition_model and partition_experts,
                                dtype=dtype, device=device)
        elif partition_model:
            self.fc1 = ColumnParallelLinear(hidden, ffn, device=device)
            self.fc2 = RowParallelLinear(ffn, hidden, device=device)
        else:
            self.fc1 = nn.Linear(hidden, ffn, device=device)
            self.fc2 = nn.Linear(ffn, hidden, device=device)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)

    def bind_tp(self, mesh, prefix: str = "") -> None:
        """The Megatron FFN (JAX ``bert.py:158-168``); a MoE layer's
        experts are the composite engine's to cut."""
        if isinstance(getattr(self, "fc1", None), ColumnParallelLinear):
            self.fc1.bind(mesh, f"{prefix}.fc1")
            self.fc2.bind(mesh, f"{prefix}.fc2")
            self.tp_mesh = mesh

    def forward(self, x, pad_mask, train: bool = False, generator=None):
        y = self.attn(x, pad_mask, train, generator)
        x = _layer_norm(self.ln1, x + y, self.dtype)
        if self.moe is not None:
            y = moe_ffn(self.moe, x)
        elif self.tp_mesh is not None:
            y = F.gelu(self.fc1(coll.copy_to_model(x, self.tp_mesh),
                                self.dtype), approximate="tanh")
            y = self.fc2(y, self.dtype)
        else:
            y = F.gelu(_dense(self.fc1, x, self.dtype), approximate="tanh")
            y = _dense(self.fc2, y, self.dtype)
        y = _dropout(y, self.dropout_rate, train, generator)
        return _layer_norm(self.ln2, x + y, self.dtype)


class BertEmbeddings(nn.Module):
    """Token + position embeddings → LayerNorm."""

    def __init__(self, vocab_size: int, hidden: int, max_len: int, dtype,
                 device, partition_model: bool = False):
        super().__init__()
        self.dtype = dtype
        self.token_embed = (VocabParallelEmbedding if partition_model
                            else nn.Embedding)(vocab_size, hidden,
                                               device=device)
        self.pos_embed = nn.Embedding(max_len, hidden, device=device)
        self.ln = nn.LayerNorm(hidden, eps=LN_EPS, device=device)

    def forward(self, token_ids, pos):
        x = (self.token_embed(token_ids).to(self.dtype)
             + self.pos_embed(pos).to(self.dtype))
        return _layer_norm(self.ln, x, self.dtype)

    def bind_tp(self, mesh, prefix: str = "") -> None:
        """The vocab-parallel token embedding (JAX ``bert.py:188-192``)."""
        if isinstance(self.token_embed, VocabParallelEmbedding):
            self.token_embed.bind(mesh, f"{prefix}.token_embed")


class BertPooler(nn.Module):
    """[CLS] readout: tanh pooler → classifier logits in f32."""

    def __init__(self, num_classes: int, hidden: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(hidden, hidden, device=device)
        self.classifier = nn.Linear(hidden, num_classes, device=device)

    def forward(self, cls):
        cls = torch.tanh(_dense(self.dense, cls, self.dtype))
        return _dense(self.classifier, cls, self.dtype).float()


class BertTinyClassifier(nn.Module):
    """Token ids (B, L) → class logits (B, num_classes) in f32.

    ``forward(ids, train=..., generator=...)``: ``generator`` feeds the
    dropout of the embeddings, the FFN outputs and (``dense`` only) the
    attention probabilities when ``train``.  Under a sequence-parallel
    ``attention_impl`` the ids are this rank's token block (module
    docstring)."""

    seq_mesh = None   # the mesh of a sequence-parallel model

    def __init__(self, num_classes: int = 2, vocab_size: int = 8192,
                 hidden: int = 128, layers: int = 2, heads: int = 2,
                 ffn: int = 512, max_len: int = 512,
                 dropout_rate: float = 0.1, attention_impl: str = "dense",
                 partition_model: bool = False, remat: bool = False,
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25,
                 partition_experts: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        if remat and moe_experts:
            raise ValueError(
                "remat + MoE layers is unsupported: the router's sown "
                "intermediates would be re-sown during backward recompute "
                "(see models/gpt.py)")
        if attention_impl not in ("dense", "flash", *SEQ_PARALLEL):
            raise ValueError(f"unknown attention_impl '{attention_impl}'; "
                             f"dense | flash, or one of "
                             f"{tuple(SEQ_PARALLEL)}")
        device = resolve_device(device)
        self.num_classes, self.vocab_size = num_classes, vocab_size
        self.hidden, self.layers, self.heads = hidden, layers, heads
        self.ffn, self.max_len = ffn, max_len
        self.dropout_rate = dropout_rate
        self.attention_impl = attention_impl
        self.remat = remat
        self.dtype = dtype
        self.partition_model = partition_model
        self.moe_experts = moe_experts
        self.partition_experts = partition_experts
        self.embeddings = BertEmbeddings(vocab_size, hidden, max_len, dtype,
                                         device, partition_model)
        self.blocks = nn.ModuleList(
            TransformerLayer(hidden, heads, ffn, dropout_rate,
                             attention_impl, dtype, device, moe_experts,
                             moe_top_k, moe_capacity_factor,
                             partition_model, partition_experts)
            for _ in range(layers))
        self.pooler = BertPooler(num_classes, hidden, dtype, device)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's initializers, drawn from ``generator`` (``flax_init_``)."""
        return flax_init_(self, generator)

    def forward(self, token_ids, train: bool = False, generator=None):
        lq = token_ids.shape[1]
        offset, total = block_span(self.attention_impl, self.seq_mesh, lq)
        # an embedding lookup past the table would fail on the card with a
        # device assert; fail here, as the JAX model does
        if total > self.max_len:
            raise ValueError(
                f"sequence length {total} exceeds max_len={self.max_len}; "
                f"raise max_len or shorten the input")
        pad_mask = (token_ids > 0).to(self.dtype)
        pos = offset + torch.arange(lq, device=token_ids.device)[None, :]
        x = self.embeddings(token_ids, pos)
        x = _dropout(x, self.dropout_rate, train, generator)
        for block in self.blocks:
            if self.remat:
                x = _remat(block, x, pad_mask, train, generator=generator)
            else:
                x = block(x, pad_mask, train, generator)
        cls = x[:, 0]                      # [CLS]: global position 0
        if self.attention_impl in SEQ_PARALLEL:
            # only seq rank 0 holds the real [CLS]: every rank's head
            # computes from its copy
            cls = coll.broadcast_from(cls, self.seq_mesh, src=0,
                                      axis=SEQ_AXIS)
        return self.pooler(cls)


# --------------------------------------------------------------------------
# Pipeline stages (``engines.pipeline.PipelineEngine(stages=...)``, JAX
# ``bert.py:282-395``): embed → S identical stages of ``layers_per_stage``
# TransformerLayers → the [CLS] pooler.  The carry is ``(hidden,
# pad_mask)``: later stages never see the token ids, so the mask travels
# with the activations.  No dropout (the schedules run a stage again in
# the backward pass).  ``partition_model`` (pp×tp) is the Megatron layout
# of the embed and the layers; the pooler stays whole, as in JAX.
# --------------------------------------------------------------------------


class BertPipeEmbed(nn.Module):
    """Input stage: token + position embeddings → LayerNorm, and
    ``pad_mask = ids > 0`` in ``dtype``: the carry ``(hidden,
    pad_mask)``.  ``partition_model``: a vocab-parallel token table."""

    def __init__(self, vocab_size: int = 8192, hidden: int = 128,
                 max_len: int = 512, dtype=torch.float32, device=None,
                 partition_model: bool = False):
        super().__init__()
        device = resolve_device(device)
        self._kw = dict(vocab_size=vocab_size, hidden=hidden,
                        max_len=max_len, dtype=dtype, device=device,
                        partition_model=partition_model)
        self.hidden, self.max_len, self.dtype = hidden, max_len, dtype
        self.embeddings = BertEmbeddings(vocab_size, hidden, max_len, dtype,
                                         device, partition_model)

    def reset_parameters(self, generator: torch.Generator | None = None):
        return flax_init_(self, generator)

    def carry_spec(self, x):
        """The carry of ``x`` without running the embed (whose bound
        lookup is a collective)."""
        b, lq = x.shape[:2]
        return tuple, [((b, lq, self.hidden), self.dtype),
                       ((b, lq), self.dtype)]

    def unbound(self) -> "BertPipeEmbed":
        return type(self)(**unbound_kw(self._kw))

    def forward(self, token_ids):
        lq = token_ids.shape[1]
        if lq > self.max_len:
            raise ValueError(
                f"sequence length {lq} exceeds max_len={self.max_len}")
        pad_mask = (token_ids > 0).to(self.dtype)
        pos = torch.arange(lq, device=token_ids.device)[None, :]
        return self.embeddings(token_ids.long(), pos), pad_mask


class BertPipeBlock(nn.Module):
    """One pipeline stage: ``layers_per_stage`` post-LN transformer layers
    with dense attention and dropout 0, over ``(hidden, pad_mask)``;
    ``partition_model``: the Megatron attention and FFN."""

    dropout_rate = 0.0

    def __init__(self, hidden: int = 128, heads: int = 2, ffn: int = 512,
                 layers_per_stage: int = 1, dtype=torch.float32,
                 device=None, partition_model: bool = False):
        super().__init__()
        device = resolve_device(device)
        self._kw = dict(hidden=hidden, heads=heads, ffn=ffn,
                        layers_per_stage=layers_per_stage, dtype=dtype,
                        device=device, partition_model=partition_model)
        self.hidden, self.heads, self.ffn = hidden, heads, ffn
        self.layers_per_stage, self.dtype = layers_per_stage, dtype
        self.layers = nn.ModuleList(
            TransformerLayer(hidden, heads, ffn, 0.0, "dense", dtype, device,
                             partition_model=partition_model)
            for _ in range(layers_per_stage))

    def reset_parameters(self, generator: torch.Generator | None = None):
        return flax_init_(self, generator)

    def unbound(self) -> "BertPipeBlock":
        return type(self)(**unbound_kw(self._kw))

    def forward(self, carry):
        x, pad_mask = carry
        for layer in self.layers:
            x = layer(x, pad_mask)
        return x, pad_mask


class BertPipeHead(nn.Module):
    """Output stage: the [CLS] pooler over the carry's activations."""

    def __init__(self, num_classes: int = 2, hidden: int = 128,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self._kw = dict(num_classes=num_classes, hidden=hidden, dtype=dtype,
                        device=device)
        self.pooler = BertPooler(num_classes, hidden, dtype, device)

    def reset_parameters(self, generator: torch.Generator | None = None):
        return flax_init_(self, generator)

    def unbound(self) -> "BertPipeHead":
        return type(self)(**self._kw)

    def forward(self, carry):
        return self.pooler(carry[0][:, 0])


def bert_pipeline_stages(num_classes: int = 2, vocab_size: int = 8192,
                         hidden: int = 128, heads: int = 2, ffn: int = 512,
                         max_len: int = 512, layers_per_stage: int = 1,
                         partition_model: bool = False, dtype=torch.float32,
                         moe_experts: int = 0, moe_top_k: int = 1,
                         moe_capacity_factor: float = 1.25,
                         partition_experts: bool = False, device=None):
    """(embed, block, head) for ``PipelineEngine(stages=...)``: a BERT
    encoder of depth ``pipe size × layers_per_stage`` (JAX
    ``bert_pipeline_stages``).  ``partition_model`` adds the Megatron
    layout for pp×tp; ``moe_experts`` belongs to the MoE composites and
    raises ``NotImplementedError``."""
    from distributed_tensorflow_tpu_torch.models.gpt import (
        _reject_stage_composites)

    _reject_stage_composites(moe_experts, partition_experts)
    if isinstance(dtype, str):
        from distributed_tensorflow_tpu_torch.models import resolve_dtype
        dtype = resolve_dtype(dtype)
    return (BertPipeEmbed(vocab_size, hidden, max_len, dtype, device,
                          partition_model),
            BertPipeBlock(hidden, heads, ffn, layers_per_stage, dtype,
                          device, partition_model),
            BertPipeHead(num_classes, hidden, dtype, device))
