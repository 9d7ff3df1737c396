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

Not ported here (each raises ``NotImplementedError``): tensor-parallel
partitioning and the pipeline stages (``bert_pipeline_stages``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import not_ported, resolve_device
from distributed_tensorflow_tpu_torch.models.layers import (
    LN_EPS, dense as _dense, dropout as _dropout, flax_init_,
    layer_norm as _layer_norm, remat as _remat)
from distributed_tensorflow_tpu_torch.models.moe import MoELayer, moe_ffn
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel.mesh import SEQ_AXIS
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (
    SEQ_PARALLEL, block_span, dense_attention, seq_parallel_attention)


class SelfAttention(nn.Module):
    """Bidirectional multi-head attention under a (B, L) key mask."""

    seq_mesh = None   # the mesh of a sequence-parallel model (bind_seq_mesh)

    def __init__(self, hidden: int, heads: int, attention_impl: str,
                 dropout_rate: float, dtype, device):
        super().__init__()
        self.heads, self.head_dim = heads, hidden // heads
        self.attention_impl = attention_impl
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        width = heads * self.head_dim
        self.query = nn.Linear(hidden, width, device=device)
        self.key = nn.Linear(hidden, width, device=device)
        self.value = nn.Linear(hidden, width, device=device)
        self.out = nn.Linear(width, hidden, device=device)

    def forward(self, x, pad_mask, train: bool = False, generator=None):
        b, lq, _ = x.shape
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
                def prob_fn(p):
                    return _dropout(p, self.dropout_rate, train, generator)
            out = dense_attention(q, k, v, kv_mask=pad_mask, prob_fn=prob_fn)
        out = out.reshape(b, lq, self.heads * self.head_dim)
        return _dense(self.out, out, self.dtype)


class TransformerLayer(nn.Module):
    """Post-LN encoder layer: LN(x + attn(x)), then LN(x + dropout(ffn))."""

    def __init__(self, hidden: int, heads: int, ffn: int,
                 dropout_rate: float, attention_impl: str, dtype, device,
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.attn = SelfAttention(hidden, heads, attention_impl,
                                  dropout_rate, dtype, device)
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.moe = None
        if moe_experts > 0:
            self.moe = MoELayer(hidden, moe_experts, ffn,
                                moe_capacity_factor, moe_top_k, dtype=dtype,
                                device=device)
        else:
            self.fc1 = nn.Linear(hidden, ffn, device=device)
            self.fc2 = nn.Linear(ffn, hidden, device=device)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS, device=device)

    def forward(self, x, pad_mask, train: bool = False, generator=None):
        y = self.attn(x, pad_mask, train, generator)
        x = _layer_norm(self.ln1, x + y, self.dtype)
        if self.moe is not None:
            y = moe_ffn(self.moe, x)
        else:
            y = F.gelu(_dense(self.fc1, x, self.dtype), approximate="tanh")
            y = _dense(self.fc2, y, self.dtype)
        y = _dropout(y, self.dropout_rate, train, generator)
        return _layer_norm(self.ln2, x + y, self.dtype)


class BertEmbeddings(nn.Module):
    """Token + position embeddings → LayerNorm."""

    def __init__(self, vocab_size: int, hidden: int, max_len: int, dtype,
                 device):
        super().__init__()
        self.dtype = dtype
        self.token_embed = nn.Embedding(vocab_size, hidden, device=device)
        self.pos_embed = nn.Embedding(max_len, hidden, device=device)
        self.ln = nn.LayerNorm(hidden, eps=LN_EPS, device=device)

    def forward(self, token_ids, pos):
        x = (self.token_embed(token_ids).to(self.dtype)
             + self.pos_embed(pos).to(self.dtype))
        return _layer_norm(self.ln, x, self.dtype)


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
                 moe_capacity_factor: float = 1.25, dtype=torch.float32,
                 device=None):
        super().__init__()
        if remat and moe_experts:
            raise ValueError(
                "remat + MoE layers is unsupported: the router's sown "
                "intermediates would be re-sown during backward recompute "
                "(see models/gpt.py)")
        if partition_model:
            not_ported("partition_model (TP layout)", "remaining engines")
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
        self.embeddings = BertEmbeddings(vocab_size, hidden, max_len, dtype,
                                         device)
        self.blocks = nn.ModuleList(
            TransformerLayer(hidden, heads, ffn, dropout_rate,
                             attention_impl, dtype, device, moe_experts,
                             moe_top_k, moe_capacity_factor)
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
