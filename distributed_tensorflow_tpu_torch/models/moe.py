"""Mixture-of-Experts layer and classifier (port of ``models/moe.py``).

The GShard/Switch dense-dispatch formulation, as in JAX: a router in f32
picks each token's expert (top-1, Switch) or two (top-2, GShard), a
cumsum over the token order gives every (token, choice) a slot below the
expert's capacity, and four einsums in the model dtype move the tokens
into ``[G, E, C, d]`` expert buffers, through the stacked expert FFNs
(``relu(x·w1)·w2``, no bias) and back, weighted by the gates.  Shapes are
static: the capacity comes from the input's shape on the host, every
one-hot is a comparison against ``arange`` (a position at or past the
capacity gives a row of zeros, as ``jax.nn.one_hot`` does), and nothing
reads a value back to the host, so a step that runs the layer can be
captured as a CUDA graph.  No part of it is a Pallas kernel in JAX; here
it is plain PyTorch, with library GEMMs under the einsums.

The parameters are JAX's, stacked and in f32: ``gate (d, E)``, ``w1
(E, d, hidden)`` and ``w2 (E, hidden, d)``, each drawn with flax's
``lecun_normal`` (a truncated normal of variance ``1 / fan_in``, where
flax's fan-in of a stacked ``(E, a, b)`` kernel is ``E·a``).
``models/convert.py`` copies them from a flax tree as they are.

JAX sows ``aux_loss`` (the Switch load-balance loss over the top-1
choices), ``z_loss`` (the mean squared logsumexp of the router logits) and
``overflow`` (the share of assignments dropped at capacity) into
``intermediates``.  Here every call leaves them on the layer as 0-d
tensors (``aux_loss`` and ``z_loss`` differentiable, ``overflow`` not);
``engines.expert_parallel.router_losses(model)`` gathers them from every
layer of a model, and an
engine that does not ask for them (``SyncEngine``, as JAX's sync engine
applies the model without ``mutable=["intermediates"]``) drops them.

Expert parallelism: ``ExpertParallelEngine`` binds its ``(data, expert)``
mesh to every layer (``bind_expert_mesh``) and keeps only the rank's slice
of the experts (``keep_experts``).  The layer then routes its rank's
tokens as one group of the GLOBAL batch, as JAX's layer sees it under
GSPMD: the capacity is ``k·cf·T/E`` for the ``T`` tokens of every rank,
and a token's slot is its place in the global token order (rank-major).
One all-gather of each rank's per-expert counts (and of the sums the
router losses need) gives every rank its offsets; the kept tokens travel
to the ranks of the data row that hold their experts through the
differentiable ``all_to_all`` in ``[E, C_send, d]`` buffers, ``C_send =
min(C, T_local)`` (an expert keeps at most ``C`` slots and gets at most
one of a rank's token's choices), and come back by the inverse
``all_to_all``.  The expert FFN works row by row, so where a token sits
in the buffer does not change its output.  The router losses hold the
global values, and their gradients are this rank's share of the global
gradient (the engine sums the shares).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import (
    EP_LEFTOVERS, not_ported, resolve_device)
from distributed_tensorflow_tpu_torch.models.layers import (
    dense, dropout, lecun_normal_)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel.mesh import EXPERT_AXIS

_MOE_GROUP_TARGET = 1024  # ~GShard group size: big enough that per-group
                          # capacity statistics are stable, small enough
                          # that the T×(E·C) dispatch einsums stay linear
                          # in total tokens
_MOE_GROUP_FLOOR = 256    # below this, per-group capacity k·cf·S/E gets so
                          # small that ordinary routing imbalance inside a
                          # group drops tokens wholesale — better one big
                          # group (quadratic dispatch) than quality loss


def _moe_group_size(tokens: int, target: int = _MOE_GROUP_TARGET):
    """Largest power-of-two divisor of ``tokens`` in [floor, target]
    (static).  None — one group — when tokens already fit in ≤target, or
    when the only dividing power-of-two would make groups smaller than the
    floor (e.g. 2000 tokens divide by 16 but not 512: tiny groups drop
    tokens under any routing imbalance, so the quadratic one-group
    dispatch is the better trade)."""
    if tokens <= target:
        return None
    s = target
    while s >= _MOE_GROUP_FLOOR and tokens % s:
        s //= 2
    return s if s >= _MOE_GROUP_FLOOR else None


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``index`` over ``n`` classes; an index outside
    ``[0, n)`` gives a row of zeros (``jax.nn.one_hot``).  A comparison,
    so no range check reads the index on the host."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


class MoELayer(nn.Module):
    """Top-k (k ∈ {1, 2}) routed expert FFN over tokens (the leading axis
    of ``x (tokens, d)``).  ``forward(x, group_size=None)``: a
    ``group_size`` that divides the tokens routes them in independent
    groups of that many (per-group capacity), as GShard's G×S routing."""

    expert_mesh = None    # the (data, expert) mesh of ExpertParallelEngine
    draws_own_params = True  # flax_init_ calls reset_parameters

    def __init__(self, d: int, num_experts: int = 8, hidden: int = 256,
                 capacity_factor: float = 1.25, router_top_k: int = 1,
                 partition_experts: bool = False,
                 partition_model: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        if router_top_k not in (1, 2):
            raise ValueError(
                f"router_top_k must be 1 or 2, got {router_top_k}")
        if partition_experts or partition_model:
            not_ported("partition_experts/partition_model (the GSPMD "
                       "expert layout)", EP_LEFTOVERS)
        device = resolve_device(device)
        self.d, self.num_experts, self.hidden = d, num_experts, hidden
        self.capacity_factor = capacity_factor
        self.router_top_k = router_top_k
        self.dtype = dtype
        self.gate = nn.Parameter(torch.empty(d, num_experts, device=device))
        self.w1 = nn.Parameter(torch.empty(num_experts, d, hidden,
                                           device=device))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden, d,
                                           device=device))
        # the experts this layer holds: all, or an expert-parallel slice
        self.experts = (0, num_experts)
        self.aux_loss = self.z_loss = self.overflow = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's ``lecun_normal`` for the three stacked kernels (fan-in:
        every axis but the last), each drawn whole, so that a layer that
        keeps a slice of the experts holds that slice of the same draw."""
        lo, hi = self.experts
        e, d, h = self.num_experts, self.d, self.hidden
        for p, shape in ((self.gate, (d, e)), (self.w1, (e, d, h)),
                         (self.w2, (e, h, d))):
            full = torch.empty(shape)
            lecun_normal_(full, full.numel() // shape[-1], generator)
            p.copy_(full if p is self.gate else full[lo:hi])
        return self

    def capacity(self, s: int) -> int:
        """Slots per expert for a group of ``s`` tokens (JAX's formula,
        ``+ 0.999999`` included)."""
        return max(1, int(self.router_top_k * self.capacity_factor
                          * s / self.num_experts + 0.999999))

    def keep_experts(self, lo: int, hi: int) -> None:
        """Keep experts ``[lo, hi)`` only: ``w1``/``w2`` become new
        parameters holding that slice (call before an optimizer is built
        over them)."""
        self.w1 = nn.Parameter(self.w1.detach()[lo:hi].clone())
        self.w2 = nn.Parameter(self.w2.detach()[lo:hi].clone())
        self.experts = (lo, hi)

    def _route(self, probs):
        """The chosen experts' masks and gates, each ``[..., E]``."""
        e = self.num_experts
        mask1 = _one_hot(probs.argmax(-1), e)
        if self.router_top_k == 1:
            return mask1, [mask1], [probs]   # top-1 gate = the raw prob
        # second choice: argmax with the first masked out; gates
        # renormalised over the chosen pair (GShard)
        mask2 = _one_hot((probs * (1.0 - mask1)).argmax(-1), e)
        p1 = (probs * mask1).sum(-1, keepdim=True)
        p2 = (probs * mask2).sum(-1, keepdim=True)
        denom = torch.clamp(p1 + p2, min=1e-9)
        return mask1, [mask1, mask2], [mask1 * (p1 / denom),
                                       mask2 * (p2 / denom)]

    def forward(self, x, group_size: int | None = None):
        if self.expert_mesh is not None:
            if group_size is not None:
                not_ported("grouped routing under expert parallelism",
                           EP_LEFTOVERS)
            return self._forward_ep(x)
        tokens, d = x.shape
        gs = group_size
        if gs is not None and 0 < gs < tokens and tokens % gs == 0:
            g, s = tokens // gs, gs
        else:
            g, s = 1, tokens
        xg = x.reshape(g, s, d)
        dispatch, combine = self.route(xg)
        dt = self.dtype
        expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(dt), xg.to(dt))
        h = torch.relu(torch.einsum("gecd,edh->gech", expert_in,
                                    self.w1.to(dt)))
        expert_out = torch.einsum("gech,ehd->gecd", h, self.w2.to(dt))
        y = torch.einsum("gsec,gecd->gsd", combine.to(dt), expert_out)
        return y.reshape(tokens, d)

    def route(self, xg):
        """The router of groups ``xg (G, S, d)``: the f32 ``dispatch`` (1
        where token s takes slot c of expert e) and ``combine`` (that slot's
        gate) tensors, each ``[G, S, E, C]``; leaves ``aux_loss``,
        ``z_loss`` and ``overflow`` on the layer."""
        g, s, _ = xg.shape
        e = self.num_experts
        capacity = self.capacity(s)
        logits = torch.einsum("gsd,de->gse", xg.float(), self.gate.float())
        probs = torch.softmax(logits, dim=-1)
        mask1, masks, gates = self._route(probs)
        # Switch aux loss: E · Σ_e (token fraction · mean router prob), per
        # group, averaged over groups
        self.aux_loss = e * torch.mean(torch.sum(
            mask1.mean(dim=1) * probs.mean(dim=1), dim=-1))
        self.z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        dispatch = torch.zeros((g, s, e, capacity), device=xg.device)
        combine = torch.zeros_like(dispatch)
        offset = torch.zeros((g, e), device=xg.device)  # earlier k's slots
        assigned = kept = 0.0
        for mask, gate in zip(masks, gates):
            position = ((torch.cumsum(mask, dim=1) - 1.0) * mask
                        + offset[:, None, :])
            keep = mask * (position < capacity)
            offset = offset + mask.sum(dim=1)
            pos_onehot = _one_hot(position.long(), capacity)
            dispatch = dispatch + keep[..., None] * pos_onehot
            combine = combine + keep[..., None] * pos_onehot * gate[..., None]
            assigned = assigned + mask.sum()
            kept = kept + keep.sum()
        self.overflow = (1.0 - kept / torch.clamp(assigned, min=1.0)).detach()
        return dispatch, combine

    def _forward_ep(self, x):
        """One group of the global batch (module docstring): this rank's
        ``x (T_local, d)`` routed against every rank's counts, its kept
        tokens run on the experts' ranks of its data row."""
        mesh = self.expert_mesh
        t_local, d = x.shape
        e, k = self.num_experts, self.router_top_k
        n, r = mesh.world_size, mesh.rank
        t = n * t_local
        capacity = self.capacity(t)
        c_send = min(capacity, t_local)
        logits = x.float() @ self.gate.float()
        probs = torch.softmax(logits, dim=-1)
        mask1, masks, gates = self._route(probs)
        lse2 = torch.logsumexp(logits, dim=-1) ** 2
        # every rank's per-choice expert counts, router-prob sums and
        # squared-logsumexp sum, in rank (= global token) order
        mine = torch.cat([torch.stack([m.sum(0) for m in masks]).reshape(-1),
                          probs.sum(0), lse2.sum()[None]]).detach()
        every = coll.all_gather(mine, mesh) if n > 1 else mine[None]
        counts = every[:, :k * e].reshape(n, k, e)
        prefix = counts[:r].sum(0)                       # [k, E]
        total = counts.sum(0)                            # [k, E]
        prob_sum = every[:, k * e:k * e + e].sum(0)
        # the global values, with this rank's share of the gradient
        aux_part = e * torch.sum((total[0] / t) * (probs.sum(0) / t))
        aux = e * torch.sum((total[0] / t) * (prob_sum / t))
        self.aux_loss = aux_part + (aux - aux_part).detach()
        z_part = lse2.sum() / t
        self.z_loss = z_part + (every[:, -1].sum() / t - z_part).detach()
        dispatch = torch.zeros((t_local, e, c_send), device=x.device)
        combine = torch.zeros_like(dispatch)
        offset = torch.zeros(e, device=x.device)   # earlier k's slots
        base = torch.zeros(e, device=x.device)     # this rank's kept so far
        kept = 0.0
        for i, (mask, gate) in enumerate(zip(masks, gates)):
            position = ((torch.cumsum(mask, dim=0) + prefix[i] - 1.0) * mask
                        + offset)
            keep = mask * (position < capacity)
            # the global kept count of choice i: its slots are offset +
            # [0, total), kept below the capacity
            kept = kept + torch.clamp(capacity - offset, min=0.0).minimum(
                total[i]).sum()
            offset = offset + total[i]
            slot = (torch.cumsum(keep, dim=0) - 1.0) * keep + base
            base = base + keep.sum(0)
            onehot = keep[..., None] * _one_hot(slot.long(), c_send)
            dispatch = dispatch + onehot
            combine = combine + onehot * gate[..., None]
        self.overflow = (1.0 - kept / max(k * t, 1)).detach()
        dt = self.dtype
        send = torch.einsum("sec,sd->ecd", dispatch.to(dt), x.to(dt))
        # [E, C_send, d] → this rank's experts' buffers from every rank of
        # its data row, [E / ep, ep · C_send, d]
        recv = coll.all_to_all(send, mesh, split_axis=0, concat_axis=1,
                               axis=EXPERT_AXIS)
        h = torch.relu(torch.einsum("ecd,edh->ech", recv, self.w1.to(dt)))
        out = torch.einsum("ech,ehd->ecd", h, self.w2.to(dt))
        back = coll.all_to_all(out, mesh, split_axis=1, concat_axis=0,
                               axis=EXPERT_AXIS)
        return torch.einsum("sec,ecd->sd", combine.to(dt), back)


def moe_ffn(layer: MoELayer, x: torch.Tensor) -> torch.Tensor:
    """Routed-FFN swap for a transformer block: (B, L, D) tokens →
    (B, L, D) through ``layer`` over the flattened B·L tokens, routed in
    GShard groups of ≤ ``_MOE_GROUP_TARGET`` tokens (``_moe_group_size``).
    The one definition shared by ``GPTBlock`` and BERT's
    ``TransformerLayer``."""
    b, l, d = x.shape
    y = layer(x.reshape(b * l, d), group_size=_moe_group_size(b * l))
    return y.reshape(b, l, d)


def bind_expert_mesh(model: nn.Module, mesh) -> nn.Module:
    """Give every ``MoELayer`` of ``model`` the ``(data, expert)`` mesh it
    routes over (``ExpertParallelEngine``).  Returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, MoELayer):
            mod.expert_mesh = mesh
    return model


class MoEClassifier(nn.Module):
    """embed → (residual MoE layer) × depth → dropout → head, over
    flattened inputs: ``forward(x, train=False, generator=None)`` →
    (B, num_classes) f32 logits.  The first Dense infers its input width
    from the first input (``LazyLinear``), as flax does."""

    def __init__(self, num_classes: int = 10, num_experts: int = 8,
                 embed_dim: int = 128, expert_hidden: int = 256,
                 depth: int = 1, capacity_factor: float = 1.25,
                 router_top_k: int = 1, dropout_rate: float = 0.1,
                 partition_experts: bool = False,
                 partition_model: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.num_experts = num_classes, num_experts
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self.embed = nn.LazyLinear(embed_dim, device=device)
        self.moe = nn.ModuleList(
            MoELayer(embed_dim, num_experts, expert_hidden, capacity_factor,
                     router_top_k, partition_experts, partition_model, dtype,
                     device) for _ in range(depth))
        self.head = nn.Linear(embed_dim, num_classes, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initializers: lecun-normal kernels, zero biases."""
        for lin in (self.embed, self.head):
            lecun_normal_(lin.weight, lin.in_features, generator)
            lin.bias.zero_()
        for layer in self.moe:
            layer.reset_parameters(generator)
        return self

    def forward(self, x, train: bool = False, generator=None):
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        x = F.relu(dense(self.embed, x, self.dtype))
        for layer in self.moe:
            # residual: dropped (over-capacity) tokens pass through
            x = x + layer(x)
        x = dropout(x, self.dropout_rate, train, generator)
        return dense(self.head, x, self.dtype).float()
