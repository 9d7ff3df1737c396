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

Expert parallelism: an engine binds its mesh to every layer
(``bind_expert_mesh``) and keeps the rank's slice of the experts
(``keep_experts``) and, under the 2-D layout, of each expert's hidden
width (``keep_hidden``).  The layer then routes its rank's tokens as part
of the GLOBAL token order that JAX's layer sees under GSPMD: the tokens
sharded over the mesh's ``token_axes`` (rank-major: a rank holds one
contiguous run of that order), cut into groups of ``group_size`` (one
group when it does not divide), each with its capacity ``k·cf·S/E``, a
token's slot being its place in its group's order.  One all-gather over
the token axes of each rank's per-group, per-choice expert counts (and
of the sums the router losses need) gives every rank its prefix counts
in each group it touches, so a group may lie inside a rank or span
ranks.  A rank's run is padded to segments of one group each, and its
kept tokens fill ``[E, segments · C_send, d]`` expert buffers, ``C_send =
min(C, segment)``.  Two routes move them to the experts:

* ``all_to_all`` (``ExpertParallelEngine``: tokens shard over 'expert'
  too): the buffers travel to the experts' ranks of the expert axis
  through the differentiable ``all_to_all`` and come back by the inverse
  one;
* ``replicated`` (``CompositeEngine``: tokens are replicated over
  'expert'): every rank of an expert line holds the same tokens and the
  same dispatch, runs its own experts on it, and the combine is summed
  over 'expert' (``reduce_from_model``); the tokens and the gates enter
  the rank's experts through ``copy_to_model``, whose backward sums the
  experts' partial cotangents over 'expert'.

The 2-D expert layout (``partition_model``, which needs
``partition_experts``, JAX ``moe.py:150-171``): ``w1 (E, d, h)`` is
column-parallel and ``w2 (E, h, d)`` row-parallel over 'model', each
expert's FFN the Megatron pair (``copy_to_model`` before ``w1``,
``reduce_from_model`` summing the ``[E/ep, C, d]`` partial outputs after
``w2``).  The expert FFN works row by row, so where a token sits in a
buffer does not change its output.  The router losses hold the global
values (per-group means averaged over the groups, as JAX's), and their
gradients are this rank's share of the global gradient (the engine sums
the shares).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch import resolve_device
from distributed_tensorflow_tpu_torch.models.layers import (
    check_divisible, dense, dropout, lecun_normal_)
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS)

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
    ``group_size`` that divides the tokens (the global tokens, when a mesh
    is bound) routes them in independent groups of that many (per-group
    capacity), as GShard's G×S routing.  ``partition_experts`` and
    ``partition_model`` are JAX's layout flags (module docstring): the
    engines read them; ``partition_model`` needs ``partition_experts``."""

    # the mesh the layer routes over, and how (bind_expert_mesh)
    expert_mesh = None
    token_axes: tuple = ()
    expert_route = "all_to_all"
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
        if partition_model and not partition_experts:
            raise ValueError(
                "partition_model on MoELayer means ep×tp (Megatron split "
                "inside each expert) and requires partition_experts=True")
        device = resolve_device(device)
        self.d, self.num_experts, self.hidden = d, num_experts, hidden
        self.capacity_factor = capacity_factor
        self.router_top_k = router_top_k
        self.partition_experts = partition_experts
        self.partition_model = partition_model
        self.dtype = dtype
        self.gate = nn.Parameter(torch.empty(d, num_experts, device=device))
        self.w1 = nn.Parameter(torch.empty(num_experts, d, hidden,
                                           device=device))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden, d,
                                           device=device))
        # the experts and the hidden columns this layer holds: all, or an
        # expert-parallel (and 2-D) slice
        self.experts = (0, num_experts)
        self.hidden_cols = (0, hidden)
        self.aux_loss = self.z_loss = self.overflow = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's ``lecun_normal`` for the three stacked kernels (fan-in:
        every axis but the last), each drawn whole, so that a layer that
        keeps a slice of the experts (and of their hidden width) holds
        that slice of the same draw."""
        lo, hi = self.experts
        c0, c1 = self.hidden_cols
        e, d, h = self.num_experts, self.d, self.hidden
        for p, shape in ((self.gate, (d, e)), (self.w1, (e, d, h)),
                         (self.w2, (e, h, d))):
            full = torch.empty(shape)
            lecun_normal_(full, full.numel() // shape[-1], generator)
            p.copy_(full if p is self.gate else
                    full[lo:hi, :, c0:c1] if p is self.w1 else
                    full[lo:hi, c0:c1])
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

    def keep_hidden(self, lo: int, hi: int) -> None:
        """Keep hidden columns ``[lo, hi)`` of every expert's FFN only:
        ``w1``'s output columns and ``w2``'s input rows (the 2-D layout's
        'model' slice; call before an optimizer is built)."""
        self.w1 = nn.Parameter(self.w1.detach()[:, :, lo:hi].clone())
        self.w2 = nn.Parameter(self.w2.detach()[:, lo:hi].clone())
        self.hidden_cols = (lo, hi)

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

    def token_shards(self) -> tuple[int, int]:
        """(ranks whose tokens are routed together, this rank's index
        among them): the bound mesh's token axes, row-major; (1, 0)
        unbound."""
        n, r = 1, 0
        for a in self.token_axes:
            size = self.expert_mesh.axis_size(a)
            n, r = n * size, r * size + self.expert_mesh.axis_index(a)
        return n, r

    def forward(self, x, group_size: int | None = None):
        if self.expert_mesh is not None:
            return self._forward_mesh(x, group_size)
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

    def _gather_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """Every token shard's ``t``, stacked in token order: an all-gather
        over the token axes (over the whole group, this rank's line kept,
        when they are not one axis)."""
        mesh, axes = self.expert_mesh, self.token_axes
        n, _ = self.token_shards()
        if n == 1:
            return t[None]
        if len(axes) == 1:
            return coll.all_gather(t, mesh, axis=axes[0])
        every = coll.all_gather(t, mesh)
        if n == mesh.world_size:
            return every
        line = tuple(slice(None) if a in axes else mesh.axis_index(a)
                     for a in mesh.axis_names)
        return every.reshape(*mesh.dims, *t.shape)[line].reshape(
            n, *t.shape)

    def _experts(self, buf: torch.Tensor) -> torch.Tensor:
        """This rank's experts on their buffers ``[E_local, ..., d]``; under
        the 2-D layout each rank holds a slice of every expert's hidden
        width, and the partial outputs are summed over 'model'."""
        mesh, dt = self.expert_mesh, self.dtype
        shape = buf.shape
        buf = buf.reshape(shape[0], -1, shape[-1])
        split = self.model_split
        if split:
            buf = coll.copy_to_model(buf, mesh, axis=MODEL_AXIS)
        h = torch.relu(torch.einsum("ecd,edh->ech", buf, self.w1.to(dt)))
        out = torch.einsum("ech,ehd->ecd", h, self.w2.to(dt))
        if split:
            out = coll.reduce_from_model(out, mesh, axis=MODEL_AXIS)
        return out.reshape(shape)

    def _forward_mesh(self, x, group_size):
        """This rank's ``x (T_local, d)``, a contiguous run of the global
        token order, routed in groups of that order against every token
        shard's counts (module docstring)."""
        mesh = self.expert_mesh
        t_local, d = x.shape
        e, k = self.num_experts, self.router_top_k
        n, r = self.token_shards()
        t = n * t_local
        gs = group_size
        s = gs if gs is not None and 0 < gs < t and t % gs == 0 else t
        n_groups, capacity = t // s, self.capacity(s)
        start = r * t_local
        g0, g1 = start // s, (start + t_local - 1) // s
        # this rank's run cut at the group boundaries: one segment per
        # group it touches, padded to the longest
        segs = [(max(g * s, start) - start,
                 min((g + 1) * s, start + t_local) - start)
                for g in range(g0, g1 + 1)]
        gl, width = len(segs), max(b - a for a, b in segs)
        if gl * width == t_local:
            def pad(a):
                return a.reshape(gl, width, *a.shape[1:])

            def unpad(a):
                return a.reshape(t_local, *a.shape[2:])
        else:
            where = torch.cat([j * width + torch.arange(b - a)
                               for j, (a, b) in enumerate(segs)]).to(x.device)

            def pad(a):
                out = a.new_zeros((gl * width, *a.shape[1:]))
                return out.index_copy(0, where, a).reshape(
                    gl, width, *a.shape[1:])

            def unpad(a):
                return a.reshape(gl * width, *a.shape[2:])[where]

        replicated = self.expert_route == "replicated" and self.expert_split
        logits = x.float() @ self.gate.float()
        probs = torch.softmax(logits, dim=-1)
        lse2 = torch.logsumexp(logits, dim=-1) ** 2
        # replicated tokens: the gates reach this rank's experts only, so
        # their cotangents are summed over 'expert'
        mask1, masks, gates = self._route(
            coll.copy_to_model(probs, mesh, axis=EXPERT_AXIS)
            if replicated else probs)
        masks = [pad(m) for m in masks]
        gates = [pad(g) for g in gates]
        # every shard's per-group, per-choice expert counts and router-prob
        # sums, and its squared-logsumexp sum, in token order
        psum = pad(probs).sum(1)                          # [gl, E]
        mine = torch.zeros(n_groups, k + 1, e, device=x.device)
        mine[g0:g1 + 1] = torch.cat([torch.stack([m.sum(1) for m in masks],
                                                 1), psum.detach()[:, None]],
                                    1)
        every = self._gather_tokens(torch.cat([mine.reshape(-1),
                                               lse2.sum().detach()[None]]))
        counts = every[:, :-1].reshape(n, n_groups, k + 1, e)
        total = counts[:, :, :k].sum(0)                   # [G, k, E]
        prefix = counts[:r, :, :k].sum(0)                 # [G, k, E]
        prob_sum = counts[:, :, k].sum(0)                 # [G, E]
        # the global values (per-group means averaged over the groups),
        # with this rank's share of the gradient
        frac = total[:, 0] / s
        aux = e * torch.sum(frac * (prob_sum / s)) / n_groups
        aux_part = e * torch.sum(frac[g0:g1 + 1] * (psum / s)) / n_groups
        self.aux_loss = aux_part + (aux - aux_part).detach()
        z_part = lse2.sum() / t
        self.z_loss = z_part + (every[:, -1].sum() / t - z_part).detach()
        c_send = min(capacity, width)
        dispatch = torch.zeros((gl, width, e, c_send), device=x.device)
        combine = torch.zeros_like(dispatch)
        offset = torch.zeros(n_groups, e, device=x.device)  # earlier k's
        base = torch.zeros(gl, e, device=x.device)   # this rank's kept so far
        kept = 0.0
        for i, (mask, gate) in enumerate(zip(masks, gates)):
            position = ((torch.cumsum(mask, dim=1)
                         + prefix[g0:g1 + 1, i, None] - 1.0) * mask
                        + offset[g0:g1 + 1, None])
            keep = mask * (position < capacity)
            # the global kept count of choice i: each group's slots are
            # offset + [0, total), kept below the capacity
            kept = kept + torch.clamp(capacity - offset, min=0.0).minimum(
                total[:, i]).sum()
            offset = offset + total[:, i]
            slot = (torch.cumsum(keep, dim=1) - 1.0) * keep + base[:, None]
            base = base + keep.sum(1)
            onehot = keep[..., None] * _one_hot(slot.long(), c_send)
            dispatch = dispatch + onehot
            combine = combine + onehot * gate[..., None]
        self.overflow = (1.0 - kept / max(k * t, 1)).detach()
        dt = self.dtype
        if self.expert_route == "all_to_all":
            send = torch.einsum("gsec,gsd->egcd", dispatch.to(dt),
                                pad(x).to(dt)).reshape(e, gl * c_send, d)
            # [E, gl·C_send, d] → this rank's experts' buffers from every
            # rank of its expert line, [E / ep, ep · gl · C_send, d]
            recv = coll.all_to_all(send, mesh, split_axis=0, concat_axis=1,
                                   axis=EXPERT_AXIS)
            back = coll.all_to_all(self._experts(recv), mesh, split_axis=1,
                                   concat_axis=0, axis=EXPERT_AXIS)
            y = torch.einsum("gsec,egcd->gsd", combine.to(dt),
                             back.reshape(e, gl, c_send, d))
            return unpad(y)
        # replicated tokens: this rank's experts on the shared dispatch
        lo, hi = self.experts
        xr = (coll.copy_to_model(x, mesh, axis=EXPERT_AXIS) if replicated
              else x)
        send = torch.einsum("gsec,gsd->egcd", dispatch[:, :, lo:hi].to(dt),
                            pad(xr).to(dt))
        y = unpad(torch.einsum("gsec,egcd->gsd",
                               combine[:, :, lo:hi].to(dt),
                               self._experts(send)))
        if replicated:
            y = coll.reduce_from_model(y, mesh, axis=EXPERT_AXIS)
        return y

    @property
    def expert_split(self) -> bool:
        """Whether the bound mesh cuts the experts over 'expert'."""
        return (self.expert_mesh is not None
                and EXPERT_AXIS in self.expert_mesh.axis_names)

    @property
    def model_split(self) -> bool:
        """Whether the bound mesh cuts every expert's hidden width over
        'model' (the 2-D layout)."""
        return (self.partition_model and self.expert_mesh is not None
                and MODEL_AXIS in self.expert_mesh.axis_names)


def moe_ffn(layer: MoELayer, x: torch.Tensor) -> torch.Tensor:
    """Routed-FFN swap for a transformer block: (B, L, D) tokens →
    (B, L, D) through ``layer`` over the flattened B·L tokens, routed in
    GShard groups of ≤ ``_MOE_GROUP_TARGET`` tokens (``_moe_group_size``)
    of the GLOBAL token count: under a bound mesh, every token shard's
    B·L (JAX's 'data' axis is GSPMD-global inside its 'seq' shard_map).
    The one definition shared by ``GPTBlock`` and BERT's
    ``TransformerLayer``."""
    b, l, d = x.shape
    n, _ = layer.token_shards()
    y = layer(x.reshape(b * l, d), group_size=_moe_group_size(n * b * l))
    return y.reshape(b, l, d)


def bind_expert_mesh(model: nn.Module, mesh,
                     token_axes: tuple[str, ...] = (DATA_AXIS, EXPERT_AXIS),
                     route: str = "all_to_all") -> nn.Module:
    """Give every ``MoELayer`` of ``model`` the mesh it routes over: the
    axes ``token_axes`` shard its tokens (taken in the mesh's order), and
    ``route`` says how the tokens reach the experts ('all_to_all':
    ``ExpertParallelEngine``; 'replicated': ``CompositeEngine``, module
    docstring).  Returns ``model``."""
    if route not in ("all_to_all", "replicated"):
        raise ValueError(f"unknown expert route '{route}'")
    axes = tuple(a for a in mesh.axis_names if a in token_axes)
    for mod in model.modules():
        if isinstance(mod, MoELayer):
            mod.expert_mesh, mod.token_axes = mesh, axes
            mod.expert_route = route
    return model


def _cuts(m: MoELayer, mesh, every_layer: bool) -> tuple[bool, bool]:
    """Whether a bound mesh cuts layer ``m``'s experts over 'expert'
    (every layer with ``every_layer``, as ``ExpertParallelEngine`` cuts
    them; else the ``partition_experts`` ones) and its hidden width over
    'model' (the 2-D layout)."""
    return (EXPERT_AXIS in mesh.axis_names
            and (every_layer or m.partition_experts),
            m.partition_model and MODEL_AXIS in mesh.axis_names)


def expert_specs(model: nn.Module, mesh, every_layer: bool = False
                 ) -> dict[str, tuple]:
    """The layout over ``mesh`` of every expert kernel ``shard_experts``
    cuts (``Engine.param_specs``): ``w1 (E, d, h)`` as ('expert', None,
    'model') and ``w2 (E, h, d)`` as ('expert', 'model', None), each axis
    present where it cuts."""
    specs = {}
    for name, m in model.named_modules():
        if isinstance(m, MoELayer):
            ex, hid = _cuts(m, mesh, every_layer)
            e_axis = EXPERT_AXIS if ex else None
            h_axis = MODEL_AXIS if hid else None
            if ex or hid:
                specs[f"{name}.w1"] = (e_axis, None, h_axis)
                specs[f"{name}.w2"] = (e_axis, h_axis, None)
    return specs


def shard_experts(model: nn.Module, mesh, every_layer: bool = False) -> None:
    """Keep this rank's slice of every ``MoELayer`` of ``model`` that the
    mesh cuts (``_cuts``; once, a later init draws into the slice):
    experts ``[x·E/ep, (x+1)·E/ep)`` of its 'expert' index x, and its
    'model' index's columns of every expert's hidden width."""
    for name, m in model.named_modules():
        if not isinstance(m, MoELayer):
            continue
        ex, hid = _cuts(m, mesh, every_layer)
        if ex:
            # the engines check that the experts split over 'expert'
            per = m.num_experts // mesh.axis_size(EXPERT_AXIS)
            lo = mesh.axis_index(EXPERT_AXIS) * per
            if m.experts != (lo, lo + per):
                m.keep_experts(lo, lo + per)
        if hid:
            tp = mesh.axis_size(MODEL_AXIS)
            check_divisible(f"{name}.w1", (m.num_experts, m.d, m.hidden), 2,
                            tp)
            per = m.hidden // tp
            lo = mesh.axis_index(MODEL_AXIS) * per
            if m.hidden_cols != (lo, lo + per):
                m.keep_hidden(lo, lo + per)


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
