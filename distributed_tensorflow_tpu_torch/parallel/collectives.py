"""Collectives on ``torch.distributed`` (port of ``parallel/collectives.py``).

The JAX functions run inside ``shard_map`` over a mesh axis; here each
rank calls the function with its own value and the mesh (``parallel/
mesh.py``), and gets back what JAX's device of the same index gets.  Each
function takes a tensor or a dict of tensors (nested dicts too) and
returns new tensors; the inputs are left as they are.  A mean is a sum
divided by the size (``ReduceOp.AVG`` is not on every gloo build).

Each collective takes ``axis=``, a name of the mesh's axes: it runs over
this rank's sub-group along that axis (``Mesh.group``).  The default,
None, is the world group: the data axis of a 1-D mesh, every rank of a
(data, seq) one.  ``ring_shift``, ``all_to_all`` and ``broadcast_from``
are differentiable (``torch.autograd.Function``), as the dense ``ring``
and ``ulysses`` attentions differentiate through them: a shift's
transpose is the shift by ``-shift``, a tiled all-to-all's is the
all-to-all with its split and concat axes swapped, and a broadcast's is
the sum of every rank's cotangent on ``src`` (zeros elsewhere).

``all_reduce_`` is the in-place sum the engines reduce their flat gradient
(or parameter) buffer with; it counts its calls in
``all_reduce_.launches`` (and the NCCL ones in
``all_reduce_.nccl_launches``), so a run can show its reduce went through
the process group.

Tensor parallelism's Megatron conjugate pair over the 'model' axis:
``copy_to_model`` (identity forward, sum of the gradient backward) and
``reduce_from_model`` (sum forward, identity backward), and
``gather_from_model`` (all-gather along the last dim, backward keeps this
rank's slice); FSDP's ``gather_shards`` (one all-gather of every
parameter slice forward, one reduce-scatter of their gradients backward).
Each counts its collectives (``.launches``, ``.nccl_launches``;
``gather_shards.scatter_launches``).  A pipeline's point-to-point
shifts along 'pipe', ``shift_to_next`` (activations) and
``shift_to_prev`` (cotangents), run outside autograd and count their
batches (``.launches``, ``.nccl_launches``) apart from the copies a pipe
of one makes (``.clones``).  ``neighbor_mean.launches`` counts the gossip mixes
that went round the ring (point-to-point exchanges); a mix whose
neighbourhood covers the ring is an all-reduce and counts there.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

Tree = Any


def _map(fn: Callable, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Tree) -> list:
    out: list = []
    _map(out.append, tree)
    return out


def _rebuild(tree: Tree, leaves) -> Tree:
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


def axis_size(mesh, axis: str | None = None) -> int:
    return mesh.world_size if axis is None else mesh.axis_size(axis)


def axis_index(mesh, axis: str | None = None) -> int:
    return mesh.rank if axis is None else mesh.axis_index(axis)


def _group(mesh, axis):
    return None if axis is None else mesh.group(axis)


def _global(mesh, axis, index: int) -> int:
    """The global rank of ``index`` along ``axis`` (point-to-point ops and
    a broadcast's source take global ranks, whatever the group)."""
    return index if axis is None else mesh.global_rank(axis, index)


def all_reduce_(x: torch.Tensor, mesh, axis: str | None = None
                ) -> torch.Tensor:
    """Sum ``x`` over the ranks, in place; returns ``x``."""
    all_reduce_.launches += 1
    if mesh.backend == "nccl":
        all_reduce_.nccl_launches += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
    return x


all_reduce_.launches = 0
all_reduce_.nccl_launches = 0


def all_reduce_sum(tree: Tree, mesh, axis: str | None = None) -> Tree:
    """Sum across the ranks (the RING allreduce)."""
    return _map(lambda x: all_reduce_(x.clone(), mesh, axis), tree)


def all_reduce_mean(tree: Tree, mesh, axis: str | None = None) -> Tree:
    """Mean across the ranks: the gradient combine of sync DP."""
    n = axis_size(mesh, axis)
    return _map(lambda x: all_reduce_(x.clone(), mesh, axis) / n, tree)


def all_gather(x: torch.Tensor, mesh, *, tiled: bool = False,
               axis: str | None = None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x``: stacked on a new leading axis, or concatenated
    along ``dim`` when ``tiled``.  Not differentiable."""
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=_group(mesh, axis))
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts)


def reduce_scatter_sum(x: torch.Tensor, mesh,
                       axis: str | None = None) -> torch.Tensor:
    """Sum across the ranks, then rank r keeps the r-th of n equal slices
    of the leading dim (``psum_scatter(tiled=True)``)."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by {n}")
    parts = [p.contiguous() for p in x.chunk(n)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM,
                        group=_group(mesh, axis))
    return out


def _all_to_all(x, mesh, axis, split_axis, concat_axis):
    n = axis_size(mesh, axis)
    if n == 1:
        return x.clone()
    send = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
    recv = [torch.empty_like(c) for c in send]
    dist.all_to_all(recv, send, group=_group(mesh, axis))
    return torch.cat(recv, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all; its transpose swaps the split and concat axes."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, concat_axis, split_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, split_axis: int, concat_axis: int,
               axis: str | None = None) -> torch.Tensor:
    """Split ``x`` into n chunks along ``split_axis``, send chunk j to rank
    j, and concatenate what arrives along ``concat_axis`` in rank order
    (``lax.all_to_all(tiled=True)``)."""
    n = axis_size(mesh, axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"not divisible by {n}")
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def _shift_all(xs, mesh, shift: int, axis=None) -> list:
    """Each tensor of ``xs`` from the rank ``shift`` places back along
    ``axis``, in one batch of point-to-point ops."""
    n, r = axis_size(mesh, axis), axis_index(mesh, axis)
    if shift % n == 0:
        return [x.clone() for x in xs]
    to = _global(mesh, axis, (r + shift) % n)
    frm = _global(mesh, axis, (r - shift) % n)
    group = _group(mesh, axis)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, out in zip(xs, outs):
        ops += [dist.P2POp(dist.isend, x, to, group),
                dist.P2POp(dist.irecv, out, frm, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


def _shift(x: torch.Tensor, mesh, shift: int, axis=None) -> torch.Tensor:
    return _shift_all([x], mesh, shift, axis)[0]


class _Shift(torch.autograd.Function):
    """A ring shift of several tensors; its transpose is the shift back.
    Only the cotangents of inputs that need them travel back."""

    @staticmethod
    def forward(ctx, mesh, axis, shift, *xs):
        ctx.args = (mesh, axis, shift)
        return tuple(_shift_all(list(xs), mesh, shift, axis))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axis, shift = ctx.args
        need = [i for i, n in enumerate(ctx.needs_input_grad[3:]) if n]
        back = _shift_all([gs[i] for i in need], mesh, -shift, axis)
        out = [None] * len(gs)
        for i, g in zip(need, back):
            out[i] = g
        return (None, None, None, *out)


def ring_shift(tree: Tree, mesh, shift: int = 1,
               axis: str | None = None) -> Tree:
    """Rotate values around the ring by ``shift``: rank i receives the
    value of rank (i - shift) mod n.  Every tensor of the tree moves in
    one batch of point-to-point ops."""
    return _rebuild(tree, _Shift.apply(mesh, axis, shift, *_leaves(tree)))


def _pipe_shift(fn, tree: Tree, mesh, shift: int, axis: str) -> Tree:
    """``tree`` (no gradient) moved ``shift`` stages along ``axis`` in one
    batch of point-to-point ops, counted on ``fn``."""
    if axis_size(mesh, axis) == 1:
        fn.clones += 1
    else:
        _count(fn, mesh)
    leaves = [t.detach() for t in _leaves(tree)]
    return _rebuild(tree, _shift_all(leaves, mesh, shift, axis))


def shift_to_next(tree: Tree, mesh, axis: str = "pipe") -> Tree:
    """Send ``tree`` to the next stage along ``axis`` and receive the
    previous stage's (the last stage's goes to stage 0, as JAX's
    ``ppermute`` ring sends it): the activations of a pipeline tick.
    Outside autograd: the schedules send detached values and run each
    tick's backward themselves.  ``shift_to_next.launches`` counts the
    batches of point-to-point ops (``.nccl_launches`` those on NCCL) and
    ``.clones`` the shifts along an axis of one rank, which copy and
    launch nothing."""
    return _pipe_shift(shift_to_next, tree, mesh, 1, axis)


def shift_to_prev(tree: Tree, mesh, axis: str = "pipe") -> Tree:
    """``shift_to_next``'s reverse: send to the previous stage, receive
    the next one's (a pipeline's cotangents); counted alike."""
    return _pipe_shift(shift_to_prev, tree, mesh, -1, axis)


for _fn in (shift_to_next, shift_to_prev):
    _fn.launches = _fn.nccl_launches = _fn.clones = 0


def neighbor_mean(tree: Tree, mesh, degree: int = 1) -> Tree:
    """Mean of each rank's value and its ``degree`` ring neighbours on
    each side (gossip averaging): ``2·degree`` exchanges per tensor, so
    the engines pass one flat buffer.  When ``2·degree + 1 >= n`` the
    neighbourhood covers the ring and this is the full mean (JAX
    ``collectives.py:88-92``)."""
    if degree <= 0:
        return tree
    n = mesh.world_size
    if 2 * degree + 1 >= n:
        return all_reduce_mean(tree, mesh)
    neighbor_mean.launches += 1

    def mix(x):
        acc = x.clone()
        for d in range(1, degree + 1):
            acc = acc + _shift(x, mesh, d) + _shift(x, mesh, -d)
        return acc / (2 * degree + 1)

    return _map(mix, tree)


neighbor_mean.launches = 0


class _Broadcast(torch.autograd.Function):
    """``src``'s value on every rank; the transpose sums every rank's
    cotangent onto ``src`` and gives the others zeros."""

    @staticmethod
    def forward(ctx, x, mesh, axis, src):
        ctx.args = (mesh, axis, src)
        out = x.clone()
        if axis_size(mesh, axis) > 1:
            dist.broadcast(out, _global(mesh, axis, src),
                           group=_group(mesh, axis))
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, axis, src = ctx.args
        g = g.contiguous().clone()
        if axis_size(mesh, axis) > 1:
            dist.reduce(g, _global(mesh, axis, src), op=dist.ReduceOp.SUM,
                        group=_group(mesh, axis))
            if axis_index(mesh, axis) != src:
                g.zero_()
        return g, None, None, None


def broadcast_from(tree: Tree, mesh, src: int = 0,
                   axis: str | None = None) -> Tree:
    """Rank ``src``'s value (``src`` indexes ``axis``) on every rank."""
    return _map(lambda x: _Broadcast.apply(x, mesh, axis, src), tree)


# --------------------------------------------------------------------------
# tensor parallelism: the Megatron conjugate pair over the 'model' axis
# --------------------------------------------------------------------------


def _count(fn, mesh) -> None:
    fn.launches += 1
    if mesh.backend == "nccl":
        fn.nccl_launches += 1


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``axis``."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        _count(copy_to_model, mesh)
        return all_reduce_(g.contiguous().clone(), mesh, axis), None, None


def copy_to_model(x: torch.Tensor, mesh, axis: str = "model"
                  ) -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over ``axis``: the input
    of column-parallel layers, which each rank differentiates for its own
    output columns only (Megatron's f).  ``copy_to_model.launches`` counts
    the backward all-reduces."""
    return _CopyToModel.apply(x, mesh, axis)


copy_to_model.launches = 0
copy_to_model.nccl_launches = 0


class _ReduceFromModel(torch.autograd.Function):
    """Sum over ``axis`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        _count(reduce_from_model, mesh)
        return all_reduce_(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from_model(x: torch.Tensor, mesh, axis: str = "model"
                      ) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis``, whose gradient passes
    through as it is: the output of row-parallel layers (Megatron's g).
    ``reduce_from_model.launches`` counts the forward all-reduces."""
    return _ReduceFromModel.apply(x, mesh, axis)


reduce_from_model.launches = 0
reduce_from_model.nccl_launches = 0


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last dim; the backward keeps this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis, x.shape[-1])
        _count(gather_from_model, mesh)
        return all_gather(x, mesh, tiled=True, axis=axis, dim=-1)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, width = ctx.args
        r = axis_index(mesh, axis)
        return g.narrow(-1, r * width, width).contiguous(), None, None


def gather_from_model(x: torch.Tensor, mesh, axis: str = "model"
                      ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dim, in rank order
    (the vocab-sharded logits made whole); the backward takes this rank's
    slice of the cotangent.  ``gather_from_model.launches`` counts the
    all-gathers."""
    return _GatherFromModel.apply(x, mesh, axis)


gather_from_model.launches = 0
gather_from_model.nccl_launches = 0


# --------------------------------------------------------------------------
# FSDP: every parameter slice gathered for use, the gradients scattered back
# --------------------------------------------------------------------------

# each slice starts this many elements into the flat buffer (512 bytes at
# f32): a gathered leaf on one rank is a view of the buffer as aligned as a
# tensor of its own
_ALIGN = 128


def _layout(shapes) -> tuple[list[int], int]:
    """Each slice's offset in the flat buffer (aligned), and its length."""
    offs, total = [], 0
    for shape in shapes:
        offs.append(total)
        n = int(torch.Size(shape).numel())
        total += -(-n // _ALIGN) * _ALIGN
    return offs, total


class _GatherShards(torch.autograd.Function):
    """One all-gather of every slice packed in a flat buffer; backward, one
    reduce-scatter of the leaves' gradients packed alike."""

    @staticmethod
    def forward(ctx, mesh, axis, dims, *shards):
        n = axis_size(mesh, axis)
        shapes = [tuple(t.shape) for t in shards]
        offs, total = _layout(shapes)
        pieces = []
        for t, o, nxt in zip(shards, offs, offs[1:] + [total]):
            pieces.append(t.reshape(-1))
            if nxt - o > t.numel():
                pieces.append(t.new_zeros(nxt - o - t.numel()))
        flat = torch.cat(pieces)
        out = flat.new_empty(n * total)
        _count(gather_shards, mesh)
        dist.all_gather_into_tensor(out, flat, group=_group(mesh, axis))
        rows = out.view(n, total)
        whole = []
        for shape, dim, o in zip(shapes, dims, offs):
            size = int(torch.Size(shape).numel())
            t = rows[:, o:o + size].reshape(n, *shape).movedim(0, dim)
            full = list(shape)
            full[dim] *= n
            whole.append(t.reshape(full))
        ctx.args = (mesh, axis, dims, shapes, offs, total)
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axis, dims, shapes, offs, total = ctx.args
        n = axis_size(mesh, axis)
        ref = next(g for g in grads if g is not None)
        pieces = []
        for g, shape, dim, o, nxt in zip(grads, shapes, dims, offs,
                                         offs[1:] + [total]):
            size = int(torch.Size(shape).numel())
            if g is None:
                piece = ref.new_zeros(n, size)
            else:
                split = shape[:dim] + (n, shape[dim]) + shape[dim + 1:]
                piece = g.reshape(split).movedim(dim, 0).reshape(n, size)
            pieces.append(piece)
            if nxt - o > size:
                pieces.append(ref.new_zeros(n, nxt - o - size))
        packed = torch.cat(pieces, dim=1).reshape(-1)
        out = packed.new_empty(total)
        gather_shards.scatter_launches += 1
        if mesh.backend == "nccl":
            gather_shards.nccl_scatter_launches += 1
        dist.reduce_scatter_tensor(out, packed, op=dist.ReduceOp.SUM,
                                   group=_group(mesh, axis))
        return (None, None, None, *[
            out[o:o + int(torch.Size(shape).numel())].view(shape)
            for shape, o in zip(shapes, offs)])


def gather_shards(shards: list, dims: list[int], mesh,
                  axis: str | None = None) -> tuple:
    """The whole tensors of which ``shards`` are this rank's slices, each
    along its dim of ``dims`` (slices in rank order along ``axis``), made
    by one all-gather of every slice packed in a flat buffer (one dtype);
    their gradients are summed over the ranks by one reduce-scatter and
    cut to this rank's slices.  ``gather_shards.launches`` counts the
    all-gathers and ``.scatter_launches`` the reduce-scatters (with
    ``nccl_`` twins)."""
    return _GatherShards.apply(mesh, axis, list(dims), *shards)


gather_shards.launches = 0
gather_shards.nccl_launches = 0
gather_shards.scatter_launches = 0
gather_shards.nccl_scatter_launches = 0
