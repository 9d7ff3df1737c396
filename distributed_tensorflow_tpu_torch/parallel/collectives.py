"""Collectives on ``torch.distributed`` (port of ``parallel/collectives.py``).

The JAX functions run inside ``shard_map`` over a mesh axis; here each
rank calls the function with its own value and the mesh (``parallel/
mesh.py``), and gets back what JAX's device of the same index gets.  Each
function takes a tensor or a dict of tensors (nested dicts too) and
returns new tensors; the inputs are left as they are.  A mean is a sum
divided by the size (``ReduceOp.AVG`` is not on every gloo build).

``all_reduce_`` is the in-place sum the engines reduce their flat gradient
(or parameter) buffer with; it counts its calls in
``all_reduce_.launches`` (and the NCCL ones in
``all_reduce_.nccl_launches``), so a run can show its reduce went through
the process group.  ``neighbor_mean.launches`` counts the gossip mixes
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
    return fn(tree)


def axis_size(mesh) -> int:
    return mesh.world_size


def axis_index(mesh) -> int:
    return mesh.rank


def all_reduce_(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``x`` over the ranks, in place; returns ``x``."""
    all_reduce_.launches += 1
    if mesh.backend == "nccl":
        all_reduce_.nccl_launches += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


all_reduce_.launches = 0
all_reduce_.nccl_launches = 0


def all_reduce_sum(tree: Tree, mesh) -> Tree:
    """Sum across the ranks (the RING allreduce)."""
    return _map(lambda x: all_reduce_(x.clone(), mesh), tree)


def all_reduce_mean(tree: Tree, mesh) -> Tree:
    """Mean across the ranks: the gradient combine of sync DP."""
    n = mesh.world_size
    return _map(lambda x: all_reduce_(x.clone(), mesh) / n, tree)


def all_gather(x: torch.Tensor, mesh, *, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x``: stacked on a new leading axis, or concatenated
    along the leading axis when ``tiled``."""
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts) if tiled else torch.stack(parts)


def reduce_scatter_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum across the ranks, then rank r keeps the r-th of n equal slices
    of the leading dim (``psum_scatter(tiled=True)``)."""
    n = mesh.world_size
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by {n}")
    parts = [p.contiguous() for p in x.chunk(n)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM)
    return out


def all_to_all(x: torch.Tensor, mesh, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Split ``x`` into n chunks along ``split_axis``, send chunk j to rank
    j, and concatenate what arrives along ``concat_axis`` in rank order
    (``lax.all_to_all(tiled=True)``)."""
    n = mesh.world_size
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"not divisible by {n}")
    send = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
    recv = [torch.empty_like(c) for c in send]
    dist.all_to_all(recv, send)
    return torch.cat(recv, dim=concat_axis)


def _shift(x: torch.Tensor, mesh, shift: int) -> torch.Tensor:
    n, r = mesh.world_size, mesh.rank
    if shift % n == 0:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), (r + shift) % n),
           dist.P2POp(dist.irecv, out, (r - shift) % n)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def ring_shift(tree: Tree, mesh, shift: int = 1) -> Tree:
    """Rotate values around the ring by ``shift``: rank i receives the
    value of rank (i - shift) mod n."""
    return _map(lambda x: _shift(x, mesh, shift), tree)


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


def broadcast_from(tree: Tree, mesh, src: int = 0) -> Tree:
    """Rank ``src``'s value on every rank."""
    def bcast(x):
        out = x.clone()
        dist.broadcast(out, src)
        return out

    return _map(bcast, tree)
