"""Gradient codecs and the int8 channel codec (port of
``parallel/compression.py``).

The cost of exchanging gradients between workers is the subject of the
reference; ``--grad-compression {none,bf16,int8}`` makes that exchange a
knob.  Three codecs behind one interface:

* ``none`` — the plain collective: a sum or mean of the values as they
  are.
* ``bf16`` — floating leaves wider than 2 bytes are cast to bfloat16 for
  the exchange, the collective (its in-flight additions included) runs in
  bf16, and the result is widened back after it.  fp16 and bf16 leaves
  pass at their own width.
* ``int8`` — one max-abs scale per leaf, values rounded (stochastically
  with a generator) to int8 in [-127, 127], and the two-phase compressed
  all-reduce (``Int8Codec``): 1 byte per element plus one f32 scale per
  leaf on the wire.

Each collective takes a list, tuple or dict of tensors (nested too), the
mesh (``parallel/mesh.py``; None: one rank, no collective, the codec's
arithmetic all the same) and ``axis`` (None: the world group), and
returns new tensors of the inputs' shapes and dtypes.  ``generator`` is
the codec's rounding stream (``Engine.codec_step_generator``): the
engines pass a per-rank stream where each rank quantizes its own value
(sync gradients, async and gossip parameters) and a rank-invariant one
where the quantized value is replicated (the ``roundtrip`` of the
sequence- and expert-parallel engines, whose collective is the exact
all-reduce and whose codec reproduces the numbers of a compressed
exchange).  JAX folds a key per leaf; here one generator draws for the
leaves in turn, so the draws differ from JAX's and only the deterministic
rounding (no generator: round to nearest, ties to even, as ``jnp.round``)
is bitwise JAX's.

The ``none`` and ``bf16`` codecs are elementwise, so they move the leaves
of one dtype as one flat buffer through one collective; the numbers are
those of a collective per leaf.  The int8 codec moves every leaf through
one ``all_to_all`` and three ``all_gather`` calls (``Int8Codec``).  The
collectives the codec issues besides ``collectives.all_reduce_`` count in
``all_to_all_.launches`` and ``all_gather_.launches`` (``.nccl_launches``
for the NCCL ones).
"""

from __future__ import annotations

from typing import Any, Iterable

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.parallel import collectives as coll

Tree = Any

CODECS = ("none", "bf16", "int8")

# the word that separates the codec's rounding stream from the dropout
# stream of the same step ("comp" in ASCII, JAX's fold tag)
RNG_TAG = 0x636F6D70

_TINY = torch.finfo(torch.float32).tiny
_INF = float("inf")


def _numel(shape) -> int:
    size = 1
    for d in shape:
        size *= int(d)
    return size


def _itemsize(dtype) -> int:
    return int(dtype.itemsize)


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` as a true division on every device: a CUDA tensor
    divided by a Python number is multiplied by the reciprocal, which can
    differ by an ulp from the CPU's (and XLA's) quotient."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def _size(mesh, axis) -> int:
    return 1 if mesh is None else coll.axis_size(mesh, axis)


def _backend(mesh) -> str | None:
    return None if mesh is None else mesh.backend


def all_to_all_(x: torch.Tensor, mesh, axis=None) -> torch.Tensor:
    """Row j of ``x`` (n rows) to rank j; returns the rows received, in
    rank order (one ``all_to_all_single``)."""
    all_to_all_.launches += 1
    if _backend(mesh) == "nccl":
        all_to_all_.nccl_launches += 1
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=coll._group(mesh, axis))
    return out


all_to_all_.launches = 0
all_to_all_.nccl_launches = 0


def all_gather_(x: torch.Tensor, mesh, axis=None) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis."""
    all_gather_.launches += 1
    if _backend(mesh) == "nccl":
        all_gather_.nccl_launches += 1
    return coll.all_gather(x, mesh, axis=axis)


all_gather_.launches = 0
all_gather_.nccl_launches = 0


def _grouped(leaves: list, wire, fn) -> list:
    """Apply ``fn`` to one flat buffer per dtype: the leaves of a dtype
    are concatenated, cast to ``wire(dtype)``, passed through ``fn``, cast
    back and split into views of the leaves' shapes."""
    out: list = [None] * len(leaves)
    groups: dict = {}
    for i, x in enumerate(leaves):
        groups.setdefault(x.dtype, []).append(i)
    for dtype, idx in groups.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        back = fn(flat.to(wire(dtype))).to(dtype)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = back[off:off + n].view(leaves[i].shape)
            off += n
    return out


def _tree_op(tree: Tree, fn) -> Tree:
    """``fn`` over the list of the tree's tensors, rebuilt as the tree."""
    leaves = coll._leaves(tree)
    if not leaves:
        return tree
    return coll._rebuild(tree, fn(leaves))


class GradCodec:
    """``none``: the plain collectives, and the base of the real codecs.
    Engines call the codec unconditionally; at ``none`` without bucketing
    they keep their pre-codec programs (``codec_active``)."""

    name = "none"

    # ------------------------------------------------------------ payload
    def leaf_wire_bytes(self, shape, dtype) -> int:
        """Bytes this leaf occupies on the wire (one collective round)."""
        return _numel(shape) * _itemsize(dtype)

    def wire_bytes(self, leaves: Iterable[Any]) -> int:
        """Wire payload of one collective round over ``leaves`` (anything
        with ``.shape`` and a torch ``.dtype``)."""
        return int(sum(self.leaf_wire_bytes(a.shape, a.dtype)
                       for a in leaves))

    # -------------------------------------------------------- collectives
    def _wire(self, dtype):
        return dtype

    def _collective(self, tree, fn):
        return _tree_op(tree, lambda leaves: _grouped(leaves, self._wire,
                                                      fn))

    def all_reduce_sum(self, tree: Tree, mesh, axis=None, *,
                       generator=None) -> Tree:
        del generator
        if mesh is None:
            return self._collective(tree, lambda x: x)
        return self._collective(tree,
                                lambda x: coll.all_reduce_(x, mesh, axis))

    def all_reduce_mean(self, tree: Tree, mesh, axis=None, *,
                        generator=None) -> Tree:
        del generator
        n = _size(mesh, axis)
        if mesh is None:
            return self._collective(tree, lambda x: _div(x, n))
        return self._collective(
            tree, lambda x: _div(coll.all_reduce_(x, mesh, axis), n))

    def neighbor_mean(self, tree: Tree, mesh, degree: int = 1, *,
                      generator=None) -> Tree:
        """The mean of each rank's value and its ``degree`` ring
        neighbours' on each side (the world group's ring)."""
        del generator
        if degree <= 0:
            return tree
        if mesh is None or 2 * degree + 1 >= mesh.world_size:
            return self.all_reduce_mean(tree, mesh)
        return self._collective(
            tree, lambda x: coll.neighbor_mean(x, mesh, degree))

    # ------------------------------------------------------------ roundtrip
    def roundtrip(self, tree: Tree, *, generator=None) -> Tree:
        """Encode and decode each leaf with no collective: the numbers of
        a compressed exchange, for engines whose collective stays exact.
        The identity here."""
        del generator
        return tree


class Bf16Codec(GradCodec):
    """Cast to bfloat16 for the exchange; the collective, its ring
    additions included, runs in bf16, and the result is widened back to
    the leaf's dtype after it.  Only floating leaves wider than 2 bytes
    are cast: fp16 and bf16 leaves pass at their own width."""

    name = "bf16"

    @staticmethod
    def _compressible(dtype) -> bool:
        return dtype.is_floating_point and _itemsize(dtype) > 2

    def leaf_wire_bytes(self, shape, dtype) -> int:
        if self._compressible(dtype):
            return _numel(shape) * 2
        return _numel(shape) * _itemsize(dtype)

    def _wire(self, dtype):
        return torch.bfloat16 if self._compressible(dtype) else dtype

    def roundtrip(self, tree, *, generator=None):
        del generator
        return self._collective(tree, lambda x: x)


def _int8_encode(x: torch.Tensor, generator=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): one max-abs scale for all of ``x`` (floored at
    ``finfo(float32).tiny``), values rounded into int8 [-127, 127]: to
    nearest, ties to even, without ``generator``; ``floor(v + U[0, 1))``
    with it, so that E[q·scale] = x.  A NaN gives q 0 (XLA's conversion)
    and a non-finite scale, so the decoded value stays non-finite."""
    x32 = x.to(torch.float32)
    scale = _div(torch.nan_to_num(x32.abs(), nan=_INF, posinf=_INF).amax(),
                 127.0)
    scale = torch.clamp_min(scale, _TINY)
    return _quantize(x32 / scale, generator), scale


def _quantize(v: torch.Tensor, generator) -> torch.Tensor:
    if generator is None:
        q = torch.round(v)
    else:
        q = torch.floor(v + torch.rand(v.shape, generator=generator,
                                       device=v.device))
    return torch.nan_to_num(torch.clamp(q, -127, 127), nan=0.0).to(
        torch.int8)


def _int8_decode(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


class _Layout:
    """The int8 codec's layout of a list of leaves over n ranks: leaf i is
    cut into n chunks of ``m_i = ceil(size_i / n)`` (zero-padded tail),
    and the leaves' ``(n, m_i)`` blocks sit side by side in one ``(n, M)``
    buffer, ``M = Σ m_i``; ``seg`` holds the ``m_i`` on the device (the
    per-leaf scales expand over their columns)."""

    def __init__(self, leaves: list, n: int, device):
        self.n = n
        self.sizes = [x.numel() for x in leaves]
        self.shapes = [x.shape for x in leaves]
        self.m = [-(-s // n) for s in self.sizes]
        self.offsets = []
        off = 0
        for m in self.m:
            self.offsets.append(off)
            off += m
        self.width = off
        self.seg = torch.tensor(self.m, dtype=torch.int64, device=device)

    def pack(self, leaves: list) -> torch.Tensor:
        """``(n, M)`` f32: every leaf's zero-padded ``(n, m_i)`` block."""
        blocks = []
        for x, s, m in zip(leaves, self.sizes, self.m):
            flat = x.reshape(-1).to(torch.float32)
            if s != self.n * m:
                flat = torch.nn.functional.pad(flat, (0, self.n * m - s))
            blocks.append(flat.view(self.n, m))
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)

    def expand(self, scales: torch.Tensor) -> torch.Tensor:
        """Per-leaf values (..., L) repeated over each leaf's columns:
        (..., M).  One leaf (a bucket) broadcasts as it is."""
        if len(self.m) == 1:
            return scales
        return torch.repeat_interleave(scales, self.seg, dim=-1,
                                       output_size=self.width)

    def leaf_max(self, a: torch.Tensor) -> torch.Tensor:
        """The max of ``a`` (…, M, non-negative) over each leaf's columns
        (and every leading row): (L,)."""
        if a.dim() > 1:
            a = a.amax(dim=0)
        if len(self.m) == 1:
            return a.amax().reshape(1)
        # unsafe: no host-side checks of the lengths (they would
        # synchronize, which a CUDA graph capture forbids)
        return torch.segment_reduce(a, "max", lengths=self.seg,
                                    unsafe=True)

    def encode(self, v: torch.Tensor, generator
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(q, scales): ``_int8_encode`` of each leaf's columns of ``v``
        (f32, (…, M)) with that leaf's own scale."""
        a = torch.nan_to_num(v.abs(), nan=_INF, posinf=_INF)
        scales = torch.clamp_min(_div(self.leaf_max(a), 127.0), _TINY)
        return _quantize(v / self.expand(scales), generator), scales

    def unpack(self, total: torch.Tensor, leaves: list) -> list:
        """Leaf i from its ``(n, m_i)`` block of ``total`` (n, M), the
        padded tail dropped, in the leaf's dtype."""
        out = []
        for x, s, m, off in zip(leaves, self.sizes, self.m, self.offsets):
            block = total[:, off:off + m]
            flat = block.reshape(-1)[:s] if self.n > 1 else block[0, :s]
            out.append(flat.view(x.shape).to(x.dtype))
        return out


class Int8Codec(GradCodec):
    """One max-abs scale per leaf and rounding to int8; only the exchanged
    copy is quantized.

    The reduce is the two-phase compressed all-reduce of JAX
    ``Int8Codec._reduce``: each leaf is cut into n chunks of
    ``m = ceil(size/n)`` (zero-padded tail); phase 1 quantizes the local
    leaf with one scale and sends chunk j to rank j, which sums the
    decoded chunks of every sender (each with its sender's scale); phase 2
    re-quantizes the summed chunk with a scale of its own and gathers
    every rank's chunk back; a mean divides after decoding.  The leaves'
    ``(n, m_i)`` blocks sit side by side in one ``(n, M)`` buffer
    (``_Layout``), so the step moves every leaf through ONE
    ``all_to_all`` of int8 and three ``all_gather`` calls (phase 1's
    scales, phase 2's int8 and its scales), with the numbers of the
    per-leaf collectives.  Decoded error per element is at most
    ``Σ_j s_j + s_2``: one quantum per sender and one for the re-quantized
    sum.  ``neighbor_mean`` moves each leaf's int8 rendering and scale per
    ring hop, both directions, for ``d = 1..degree``."""

    name = "int8"

    def __init__(self):
        self._layouts: dict = {}

    @staticmethod
    def _compressible(dtype) -> bool:
        return dtype.is_floating_point and _itemsize(dtype) > 1

    def leaf_wire_bytes(self, shape, dtype) -> int:
        if self._compressible(dtype):
            return _numel(shape) + 4  # int8 payload + one f32 scale
        return _numel(shape) * _itemsize(dtype)

    def _layout(self, leaves: list, n: int) -> _Layout:
        key = (n, leaves[0].device,
               *((tuple(x.shape), x.numel()) for x in leaves))
        lay = self._layouts.get(key)
        if lay is None:
            lay = self._layouts[key] = _Layout(leaves, n, leaves[0].device)
        return lay

    def _split(self, leaves: list, int8_fn, plain_fn) -> list:
        """``int8_fn`` over the compressible leaves (non-empty ones),
        ``plain_fn`` over the others (one flat buffer per dtype)."""
        out: list = list(leaves)
        idx = [i for i, x in enumerate(leaves)
               if self._compressible(x.dtype) and x.numel()]
        rest = [i for i, x in enumerate(leaves)
                if not self._compressible(x.dtype)]
        if idx:
            for i, y in zip(idx, int8_fn([leaves[i] for i in idx])):
                out[i] = y
        if rest:
            got = _grouped([leaves[i] for i in rest], lambda d: d, plain_fn)
            for i, y in zip(rest, got):
                out[i] = y
        return out

    def _reduce(self, tree, mesh, axis, generator, mean: bool):
        n = _size(mesh, axis)

        def int8(leaves):
            lay = self._layout(leaves, n)
            # phase 1: quantize each whole local leaf with its own scale;
            # rank j receives chunk j of every sender
            q, s = lay.encode(lay.pack(leaves), generator)
            if mesh is not None:
                q = all_to_all_(q, mesh, axis)            # (n, M) int8
                s = all_gather_(s, mesh, axis)             # (n, L) f32
            else:
                s = s.reshape(1, -1)
            chunk = (q.to(torch.float32) * lay.expand(s)).sum(dim=0)
            # phase 2: re-quantize the reduced chunk, share it back
            q2, s2 = lay.encode(chunk, generator)
            if mesh is not None:
                q2 = all_gather_(q2, mesh, axis)           # (n, M) int8
                s2 = all_gather_(s2, mesh, axis)           # (n, L) f32
            else:
                q2, s2 = q2.reshape(1, -1), s2.reshape(1, -1)
            total = q2.to(torch.float32) * lay.expand(s2)
            if mean:
                total = _div(total, n)
            return lay.unpack(total, leaves)

        def plain(x):
            if mesh is not None:
                coll.all_reduce_(x, mesh, axis)
            return _div(x, n) if mean else x

        return _tree_op(tree, lambda leaves: self._split(leaves, int8,
                                                         plain))

    def all_reduce_sum(self, tree, mesh, axis=None, *, generator=None):
        return self._reduce(tree, mesh, axis, generator, mean=False)

    def all_reduce_mean(self, tree, mesh, axis=None, *, generator=None):
        return self._reduce(tree, mesh, axis, generator, mean=True)

    def neighbor_mean(self, tree, mesh, degree=1, *, generator=None):
        if degree <= 0:
            return tree
        if mesh is None or 2 * degree + 1 >= mesh.world_size:
            # the neighbourhood covers the ring: the full mean
            return self.all_reduce_mean(tree, mesh, generator=generator)
        coll.neighbor_mean.launches += 1

        def int8(leaves):
            lay = self._layout(leaves, 1)
            q, s = lay.encode(lay.pack(leaves), generator)
            acc = q.to(torch.float32) * lay.expand(s)
            for d in range(1, degree + 1):
                for shift in (d, -d):
                    # a hop moves the int8 rendering and the scales
                    qp, sp = coll._shift_all([q, s], mesh, shift)
                    acc = acc + qp.to(torch.float32) * lay.expand(sp)
            return lay.unpack(_div(acc, 2 * degree + 1), leaves)

        return _tree_op(tree, lambda leaves: self._split(
            leaves, int8, lambda x: coll.neighbor_mean(x, mesh, degree)))

    def roundtrip(self, tree, *, generator=None):
        def int8(leaves):
            lay = self._layout(leaves, 1)
            q, s = lay.encode(lay.pack(leaves), generator)
            return lay.unpack(q.to(torch.float32) * lay.expand(s), leaves)

        return _tree_op(tree, lambda leaves: self._split(leaves, int8,
                                                         lambda x: x))


_CODEC_CLASSES = {c.name: c for c in (GradCodec, Bf16Codec, Int8Codec)}


def codec_active(codec: GradCodec) -> bool:
    """True when the codec changes the exchange: a compressing codec, or
    ``none`` wrapped in bucketing (``parallel/overlap.BucketedCodec``),
    whose per-bucket collectives replace the one flat reduce."""
    return codec.name != "none" or bool(getattr(codec, "bucketed", False))


def make_codec(compression: str | GradCodec | None) -> GradCodec:
    """Resolve a ``--grad-compression`` value (or a codec) to a codec."""
    if compression is None:
        return GradCodec()
    if isinstance(compression, GradCodec):
        return compression
    try:
        return _CODEC_CLASSES[compression]()
    except KeyError:
        raise ValueError(
            f"unknown grad_compression '{compression}'; "
            f"known: {', '.join(CODECS)}") from None


def int8_channel_encode(x: torch.Tensor,
                        axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): max-abs scale reduced over ``axis`` (one f32 scale per
    remaining index), values rounded to nearest (ties to even, as
    ``jnp.round``) into int8 [-127, 127].  The scale is floored at
    ``finfo(float32).tiny`` so an all-zero vector encodes to zeros.  The
    serving KV cache's quantizer (deterministic: a served stream is a
    pure function of the parameters and the prompt)."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=axis) / 127.0
    scale = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(x32 / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def int8_channel_decode(q: torch.Tensor, scale: torch.Tensor, dtype,
                        axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`int8_channel_encode` (broadcasts the scale back
    over ``axis``)."""
    return (q.to(torch.float32)
            * scale.unsqueeze(axis).to(torch.float32)).to(dtype)
