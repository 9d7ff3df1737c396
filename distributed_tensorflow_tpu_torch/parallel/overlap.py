"""Bucketed gradient collectives and their overlap with the backward pass
(port of ``parallel/overlap.py``).

* **Bucketing** (``plan_buckets``, ``BucketedCodec``): the gradients are
  cut into size-targeted buckets (``--grad-bucket-mb``) in REVERSE leaf
  order.  The port's leaves are the model's parameters in registration
  order, whose reverse follows the order in which the backward pass
  produces their gradients.  The plan is exact (every element of every
  non-empty leaf in one slice), a pure function of the leaves' (shape,
  dtype) sequence (every rank plans alike), single-dtype per bucket, and
  splits a leaf larger than the target at element granularity.
* **Codec composition**: ``BucketedCodec`` runs a codec of
  ``parallel/compression.py`` over the buckets instead of the leaves:
  int8 takes one scale per bucket, and ``wire_bytes`` counts it so.
* **Overlap**: ``SyncEngine`` reduces a bucket as soon as the backward
  pass has produced every gradient it holds (``register_post_accumulate_
  grad_hook``), on a side stream on the card, and with ``grad_accum`` K >
  1 reduces each microbatch's buckets as its backward produces them.  On
  gloo the same hooks run the collectives in line: the same numbers,
  without the overlap.  XLA's latency-hiding scheduler flags
  (``enable_overlap_flags`` in the JAX harness) have no counterpart here.

The port's plan differs from JAX's on the same model: JAX flattens flax's
parameters in sorted key order and stores a Dense kernel as ``(in,
out)``, where the port's weight is ``(out, in)``, so a split leaf is cut
at other elements.  Bucketed ``none`` and ``bf16`` are elementwise, so
their numbers do not depend on the plan; bucketed ``int8``'s do (one
scale per bucket) and are held to the codec's invariants and error bound.
``plan_buckets`` itself, as a function of a (shape, dtype) sequence, is
JAX's.

``probe_engine_overlap`` times the engine's full step, its compute-only
twin (``ProbeLocalCodec``) and the gradient collective alone, on its own
copy of the state, and splits the difference into ``exposed_s`` and
``hidden_s`` (``overlap_split``).
"""

from __future__ import annotations

import copy
import statistics
import time
from typing import Any, Iterable, NamedTuple

import torch

from distributed_tensorflow_tpu_torch.parallel import compression

Tree = Any

# the bucket size when a caller asks for bucketing without naming one:
# ~4 MB balances a collective's launch cost against the granularity of
# the overlap
DEFAULT_BUCKET_MB = 4.0


class Slice(NamedTuple):
    """Elements ``[start, stop)`` of ``leaves[leaf].reshape(-1)``."""

    leaf: int
    start: int
    stop: int


class Bucket(NamedTuple):
    """One collective: same-dtype slices totalling ``size`` elements."""

    dtype: Any
    size: int
    slices: tuple[Slice, ...]


def plan_buckets(leaves: Iterable[Any], bucket_bytes: int
                 ) -> tuple[Bucket, ...]:
    """Partition ``leaves`` (anything with ``.shape`` and a ``.dtype``
    with ``itemsize``) into buckets of at most ``bucket_bytes`` in
    REVERSE leaf order: exact, deterministic, one dtype per bucket (a
    dtype change closes the bucket), leaves larger than the target split
    at element granularity, empty leaves skipped."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    leaves = list(leaves)
    buckets: list[Bucket] = []
    cur: list[Slice] = []
    cur_dtype: Any = None
    cur_size = 0

    def close() -> None:
        nonlocal cur, cur_size
        if cur:
            buckets.append(Bucket(dtype=cur_dtype, size=cur_size,
                                  slices=tuple(cur)))
        cur, cur_size = [], 0

    for idx in reversed(range(len(leaves))):
        leaf = leaves[idx]
        dtype = leaf.dtype
        n = compression._numel(leaf.shape)
        if n == 0:
            continue
        # capacity in elements of this dtype; at least 1, so a target
        # under one element still makes progress
        cap = max(bucket_bytes // max(int(dtype.itemsize), 1), 1)
        if cur and cur_dtype != dtype:
            close()
        cur_dtype = dtype
        start = 0
        while start < n:
            if cur_size >= cap:
                close()
            take = min(cap - cur_size, n - start)
            cur.append(Slice(idx, start, start + take))
            cur_size += take
            start += take
    close()
    return tuple(buckets)


def pack_bucket(leaves: list, bucket: Bucket) -> torch.Tensor:
    """One flat tensor: the bucket's slices of ``leaves``, in plan
    order."""
    parts = [leaves[s.leaf].reshape(-1)[s.start:s.stop]
             for s in bucket.slices]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def pack_buckets(leaves: list, plan: tuple[Bucket, ...]) -> list:
    """One flat tensor per bucket.  Slicing and concatenation only, so
    ``unpack_buckets`` of it is bitwise the leaves."""
    return [pack_bucket(leaves, b) for b in plan]


def unpack_buckets(bucket_arrays: list, plan: tuple[Bucket, ...],
                   leaves: list) -> list:
    """Inverse of ``pack_buckets``: each leaf reassembled from its
    slices, in its shape.  Leaves the plan skipped (empty) pass through
    from ``leaves``."""
    pieces: dict[int, list] = {}
    for b, arr in zip(plan, bucket_arrays):
        off = 0
        for s in b.slices:
            ln = s.stop - s.start
            pieces.setdefault(s.leaf, []).append((s.start, arr[off:off + ln]))
            off += ln
    new = list(leaves)
    for i, segs in pieces.items():
        segs.sort(key=lambda t: t[0])
        flat = segs[0][1] if len(segs) == 1 else torch.cat(
            [p for _, p in segs])
        new[i] = flat.reshape(leaves[i].shape)
    return new


class BucketedCodec(compression.GradCodec):
    """A codec of ``parallel/compression.py`` applied per bucket instead
    of per leaf: every collective (and ``roundtrip``) packs the leaves
    into the bucket plan, runs the inner codec over the list of buckets,
    and unpacks.  ``name`` is the inner codec's; ``bucketed`` and
    ``bucket_mb`` mark the wrapper."""

    bucketed = True

    def __init__(self, inner: compression.GradCodec,
                 bucket_mb: float = DEFAULT_BUCKET_MB):
        if getattr(inner, "bucketed", False):
            raise ValueError("codec is already bucketed")
        if not bucket_mb or bucket_mb < 0:
            raise ValueError(
                f"grad_bucket_mb must be > 0 to bucket (0 disables "
                f"bucketing entirely), got {bucket_mb}")
        self.inner = inner
        self.bucket_bytes = max(int(round(bucket_mb * (1 << 20))), 1)
        self._plans: dict[tuple, tuple[Bucket, ...]] = {}

    @property
    def name(self) -> str:  # type: ignore[override]
        return self.inner.name

    @property
    def bucket_mb(self) -> float:
        return self.bucket_bytes / (1 << 20)

    # -------------------------------------------------------------- plans
    def plan_for(self, leaves: list) -> tuple[Bucket, ...]:
        """The (cached) plan for this leaf structure, keyed by shapes and
        dtypes only."""
        key = tuple((tuple(leaf.shape), leaf.dtype) for leaf in leaves)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = plan_buckets(leaves, self.bucket_bytes)
        return plan

    def _through(self, tree: Tree, op) -> Tree:
        def run(leaves):
            plan = self.plan_for(leaves)
            return unpack_buckets(op(pack_buckets(leaves, plan)), plan,
                                  leaves)

        return compression._tree_op(tree, run)

    # ------------------------------------------------------------ payload
    def leaf_wire_bytes(self, shape, dtype) -> int:
        # the per-bucket overhead (int8's scale) belongs to the leaves
        # jointly: no per-leaf figure would sum to wire_bytes
        raise NotImplementedError(
            "BucketedCodec has no per-leaf wire accounting (bucket "
            "overhead is shared across leaves) — use wire_bytes(leaves) "
            "over the full gradient tree")

    def wire_bytes(self, leaves: Iterable[Any]) -> int:
        plan = self.plan_for(list(leaves))
        return int(sum(self.inner.leaf_wire_bytes((b.size,), b.dtype)
                       for b in plan))

    # -------------------------------------------------------- collectives
    def all_reduce_sum(self, tree, mesh, axis=None, *, generator=None):
        return self._through(tree, lambda b: self.inner.all_reduce_sum(
            b, mesh, axis, generator=generator))

    def all_reduce_mean(self, tree, mesh, axis=None, *, generator=None):
        return self._through(tree, lambda b: self.inner.all_reduce_mean(
            b, mesh, axis, generator=generator))

    def neighbor_mean(self, tree, mesh, degree=1, *, generator=None):
        return self._through(tree, lambda b: self.inner.neighbor_mean(
            b, mesh, degree, generator=generator))

    def roundtrip(self, tree, *, generator=None):
        return self._through(
            tree, lambda b: self.inner.roundtrip(b, generator=generator))


def make_overlap_codec(grad_compression, grad_bucket_mb: float
                       ) -> compression.GradCodec:
    """(--grad-compression, --grad-bucket-mb) as one codec: the plain
    codec at bucket 0, the bucketed wrapper otherwise."""
    codec = compression.make_codec(grad_compression)
    if grad_bucket_mb:
        codec = BucketedCodec(codec, grad_bucket_mb)
    return codec


class ProbeLocalCodec(compression.GradCodec):
    """Probe only: every collective is the identity, so a step built with
    it is the engine's compute-only twin.  Its results are wrong across
    ranks and are discarded; the probe times it."""

    name = "probe_local"

    def all_reduce_sum(self, tree, mesh, axis=None, *, generator=None):
        return tree

    def all_reduce_mean(self, tree, mesh, axis=None, *, generator=None):
        return tree

    def neighbor_mean(self, tree, mesh, degree=1, *, generator=None):
        return tree


# --------------------------------------------------------------- probing

def overlap_split(full_s: float, compute_s: float,
                  collective_s: float) -> dict[str, float]:
    """Exposed against hidden collective seconds: ``exposed_s`` = full −
    compute (what a perfect overlap drives to 0), ``hidden_s`` =
    collective − exposed (floored at 0), ``serialized_step_s`` = compute
    + collective."""
    exposed = max(full_s - compute_s, 0.0)
    hidden = max(collective_s - exposed, 0.0)
    return {
        "full_step_s": full_s,
        "compute_s": compute_s,
        "collective_s": collective_s,
        "exposed_s": exposed,
        "hidden_s": hidden,
        "serialized_step_s": compute_s + collective_s,
        "exposed_frac": (exposed / collective_s if collective_s > 0
                         else 0.0),
    }


def copy_state(engine, state):
    """A state of its own for the probe: a deep copy of the module, a
    fresh optimizer over it, and clones of the generators, so the
    caller's state is never touched."""
    model = copy.deepcopy(state.model)
    gens = []
    for g in (state.generator, state.codec_generator):
        c = torch.Generator(device=g.device)
        c.set_state(g.get_state())
        gens.append(c)
    return type(state)(step=state.step, model=model,
                       optimizer=engine.make_optimizer(
                           list(model.parameters())),
                       generator=gens[0], codec_generator=gens[1],
                       seed=state.seed, engine=engine)


def _wall(fn, device: torch.device, repeats: int) -> float:
    """Median wall seconds of ``fn()`` to completion on the device, after
    one warm-up call."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def probe_engine_overlap(engine, xs, ys, sample_x=None, *, state=None,
                         repeats: int = 3) -> dict[str, Any] | None:
    """The engine's exposed-against-hidden collective split on one placed
    batch: times the three callables of ``engine.build_overlap_probe_fns``
    (the real step, its compute-only twin and the gradient collective
    alone) and returns ``overlap_split`` with the plan and codec context,
    or None for an engine without a probe.  The steps run on a copy of
    ``state`` (or of a fresh state from ``sample_x``); every rank of a
    group calls it together, as it holds collectives."""
    build = getattr(engine, "build_overlap_probe_fns", None)
    fns = build() if build is not None else None
    if not fns:
        return None
    if state is None:
        if sample_x is None:
            raise ValueError("probe_engine_overlap needs state= or "
                             "sample_x= (to init a throwaway state)")
        state = engine.init_state(torch.Generator().manual_seed(0),
                                  sample_x)
    full_state = copy_state(engine, state)
    compute_state = copy_state(engine, state)
    params = [p.detach().clone() for p in state.model.parameters()]
    dev = engine.device
    full_s = _wall(lambda: fns["full"](full_state, xs, ys), dev, repeats)
    compute_s = _wall(lambda: fns["compute"](compute_state, xs, ys), dev,
                      repeats)
    collective_s = _wall(lambda: fns["collective"](params), dev, repeats)
    out: dict[str, Any] = overlap_split(full_s, compute_s, collective_s)
    codec = getattr(engine, "grad_codec", None)
    n_buckets = None
    if codec is not None and getattr(codec, "bucketed", False):
        n_buckets = len(codec.plan_for(params))
    out.update({
        "grad_compression": getattr(codec, "name", "none"),
        "grad_bucket_mb": float(getattr(codec, "bucket_mb", 0.0) or 0.0),
        "n_buckets": n_buckets,
        "grad_accum": int(getattr(engine, "grad_accum", 1)),
        "repeats": int(repeats),
    })
    return out
