"""The port's gradient codecs across four gloo ranks (CPU), against the
JAX package.

One spawn of 4 ranks, run once by a module fixture.  The rank bodies live
at module level in this file, which imports no JAX at the top (a spawned
child re-imports the module of its target); the JAX references are
computed in the parent: the codec collectives under ``jax.vmap`` with an
axis of 4 (``jax.vmap(..., axis_name="data")`` emulates the mapped
collectives), the JAX ``SyncEngine`` on 4 devices of the 8-device CPU
mesh (its codec step is built with ``check_vma=False``).

Tolerances, each with its reason:

* ``none`` reduces: 1e-6 relative (f32 summation order: gloo's against
  XLA's).
* ``bf16`` reduces: 2⁻⁷ of Σⱼ|xⱼ| per element (the ring adds in bf16, in
  another order than XLA's).
* ``int8`` reduces without a generator: one phase-2 quantum per element,
  ``max|leaf| / 127`` (phase 1 is exact but its n-term f32 sum can land
  on the other side of a phase-2 rounding tie).  Bucketed: the same, per
  bucket (``plan_buckets`` is a function of the leaves, so both packages
  plan these leaves alike).
* ``int8`` ``neighbor_mean`` at degree 1 (n = 4: the ring branch):
  1e-6, no re-quantization.
* A ``SyncEngine`` SGD step under ``bf16`` against JAX's: the update
  within 2⁻⁷ of Σⱼ max|gⱼ| (each rank's local gradient maximum, gathered)
  times the learning rate.  Under ``int8`` against the port's exact step:
  within JAX's bound Σⱼ sⱼ + s₂ ≤ 2.02 Σⱼ max|gⱼ| / 127 times the
  learning rate.  Bucketed ``none`` with K = 2 (each microbatch's
  buckets reduced as its backward produces them) against the exact K = 2
  step: 1e-6 of the update plus 2⁻²² of the parameter (f32 order of Σᵢ
  psum against psum Σᵢ, then one rounding of the parameter's update).
* Local SGD (sync every step) and gossip (degree 1) under ``int8``:
  each rank's parameters after the exchange within 2.05 quanta of the
  exact exchange's (``max|p| / 127`` per leaf); after local SGD's mean
  every rank holds the same parameters.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

WORLD = 4
LR = 0.1
BUCKET_MB = 1e-4          # ~100 bytes: the leaves split across buckets
SHAPES = [(5, 3), (7,), (33,), (4, 6)]
CODECS = ("none", "bf16", "int8")
OPS = ("all_reduce_sum", "all_reduce_mean")
BATCH = 32                # 8 rows a rank
MLP_KW = dict(num_classes=10, hidden=32, dropout_rate=0.0)


def _inputs(rank: int) -> list[np.ndarray]:
    rng = np.random.default_rng(100 + rank)
    return [(rng.standard_normal(s) * (1 + rank)).astype(np.float32)
            for s in SHAPES]


def _data():
    rng = np.random.default_rng(7)
    x = rng.random((BATCH, 12, 12, 1), dtype=np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    return x, y


def _sgd(params):
    return torch.optim.SGD(params, lr=LR)


def _local_grad_max(model, x, y) -> list[float]:
    """Each leaf's max |gradient| of this rank's share of the loss
    (loss / n over its rows): what the codec quantizes on this rank."""
    import copy

    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy

    m = copy.deepcopy(model)
    (cross_entropy(m(x, train=True), y).mean() / WORLD).backward()
    return [float(p.grad.abs().max()) for p in m.parameters()]


def _rank(rank: int, port: int, init: dict, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch.engines import (
        AsyncLocalEngine, GossipEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.parallel import compression
    from distributed_tensorflow_tpu_torch.parallel import overlap

    torch.set_num_threads(1)
    meshlib.init_process_group("cpu", WORLD, rank, f"tcp://127.0.0.1:{port}")
    out: dict = {}
    try:
        mesh = meshlib.create_mesh(WORLD, device="cpu")
        mine = [torch.from_numpy(a) for a in _inputs(rank)]
        for name in CODECS:
            for mb in (0, BUCKET_MB):
                codec = overlap.make_overlap_codec(name, mb)
                for op in OPS:
                    got = getattr(codec, op)(mine, mesh)
                    for i, g in enumerate(got):
                        out[f"{name}/{mb}/{op}/{i}"] = g.numpy()
        mixed = compression.Int8Codec().neighbor_mean(mine, mesh, 1)
        for i, g in enumerate(mixed):
            out[f"neighbor/{i}"] = g.numpy()

        x, y = _data()

        def engine(cls, **kw):
            eng = cls(MLP(**MLP_KW, device="cpu"), mesh=mesh,
                      optimizer=_sgd, **kw)
            state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
            state.model.load_state_dict(init)
            return eng, state

        def stepped(prefix, cls, steps=1, **kw):
            eng, state = engine(cls, **kw)
            for _ in range(steps):
                state, _ = eng.step(state, *eng.shard_batch(x, y))
            for k, v in state.model.state_dict().items():
                out[f"{prefix}/{k}"] = v.numpy().copy()
            return eng, state

        eng, state = engine(SyncEngine)
        out["gmax"] = np.asarray(_local_grad_max(
            state.model, *eng.shard_batch(x, y)))
        stepped("sync/none", SyncEngine)
        stepped("sync/bf16", SyncEngine, grad_compression="bf16")
        eng, state = stepped("sync/int8", SyncEngine,
                             grad_compression="int8")
        out["sync/int8/bytes"] = np.asarray(
            [eng.grad_collective_bytes(state),
             compression.all_to_all_.launches,
             compression.all_gather_.launches])
        stepped("k2/none", SyncEngine, grad_accum=2)
        stepped("k2/bucketed", SyncEngine, grad_accum=2,
                grad_bucket_mb=BUCKET_MB * 20)
        stepped("k2/int8_bucketed", SyncEngine, grad_accum=2,
                grad_compression="int8", grad_bucket_mb=BUCKET_MB * 20)
        stepped("async/none", AsyncLocalEngine, sync_every=1)
        stepped("async/int8", AsyncLocalEngine, sync_every=1,
                grad_compression="int8")
        stepped("gossip/none", GossipEngine, degree=1)
        stepped("gossip/int8", GossipEngine, degree=1,
                grad_compression="int8")
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _jax_engine():
    """The JAX SyncEngine under bf16 on 4 devices, its initial state, and
    that state's weights as a port state_dict."""
    import jax
    import optax

    from distributed_tensorflow_tpu.engines.sync import SyncEngine
    from distributed_tensorflow_tpu.models.mlp import MLP
    from distributed_tensorflow_tpu.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.models import convert

    eng = SyncEngine(MLP(**MLP_KW), optimizer=optax.sgd(LR),
                     mesh=create_mesh(WORLD), grad_compression="bf16")
    state = eng.init_state(jax.random.key(0), _data()[0][:1])
    return eng, state, convert.mlp_state_dict(
        jax.tree.map(np.asarray, state.params))


def _jax_refs(eng, state):
    """The JAX codec collectives over the four ranks' inputs (vmap), and
    the JAX SyncEngine's bf16 step."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.parallel import compression as jcomp
    from distributed_tensorflow_tpu.parallel import overlap as joverlap
    from distributed_tensorflow_tpu_torch.models import convert

    stacked = [jnp.asarray(np.stack([_inputs(r)[i] for r in range(WORLD)]))
               for i in range(len(SHAPES))]
    refs = {}
    for name in CODECS:
        for mb in (0, BUCKET_MB):
            codec = joverlap.make_overlap_codec(name, mb)
            for op in OPS:
                fn = jax.jit(jax.vmap(
                    lambda t, op=op, codec=codec: getattr(codec, op)(
                        t, "data"), axis_name="data"))
                for i, w in enumerate(fn(stacked)):
                    refs[f"{name}/{mb}/{op}/{i}"] = np.asarray(w)
    mixed = jax.jit(jax.vmap(lambda t: jcomp.Int8Codec().neighbor_mean(
        t, "data", 1), axis_name="data"))(stacked)
    for i, w in enumerate(mixed):
        refs[f"neighbor/{i}"] = np.asarray(w)
    x, y = _data()
    state, _ = eng.step(state, *eng.shard_batch(x, y))
    after = convert.mlp_state_dict(jax.tree.map(np.asarray, state.params))
    refs.update({f"jax_bf16/{k}": v.numpy() for k, v in after.items()})
    return refs


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    """The ranks start from the JAX engine's weights and run while the
    parent computes the JAX references."""
    eng, state, init = _jax_engine()
    out = tmp_path_factory.mktemp("codec")
    ranks = mp.spawn(_rank, args=(meshlib.free_port(), init, str(out)),
                     nprocs=WORLD, join=False)
    refs = _jax_refs(eng, state)
    while not ranks.join():
        pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return {k: v.numpy() for k, v in init.items()}, refs, got


@pytest.mark.parametrize("mb", [0, BUCKET_MB])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", CODECS)
def test_codec_reduce_against_jax(spawn_run, name, op, mb):
    _, refs, ranks = spawn_run
    inputs = [_inputs(r) for r in range(WORLD)]
    for i in range(len(SHAPES)):
        want = refs[f"{name}/{mb}/{op}/{i}"]
        mags = sum(np.abs(inp[i]) for inp in inputs)
        if op == "all_reduce_mean":
            mags = mags / WORLD
        for r, got in enumerate(ranks):
            g = got[f"{name}/{mb}/{op}/{i}"]
            # every rank's copy of the replicated result, JAX's device r's
            assert g.shape == want[r].shape and g.dtype == want[r].dtype
            if name == "none":
                np.testing.assert_allclose(g, want[r], rtol=1e-6,
                                           atol=1e-6 * mags.max())
            elif name == "bf16":
                assert (np.abs(g - want[r]) <= 2.0 ** -7 * mags).all(), i
            else:
                quantum = np.abs(want[r]).max() / 127 * 1.01
                assert (np.abs(g - want[r]) <= quantum).all(), (i, r)


def test_int8_neighbor_mean_against_jax(spawn_run):
    _, refs, ranks = spawn_run
    for i in range(len(SHAPES)):
        want = refs[f"neighbor/{i}"]
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[f"neighbor/{i}"], want[r],
                                       rtol=1e-6, atol=1e-6)
        # the ranks differ: it is a ring mix, not a mean
        assert not np.allclose(ranks[0][f"neighbor/{i}"],
                               ranks[2][f"neighbor/{i}"])


def _gsum(ranks) -> np.ndarray:
    return sum(got["gmax"] for got in ranks)


def _keys(init):
    return sorted(init)


def test_sync_engine_bf16_step_against_jax(spawn_run):
    init, refs, ranks = spawn_run
    gsum = _gsum(ranks)
    for r, got in enumerate(ranks):
        for j, k in enumerate(_keys(init)):
            bound = LR * 2.0 ** -7 * gsum[_leaf_index(init, k)] + 1e-7
            diff = np.abs(got[f"sync/bf16/{k}"] - refs[f"jax_bf16/{k}"])
            assert (diff <= bound).all(), (r, k, diff.max(), bound)


def _leaf_index(init, key) -> int:
    """The position of ``key`` among the port model's parameters (the
    state dict's order, which is the parameters' here)."""
    return list(init).index(key)


def test_sync_engine_int8_step_within_jax_bound(spawn_run):
    init, _, ranks = spawn_run
    gsum = _gsum(ranks)
    for r, got in enumerate(ranks):
        moved = False
        for k in init:
            bound = LR * 2.02 * gsum[_leaf_index(init, k)] / 127 + 1e-7
            diff = np.abs(got[f"sync/int8/{k}"] - got[f"sync/none/{k}"])
            assert (diff <= bound).all(), (r, k, diff.max(), bound)
            moved |= diff.max() > 0
            # the replicas stay equal
            np.testing.assert_array_equal(got[f"sync/int8/{k}"],
                                          ranks[0][f"sync/int8/{k}"])
        assert moved
        n_bytes, a2a, gathers = got["sync/int8/bytes"]
        assert n_bytes == sum(v.size + 4 for v in init.values())
        assert a2a >= 1 and gathers >= 3


def test_bucketed_reduce_per_microbatch_close_to_exact(spawn_run):
    init, _, ranks = spawn_run
    for got in ranks:
        for k in init:
            exact = got[f"k2/none/{k}"]
            update = np.abs(exact - init[k]).max()
            np.testing.assert_allclose(got[f"k2/bucketed/{k}"], exact,
                                       rtol=2.0 ** -22,
                                       atol=1e-6 * update + 1e-9)
            q = got[f"k2/int8_bucketed/{k}"]
            assert np.isfinite(q).all()
            np.testing.assert_array_equal(q, ranks[0][f"k2/int8_bucketed/"
                                                      f"{k}"])
            # a few quanta of the update, far under the update itself
            assert np.abs(q - exact).max() <= 0.25 * update + 1e-7, k


@pytest.mark.parametrize("kind", ["async", "gossip"])
def test_local_engines_int8_exchange_within_bound(spawn_run, kind):
    init, _, ranks = spawn_run
    for r, got in enumerate(ranks):
        for k in init:
            exact = got[f"{kind}/none/{k}"]
            bound = 2.05 * np.abs(exact).max() / 127 + 1e-7
            diff = np.abs(got[f"{kind}/int8/{k}"] - exact)
            assert (diff <= bound).all(), (kind, r, k, diff.max(), bound)
            if kind == "async":
                np.testing.assert_array_equal(got[f"async/int8/{k}"],
                                              ranks[0][f"async/int8/{k}"])
    # gossip's ring mix leaves the ranks apart
    assert any(not np.array_equal(ranks[0][f"gossip/int8/{k}"],
                                  ranks[1][f"gossip/int8/{k}"]) for k in init)
