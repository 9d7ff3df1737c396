"""The port's async (local SGD) and gossip engines against the JAX engines'
per-device stacked state, and through the CLI, on gloo (CPU).

The JAX ``AsyncLocalEngine``/``GossipEngine`` keep one parameter copy per
device, stacked on a leading axis; the port keeps one per process, so rank
r's module must equal row r of the JAX stack after every step.  SGD is the
optimizer (linear in the gradient, so a wrong scale such as the sync
engine's ``1/n`` shows) and dropout is 0; parameters are held within
``atol=1e-5`` (f32 sums in other orders, as JAX tests/test_engines.py).

Two spawns (a spawn costs seconds), each run once by a module fixture and
read by several tests.  The rank bodies live at module level in this
file, which imports no JAX at the top, because a spawned child re-imports
the module that defines its target; JAX references are computed in the
parent.

* spawn 1, 2 ranks: ``AsyncLocalEngine(sync_every=2)`` for 4 steps (the
  ranks differ after odd steps and agree after even ones, as JAX
  tests/test_engines.py:90); ``eval_params`` after step 3 is the ranks'
  mean and leaves the training module as it was; then ``cli.main`` with
  ``-m c -cs async -n 2`` and ``-m d -ds custom -n 2`` run as the ranks of
  this group;
* spawn 2, 4 ranks: ``GossipEngine(degree=1)`` for 3 steps.  2·1 + 1 < 4,
  so this is the ring mix (point-to-point exchanges), not the full mean.

The tests without a spawn run both engines on a 1-rank gloo group, the
path NCCL takes on one card: one all-reduce per step, the degenerate
gossip mix included, and the Trainer's 8-step drain bitwise equal to 1.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

SGD_LR = 0.5
PARAMS_ATOL = 1e-5
ASYNC_WORLD, ASYNC_STEPS, SYNC_EVERY = 2, 4, 2
GOSSIP_WORLD, GOSSIP_STEPS = 4, 3
BATCH = 16   # global rows per step


def _data():
    rng = np.random.default_rng(0)
    x = rng.random((4 * BATCH, 6, 5, 1), dtype=np.float32)
    y = rng.integers(0, 4, 4 * BATCH).astype(np.int32)
    return x, y


def _batch(i):
    x, y = _data()
    return x[BATCH * i:BATCH * (i + 1)], y[BATCH * i:BATCH * (i + 1)]


def _engine(name, mesh=None, classes=4, **kw):
    from distributed_tensorflow_tpu_torch.engines import create_engine
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    model = MLP(num_classes=classes, hidden=32, dropout_rate=0.0,
                device="cpu")
    return create_engine(name, model, mesh=mesh,
                         device=None if mesh else "cpu",
                         optimizer=lambda p: torch.optim.SGD(p, lr=SGD_LR),
                         **kw)


def _params(model) -> dict:
    return {k: v.detach().clone().numpy()
            for k, v in model.state_dict().items()}


def _run(eng, state_dict, steps, after_step=None):
    """``steps`` steps on batches 0.. of ``_data``; returns (state, each
    step's parameters, each step's loss)."""
    state = eng.init_state(torch.Generator().manual_seed(0), _data()[0])
    state.model.load_state_dict(state_dict)
    per_step, losses = [], []
    for i in range(steps):
        state, m = eng.step(state, *eng.shard_batch(*_batch(i)))
        per_step.append(_params(state.model))
        losses.append(float(m["loss"]))
        if after_step is not None:
            after_step(i + 1, state)
    return state, per_step, losses


def _join(rank: int, world: int, port: int):
    torch.set_num_threads(1)
    meshlib.init_process_group("cpu", world, rank, f"tcp://127.0.0.1:{port}")
    return meshlib.create_mesh(world, device="cpu")


def _save(path, per_step, losses, **extra):
    np.savez(path, losses=np.asarray(losses),
             **{f"{s}/{k}": v for s, p in enumerate(per_step, 1)
                for k, v in p.items()},
             **extra)


def small_dataset(batch_size, type="train"):
    """A picklable ``dataset_fn``: 128 train / 32 test synthetic rows."""
    del batch_size
    n, split = (128, "train") if type == "train" else (32, "test")
    x, y = tloaders.synthetic_classification((28, 28), 10, n, seed=7,
                                             split=split)
    return tloaders.Dataset(x=x[..., None], y=y, num_classes=10,
                            name="small", synthetic=True)


# ------------------------------------------------------------- spawn 1

def _async_rank(rank: int, port: int, state_dict, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch.cli import main

    mesh = _join(rank, ASYNC_WORLD, port)
    try:
        eng = _engine("async", mesh, sync_every=SYNC_EVERY)
        consensus = {}

        def at_step(step, state):
            if step == 3:   # diverged: the mean differs from each copy
                before = _params(state.model)
                consensus["mean"] = _params(eng.eval_params(state))
                consensus["kept"] = _params(state.model)
                consensus["before"] = before

        launches = coll.all_reduce_.launches
        _, per_step, losses = _run(eng, state_dict, ASYNC_STEPS, at_step)
        launches = coll.all_reduce_.launches - launches
        _save(f"{out_dir}/rank{rank}.npz", per_step, losses,
              launches=launches,
              **{f"{tag}/{k}": v for tag, p in consensus.items()
                 for k, v in p.items()})
        summaries = []
        for argv in (["-m", "c", "-cs", "async", "--sync-every", "3"],
                     ["-m", "d", "-ds", "custom", "-d", "1"]):
            summaries.append(main(argv + [
                "--device", "cpu", "-n", str(ASYNC_WORLD), "-b", "8",
                "--model", "mlp", "--log-every", "0"],
                dataset_fn=small_dataset))
        with open(f"{out_dir}/cli{rank}.json", "w") as f:
            json.dump(summaries, f)
    finally:
        dist.destroy_process_group()


def _jax_rows(engine_cls, world, steps, **kw):
    """Row r of the JAX engine's stacked params after each step, as port
    state_dicts, the per-step losses, and the initial state_dict."""
    import jax
    import optax

    from distributed_tensorflow_tpu.models.mlp import MLP as JaxMLP
    from distributed_tensorflow_tpu.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.models.convert import mlp_state_dict

    eng = engine_cls(JaxMLP(num_classes=4, hidden=32, dropout_rate=0.0),
                     optimizer=optax.sgd(SGD_LR), mesh=create_mesh(world),
                     **kw)
    state = eng.init_state(jax.random.key(0), _data()[0])

    def rows(params):
        stacked = jax.tree.map(np.asarray, params)
        return [mlp_state_dict(jax.tree.map(lambda a: a[r], stacked))
                for r in range(world)]

    init = rows(state.params)[0]
    per_step, losses, means = [], [], []
    for i in range(steps):
        state, m = eng.step(state, *eng.shard_batch(*_batch(i)))
        per_step.append(rows(state.params))
        losses.append(float(m["loss"]))
        means.append(mlp_state_dict(jax.tree.map(
            np.asarray, eng.eval_params(state))))
    return init, per_step, losses, means


@pytest.fixture(scope="module")
def async_run(tmp_path_factory):
    from distributed_tensorflow_tpu.engines.async_local import (
        AsyncLocalEngine)

    init, want, jlosses, jmeans = _jax_rows(
        AsyncLocalEngine, ASYNC_WORLD, ASYNC_STEPS, sync_every=SYNC_EVERY)
    out = tmp_path_factory.mktemp("async")
    mp.spawn(_async_rank, args=(meshlib.free_port(), init, str(out)),
             nprocs=ASYNC_WORLD, join=True)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(ASYNC_WORLD)]
    cli = [json.loads((out / f"cli{r}.json").read_text())
           for r in range(ASYNC_WORLD)]
    return dict(want=want, jlosses=jlosses, jmeans=jmeans, ranks=ranks,
                cli=cli)


def _assert_rows(ranks, want, steps):
    for r, got in enumerate(ranks):
        for s in range(steps):
            for name, w in want[s][r].items():
                np.testing.assert_allclose(
                    got[f"{s + 1}/{name}"], w.numpy(), rtol=0,
                    atol=PARAMS_ATOL, err_msg=f"rank {r} step {s + 1} {name}")


def test_async_ranks_equal_jax_rows_every_step(async_run):
    _assert_rows(async_run["ranks"], async_run["want"], ASYNC_STEPS)
    for got in async_run["ranks"]:   # the metrics are the ranks' mean
        np.testing.assert_allclose(got["losses"], async_run["jlosses"],
                                   rtol=1e-5)


def test_async_ranks_diverge_then_agree(async_run):
    a, b = async_run["ranks"]
    names = [k.split("/", 1)[1] for k in a if k.startswith("1/")]
    for s in range(1, ASYNC_STEPS + 1):
        spread = max(np.abs(a[f"{s}/{k}"] - b[f"{s}/{k}"]).max()
                     for k in names)
        if s % SYNC_EVERY == 0:
            assert spread == 0.0, f"step {s}: not synced"
        else:
            assert spread > 1e-3, f"step {s}: unexpectedly synced"
    # one collective per step (4: two parameter means, two metric
    # reductions) and one for eval_params
    assert a["launches"] == b["launches"] == ASYNC_STEPS + 1


def test_async_eval_params_is_the_mean_and_keeps_the_copy(async_run):
    want = async_run["jmeans"][2]   # JAX eval_params after step 3
    for got in async_run["ranks"]:
        for name, w in want.items():
            np.testing.assert_allclose(got[f"mean/{name}"], w.numpy(),
                                       rtol=0, atol=PARAMS_ATOL)
            np.testing.assert_array_equal(got[f"kept/{name}"],
                                          got[f"before/{name}"])
            np.testing.assert_array_equal(got[f"kept/{name}"],
                                          got[f"3/{name}"])
        assert any(np.abs(got[f"mean/{k}"] - got[f"3/{k}"]).max() > 1e-3
                   for k in want)


def test_cli_async_and_custom_two_ranks(async_run):
    cli0, cli1 = async_run["cli"]
    for summary, engine in zip(cli0, ("async", "gossip")):
        assert summary["engine"] == engine
        assert summary["n_devices"] == summary["data_parallel"] == 2
        assert summary["global_batch"] == 16 and summary["steps"] == 128 // 16
        assert np.isfinite(summary["test_loss"])
        assert 0.0 <= summary["test_accuracy"] <= 1.0
    # every rank reports the consensus model's all-reduced eval
    for a, b in zip(cli0, cli1):
        assert (a["test_accuracy"], a["test_loss"]) == (
            b["test_accuracy"], b["test_loss"])


# ------------------------------------------------------------- spawn 2

def _gossip_rank(rank: int, port: int, state_dict, out_dir: str) -> None:
    mesh = _join(rank, GOSSIP_WORLD, port)
    try:
        eng = _engine("gossip", mesh, degree=1)
        reduces, mixes = coll.all_reduce_.launches, coll.neighbor_mean.launches
        _, per_step, losses = _run(eng, state_dict, GOSSIP_STEPS)
        _save(f"{out_dir}/rank{rank}.npz", per_step, losses,
              launches=[coll.all_reduce_.launches - reduces,
                        coll.neighbor_mean.launches - mixes])
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gossip_run(tmp_path_factory):
    from distributed_tensorflow_tpu.engines.gossip import GossipEngine

    init, want, jlosses, _ = _jax_rows(GossipEngine, GOSSIP_WORLD,
                                       GOSSIP_STEPS, degree=1)
    out = tmp_path_factory.mktemp("gossip")
    mp.spawn(_gossip_rank, args=(meshlib.free_port(), init, str(out)),
             nprocs=GOSSIP_WORLD, join=True)
    ranks = [dict(np.load(out / f"rank{r}.npz"))
             for r in range(GOSSIP_WORLD)]
    return dict(want=want, jlosses=jlosses, ranks=ranks)


def test_gossip_four_ranks_equal_jax_rows_every_step(gossip_run):
    _assert_rows(gossip_run["ranks"], gossip_run["want"], GOSSIP_STEPS)
    for got in gossip_run["ranks"]:
        np.testing.assert_allclose(got["losses"], gossip_run["jlosses"],
                                   rtol=1e-5)


def test_gossip_four_ranks_mix_over_the_ring(gossip_run):
    ranks = gossip_run["ranks"]
    # each step: one ring mix of the flat parameter buffer, one metric
    # all-reduce
    for got in ranks:
        assert got["launches"].tolist() == [GOSSIP_STEPS, GOSSIP_STEPS]
    # a ring of degree 1 on 4 ranks is not the full mean: opposite ranks
    # keep different parameters
    key = next(k for k in ranks[0] if k.startswith(f"{GOSSIP_STEPS}/"))
    assert np.abs(ranks[0][key] - ranks[2][key]).max() > 1e-4


# ------------------------------------------------------- one-rank group

@pytest.mark.parametrize("name,kw", [("async", dict(sync_every=2)),
                                     ("gossip", dict(degree=1))])
def test_one_rank_group_equals_jax_with_one_collective_per_step(name, kw):
    """One rank (the card's path, on gloo): JAX's one-device engine; the
    gossip mix is the degenerate all-reduce, packed with the metrics."""
    from distributed_tensorflow_tpu.engines.async_local import (
        AsyncLocalEngine)
    from distributed_tensorflow_tpu.engines.gossip import GossipEngine

    jax_cls = {"async": AsyncLocalEngine, "gossip": GossipEngine}[name]
    init, want, jlosses, _ = _jax_rows(jax_cls, 1, 4, **kw)
    mesh = meshlib.create_mesh(1, device="cpu")
    try:
        reduces, mixes = coll.all_reduce_.launches, coll.neighbor_mean.launches
        _, per_step, losses = _run(_engine(name, mesh, **kw), init, 4)
        assert coll.all_reduce_.launches - reduces == 4
        assert coll.neighbor_mean.launches == mixes
    finally:
        mesh.close()
    for s in range(4):
        for k, w in want[s][0].items():
            np.testing.assert_allclose(per_step[s][k], w.numpy(), rtol=0,
                                       atol=PARAMS_ATOL, err_msg=k)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


@pytest.mark.parametrize("name", ["async", "gossip"])
def test_trainer_drain_k8_bitwise_equals_k1(name):
    """``Trainer.fit`` takes the local engines unchanged: 8-step chunks
    give the bits of one-step calls (with a parameter mean every 3 steps,
    so syncs fall inside chunks), and ``evaluate`` goes through
    ``eval_params``."""
    from distributed_tensorflow_tpu_torch.engines import Trainer

    ds = small_dataset(16)
    results = []
    for k in (1, 8):
        mesh = meshlib.create_mesh(1, device="cpu")
        try:
            kw = dict(sync_every=3) if name == "async" else {}
            trainer = Trainer(None, engine=_engine(name, mesh, classes=10,
                                                   **kw))
            fit = trainer.fit(ds, batch_size=16, log_every=0,
                              steps_per_call=k)
            ev = trainer.evaluate(small_dataset(16, type="test"))
            results.append((fit["steps"], fit["final_loss"], ev,
                            _params(trainer.state.model)))
        finally:
            mesh.close()
    (s1, l1, e1, p1), (s8, l8, e8, p8) = results
    assert s1 == s8 == 128 // 16 and l1 == l8 and e1 == e8
    for k in p1:
        np.testing.assert_array_equal(p1[k], p8[k])


def test_local_engines_validate_their_cadence():
    with pytest.raises(ValueError, match="sync_every"):
        _engine("async", sync_every=0)
    with pytest.raises(ValueError, match="mix_every"):
        _engine("gossip", mix_every=0)
    eng = _engine("gossip", degree=2)
    assert (eng.degree, eng.mix_every, eng.sync_every) == (2, 1, 1 << 30)
