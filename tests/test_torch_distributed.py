"""The port's data-parallel path across processes: ``parallel/collectives``,
``SyncEngine`` over a 2-rank mesh, and the CLI's ``-n 2``, on gloo (CPU).

Every multi-process check runs inside one of three spawns of 2 ranks (a
spawn costs seconds): the rank bodies live at module level in this file,
which imports no JAX at the top, because a spawned child re-imports the
module that defines its target.  JAX references are computed in the
parent, inside the tests.

* spawn 1: every collective against a numpy model of what JAX's device of
  the same index gets;
* spawn 2: equal initial parameters on both ranks; 3 SGD steps of the MLP
  on 2 ranks equal to the single-process full batch and to the JAX
  ``SyncEngine`` on a 2-device mesh (SGD, so a wrong gradient scale
  shows; atol 1e-5); ``grad_accum=2`` on 2 ranks equal to K = 1; the
  mesh's evaluate equal to one process's;
* spawn 3: ``cli.main`` with ``-n 2``: the summary, and the result file
  and supervisor events written once (by rank 0).
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

WORLD = 2
SGD_LR = 0.5
SGD_STEPS = 3
PARAMS_ATOL = 1e-5   # as JAX tests/test_engines.py: f32 sums in other orders


def _join(rank: int, port: int):
    torch.set_num_threads(1)
    meshlib.init_process_group("cpu", WORLD, rank, f"tcp://127.0.0.1:{port}")
    return meshlib.create_mesh(WORLD, device="cpu")


def _spawn(body, *args):
    mp.spawn(body, args=(meshlib.free_port(), *args), nprocs=WORLD, join=True)


# ------------------------------------------------------------- spawn 1

def _value(r: int) -> np.ndarray:
    return (np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * r)


def _collectives_rank(rank: int, port: int) -> None:
    mesh = _join(rank, port)
    try:
        xs = [_value(r) for r in range(WORLD)]
        x = torch.from_numpy(xs[rank])
        tree = {"a": x, "b": {"c": x[0, 0] + 1}}
        eq = np.testing.assert_array_equal
        assert (coll.axis_size(mesh), coll.axis_index(mesh)) == (WORLD, rank)
        out = coll.all_reduce_sum(tree, mesh)
        eq(out["a"].numpy(), xs[0] + xs[1])
        eq(out["b"]["c"].numpy(), xs[0][0, 0] + xs[1][0, 0] + 2)
        eq(x.numpy(), xs[rank])                      # input untouched
        eq(coll.all_reduce_mean(tree, mesh)["a"].numpy(),
           (xs[0] + xs[1]) / 2)
        eq(coll.all_gather(x, mesh).numpy(), np.stack(xs))
        eq(coll.all_gather(x, mesh, tiled=True).numpy(), np.concatenate(xs))
        eq(coll.reduce_scatter_sum(x, mesh).numpy(),
           np.split(xs[0] + xs[1], WORLD)[rank])
        # tiled all_to_all: chunk j of every rank goes to rank j, the
        # arrivals concatenated in rank order
        for split, concat in ((0, 1), (1, 0), (1, 1)):
            want = np.concatenate(
                [np.split(xs[j], WORLD, axis=split)[rank]
                 for j in range(WORLD)], axis=concat)
            eq(coll.all_to_all(x, mesh, split, concat).numpy(), want)
        for shift in (1, -1, 2, 3):
            eq(coll.ring_shift(tree, mesh, shift)["a"].numpy(),
               xs[(rank - shift) % WORLD])
        # 2·degree + 1 >= n: the neighbourhood is the ring, the full mean
        eq(coll.neighbor_mean(tree, mesh, degree=1)["a"].numpy(),
           (xs[0] + xs[1]) / 2)
        assert coll.neighbor_mean(tree, mesh, degree=0) is tree
        eq(coll.broadcast_from(tree, mesh, src=1)["a"].numpy(), xs[1])
        before = coll.all_reduce_.launches
        y = torch.ones(3)
        assert coll.all_reduce_(y, mesh) is y and y.tolist() == [2.0] * 3
        assert coll.all_reduce_.launches == before + 1
        assert coll.all_reduce_.nccl_launches == 0
        for bad in (lambda: coll.reduce_scatter_sum(torch.ones(3), mesh),
                    lambda: coll.all_to_all(torch.ones(3, 2), mesh, 0, 1)):
            try:
                bad()
            except ValueError:
                continue
            raise AssertionError("an indivisible split did not raise")
    finally:
        dist.destroy_process_group()


def test_collectives_match_numpy_model():
    _spawn(_collectives_rank)


# ------------------------------------------------------------- spawn 2

def _mlp_data():
    rng = np.random.default_rng(0)
    x = rng.random((16, 6, 5, 1), dtype=np.float32)
    y = rng.integers(0, 4, 16).astype(np.int32)
    return x, y


def _mlp_engine(mesh=None, grad_accum: int = 1):
    from distributed_tensorflow_tpu_torch.engines import SyncEngine
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    model = MLP(num_classes=4, hidden=32, dropout_rate=0.0, device="cpu")
    return SyncEngine(model, mesh=mesh, device=None if mesh else "cpu",
                      grad_accum=grad_accum,
                      optimizer=lambda p: torch.optim.SGD(p, lr=SGD_LR))


def _sgd_run(eng, state_dict, x, y, steps=SGD_STEPS):
    state = eng.init_state(torch.Generator().manual_seed(0), x)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    state.model.load_state_dict(state_dict)
    losses = []
    for _ in range(steps):
        state, m = eng.step(state, *eng.shard_batch(x, y))
        losses.append(float(m["loss"]))
    return state, init, losses


def _sync_rank(rank: int, port: int, state_dict, out_dir: str) -> None:
    mesh = _join(rank, port)
    try:
        x, y = _mlp_data()
        eng = _mlp_engine(mesh)
        state, init, losses = _sgd_run(eng, state_dict, x, y)
        accum_state, _, accum_losses = _sgd_run(
            _mlp_engine(mesh, grad_accum=2), state_dict, x, y)
        test = tloaders.Dataset(x=x[:13], y=y[:13], num_classes=4)
        ev = eng.evaluate(state, test, batch_size=5)
        np.savez(f"{out_dir}/rank{rank}.npz",
                 losses=np.asarray(losses),
                 accum_losses=np.asarray(accum_losses),
                 eval=np.asarray([ev["accuracy"], ev["loss"], ev["count"]]),
                 **{f"init/{k}": v.numpy() for k, v in init.items()},
                 **{f"final/{k}": v.numpy()
                    for k, v in state.model.state_dict().items()},
                 **{f"accum/{k}": v.numpy()
                    for k, v in accum_state.model.state_dict().items()})
    finally:
        dist.destroy_process_group()


def test_two_rank_sync_equals_full_batch_and_jax_mesh(tmp_path):
    import jax
    import optax

    from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
    from distributed_tensorflow_tpu.models.mlp import MLP as JaxMLP
    from distributed_tensorflow_tpu.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.models.convert import mlp_state_dict

    x, y = _mlp_data()
    jeng = JaxSync(JaxMLP(num_classes=4, hidden=32, dropout_rate=0.0),
                   optimizer=optax.sgd(SGD_LR), mesh=create_mesh(WORLD))
    jstate = jeng.init_state(jax.random.key(0), x)
    state_dict = mlp_state_dict(jax.tree.map(np.asarray, jstate.params))
    jlosses = []
    for _ in range(SGD_STEPS):
        jstate, jm = jeng.step(jstate, *jeng.shard_batch(x, y))
        jlosses.append(float(jm["loss"]))
    want = mlp_state_dict(jax.tree.map(np.asarray, jstate.params))

    single_state, _, single_losses = _sgd_run(_mlp_engine(), state_dict,
                                              x, y)
    single_eval = _mlp_engine().evaluate(
        single_state, tloaders.Dataset(x=x[:13], y=y[:13], num_classes=4),
        batch_size=5)

    _spawn(_sync_rank, state_dict, str(tmp_path))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    for key in ranks[0]:                     # every rank holds the same
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key], key)
    got = ranks[0]
    for name, w in want.items():
        for ref in (w.numpy(), single_state.model.state_dict()[name].numpy()):
            np.testing.assert_allclose(got[f"final/{name}"], ref,
                                       atol=PARAMS_ATOL, err_msg=name)
        np.testing.assert_allclose(got[f"accum/{name}"],
                                   got[f"final/{name}"], atol=PARAMS_ATOL,
                                   err_msg=name)
    for ref in (jlosses, single_losses):
        np.testing.assert_allclose(got["losses"], ref, atol=PARAMS_ATOL)
    np.testing.assert_allclose(got["accum_losses"], got["losses"],
                               atol=PARAMS_ATOL)
    # 13 rows at batch 5 → batch 4 on 2 ranks: every row counted once
    assert got["eval"][2] == single_eval["count"] == 13
    np.testing.assert_allclose(got["eval"][:2], [single_eval["accuracy"],
                                                 single_eval["loss"]],
                               rtol=1e-6)


# ------------------------------------------------------------- spawn 3

def small_dataset(batch_size, type="train"):
    """A picklable ``dataset_fn``: 256 train / 64 test synthetic rows."""
    del batch_size
    n, split = (256, "train") if type == "train" else (64, "test")
    x, y = tloaders.synthetic_classification((28, 28), 10, n, seed=7,
                                             split=split)
    return tloaders.Dataset(x=x[..., None], y=y, num_classes=10,
                            name="small", synthetic=True)


def test_cli_two_ranks(tmp_path, capsys):
    from distributed_tensorflow_tpu_torch.cli import main
    from distributed_tensorflow_tpu_torch.utils.supervisor import (
        SupervisorListener)

    events = tmp_path / "events.jsonl"
    listener = SupervisorListener()
    try:
        summary = main(["--device", "cpu", "-m", "d", "-ds", "keras",
                        "-n", "2", "-b", "8", "--model", "mlp",
                        "--log-every", "0", "--result-path", str(events),
                        "--supervisor", f"127.0.0.1:{listener.port}"],
                       dataset_fn=small_dataset)
    finally:
        listener.close()
    assert summary["engine"] == "allreduce"
    assert summary["n_devices"] == summary["data_parallel"] == 2
    assert summary["global_batch"] == 16 and summary["steps"] == 256 // 16
    assert summary["steps_per_call"] == 8 and summary["prefetch_depth"] == 2
    assert summary["dataset"] == "small" and summary["synthetic_data"]
    assert np.isfinite(summary["test_loss"])
    assert 0.0 <= summary["test_accuracy"] <= 1.0
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == summary
    lines = [json.loads(line) for line in events.read_text().splitlines()]
    assert [e["event"] for e in lines] == ["start", "done", "results",
                                           "summary"]
    assert listener.messages[0] == "start"
    assert [m[0] for m in listener.messages[1:]] == ["done", "results"]
    assert listener.messages[2][1] == summary["test_accuracy"]
