"""The port's ``ExpertParallelEngine`` and ``-ep`` against the JAX
package, on four gloo ranks (CPU).

One spawn of 4 ranks on a (data, expert) mesh of shape (2, 2), run once
by a module fixture.  The rank bodies live at module level in this file,
which imports no JAX at the top: a spawned child re-imports the module
that defines its target, and the JAX references are computed in the
parent, on a (2, 2) mesh of the 8-device CPU mesh.

* ``ExpertParallelEngine`` for 2 SGD steps on a small ``MoEClassifier``
  (embed 16, 4 experts of hidden 32, 2 per rank; 16 rows a step, 4 per
  rank), top-1, and top-2 with two layers and ``grad_accum`` 2, with
  the aux and z weights non-zero and dropout 0, from the JAX
  engine's initial weights (``models/convert.py``, sliced by
  ``load_full_state_dict``).  JAX routes the global batch as one group, so
  these hold the port's global routing (capacity from every rank's tokens,
  slots in rank-major token order, overflowed tokens among them) and its
  gradient scaling (replicated parameters summed over the world, experts
  over the data axis, the router terms' shares).  After each step every
  rank's gathered parameters (``full_state_dict``) equal JAX's within
  ``atol=1e-5``, and ``loss``, ``total_loss`` and ``overflow`` within
  ``1e-5``.  SGD, because it is linear in the gradient: a wrong scale
  shows.  ``evaluate``'s count and accuracy equal JAX's.
* ``cli.main`` with ``-n 4 -ep 2 --model moe --dataset synthetic``, run in
  the ranks' group: the summary is named ``expert_parallel`` and carries
  the JAX CLI summary's MoE keys (``expert_parallel``, ``num_experts``,
  the overflow monitor's report) and its mesh sizes and step count.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

LR = 0.1
STEPS, BATCH, EVAL_ROWS = 2, 16, 24
PARAMS_ATOL, METRIC_ATOL = 1e-5, 1e-5
MODEL = dict(num_classes=10, num_experts=4, embed_dim=16, expert_hidden=32,
             dropout_rate=0.0)
CASES = {
    "top1": dict(model=dict(router_top_k=1, capacity_factor=1.0)),
    "top2_depth2_accum": dict(model=dict(router_top_k=2, capacity_factor=1.0,
                                         depth=2), grad_accum=2),
}
ENGINE = dict(aux_weight=0.01, router_z_weight=1e-3)
METRICS = ("loss", "total_loss", "overflow", "accuracy")
CLI_ARGV = ["-n", "4", "-ep", "2", "--model", "moe", "--dataset",
            "synthetic", "--log-every", "0"]


def _data():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH * STEPS + EVAL_ROWS, 8, 8)).astype(
        np.float32)
    y = rng.integers(0, 10, len(x)).astype(np.int32)
    n = BATCH * STEPS
    return x[:n], y[:n], x[n:], y[n:]


def _batches():
    x, y, _, _ = _data()
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(STEPS)]


def _join(rank: int, world: int, port: int):
    torch.set_num_threads(1)
    meshlib.init_process_group("cpu", world, rank, f"tcp://127.0.0.1:{port}")


def _engine_rank(rank: int, port: int, inits, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch import cli
    from distributed_tensorflow_tpu_torch.engines import ExpertParallelEngine
    from distributed_tensorflow_tpu_torch.models import create_model

    _join(rank, 4, port)
    try:
        mesh = meshlib.create_mesh(4, device="cpu", shape=(2, 2),
                                   axis_names=("data", "expert"))
        out = {}
        _, _, tx, ty = _data()
        for name, case in CASES.items():
            model = create_model("moe", device="cpu", **MODEL,
                                 **case["model"])
            eng = ExpertParallelEngine(
                model, mesh=mesh, grad_accum=case.get("grad_accum", 1),
                optimizer=lambda p: torch.optim.SGD(p, lr=LR), **ENGINE)
            state = eng.init_state(torch.Generator().manual_seed(0),
                                   tx[:1])
            eng.load_full_state_dict(state, inits[name])
            out[f"{name}/shapes"] = np.asarray(
                [p.shape[0] for n, p in state.model.named_parameters()
                 if n.endswith(".w1")])
            for s, (x, y) in enumerate(_batches(), 1):
                state, m = eng.step(state, *eng.shard_batch(x, y))
                for key in METRICS:
                    out[f"{name}/{s}/{key}"] = np.asarray(float(m[key]))
                out.update({f"{name}/{s}/{k}": v.numpy()
                            for k, v in eng.full_state_dict(state).items()})
            ev = eng.evaluate(state, tloaders.Dataset(x=tx, y=ty,
                                                      num_classes=10),
                              batch_size=8)
            out[f"{name}/eval"] = np.asarray([ev["accuracy"], ev["count"]])
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
        summary = cli.main(CLI_ARGV + ["--device", "cpu"])
        with open(f"{out_dir}/cli{rank}.json", "w") as f:
            json.dump(summary, f)
    finally:
        dist.destroy_process_group()


def _jax_engine(case):
    """The JAX ExpertParallelEngine of ``case`` on a (2, 2) mesh of the
    8-device CPU mesh, its initial state, and that state's weights as a
    port state_dict."""
    import jax
    import optax

    from distributed_tensorflow_tpu.engines.expert_parallel import (
        ExpertParallelEngine)
    from distributed_tensorflow_tpu.models import create_model
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu_torch.models import convert

    model = create_model("moe", partition_experts=True, **MODEL,
                         **case["model"])
    eng = ExpertParallelEngine(
        model, optimizer=optax.sgd(LR),
        mesh=jmesh.create_mesh(4, shape=(2, 2),
                               axis_names=("data", "expert")),
        grad_accum=case.get("grad_accum", 1), **ENGINE)
    state = eng.init_state(jax.random.key(0), _data()[2][:1])
    return eng, state, convert.moe_state_dict(
        jax.tree.map(np.asarray, state.params))


def _jax_steps(eng, state):
    """(each step's state_dict and metrics, the evaluation)."""
    import jax

    from distributed_tensorflow_tpu.data import loaders as jloaders
    from distributed_tensorflow_tpu_torch.models import convert

    per_step = []
    for x, y in _batches():
        state, m = eng.step(state, *eng.shard_batch(x, y))
        sd = convert.moe_state_dict(jax.tree.map(np.asarray, state.params))
        per_step.append(({k: v.numpy() for k, v in sd.items()},
                         {key: float(m[key]) for key in METRICS}))
    _, _, tx, ty = _data()
    ev = eng.evaluate(state, jloaders.Dataset(x=tx, y=ty, num_classes=10),
                      batch_size=8)
    return per_step, ev


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    """The ranks start from the JAX engines' weights and run while the
    parent steps the JAX engines and runs the JAX CLI."""
    from distributed_tensorflow_tpu import cli as jcli

    engines = {name: _jax_engine(case) for name, case in CASES.items()}
    inits = {name: run[2] for name, run in engines.items()}
    out = tmp_path_factory.mktemp("ep")
    ranks = mp.spawn(_engine_rank, args=(meshlib.free_port(), inits,
                                         str(out)), nprocs=4, join=False)
    jax_runs = {name: (inits[name], *_jax_steps(eng, state))
                for name, (eng, state, _) in engines.items()}
    with pytest.warns(UserWarning, match="capacity"):
        want_cli = jcli.main(CLI_ARGV)
    while not ranks.join():
        pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    got_cli = [json.loads((out / f"cli{r}.json").read_text())
               for r in range(4)]
    return jax_runs, got, want_cli, got_cli


@pytest.mark.parametrize("name", list(CASES))
def test_engine_equals_jax_every_step(spawn_run, name):
    jax_runs, ranks, _, _ = spawn_run
    init, per_step, _ = jax_runs[name]
    for r, got in enumerate(ranks):
        # each rank holds 2 of the 4 experts of every layer
        assert set(got[f"{name}/shapes"].tolist()) == {2}
        for s, (want, metrics) in enumerate(per_step, 1):
            for key, w in metrics.items():
                np.testing.assert_allclose(got[f"{name}/{s}/{key}"], w,
                                           rtol=0, atol=METRIC_ATOL,
                                           err_msg=f"rank {r} {s} {key}")
            for key, w in want.items():
                np.testing.assert_allclose(got[f"{name}/{s}/{key}"], w,
                                           rtol=0, atol=PARAMS_ATOL,
                                           err_msg=f"rank {r} {s} {key}")
    # the router terms count, tokens overflowed, and the experts trained
    first = per_step[0][1]
    assert first["total_loss"] - first["loss"] > 1e-3
    assert max(m["overflow"] for _, m in per_step) > 0
    moved = max(np.abs(per_step[-1][0][k] - init[k].numpy()).max()
                for k in init if k.endswith((".w1", ".w2")))
    assert moved > 1e-3


@pytest.mark.parametrize("name", list(CASES))
def test_evaluate_counts_every_example(spawn_run, name):
    jax_runs, ranks, _, _ = spawn_run
    jev = jax_runs[name][2]
    for got in ranks:
        acc, count = got[f"{name}/eval"]
        assert count == EVAL_ROWS == jev["count"]
        np.testing.assert_allclose(acc, jev["accuracy"], rtol=0, atol=1e-6)


def test_cli_four_ranks_expert_parallel_summary(spawn_run):
    _, _, want, got = spawn_run
    assert got[0]["engine"] == want["engine"] == "expert_parallel"
    for key in ("n_devices", "data_parallel", "expert_parallel",
                "num_experts", "global_batch", "steps"):
        assert got[0][key] == want[key], key
    assert (got[0]["n_devices"], got[0]["data_parallel"],
            got[0]["expert_parallel"], got[0]["num_experts"]) == (4, 2, 2, 8)
    for key in ("expert_overflow_window_mean", "expert_overflow_warnings"):
        assert key in got[0] and key in want, key
    assert 0.0 <= got[0]["expert_overflow_window_mean"] <= 1.0
    assert got[0]["test_accuracy"] > 0.5 and want["test_accuracy"] > 0.5
    # every rank reports the same all-reduced evaluation
    assert len({g["test_loss"] for g in got}) == 1
