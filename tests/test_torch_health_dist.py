"""The health layer's cross-rank reductions on 2 gloo ranks (CPU), held to
the port's ``SyncEngine`` at n = 1 (no JAX: the stats of the whole model
are the reference, whatever the layout):

* where the ranks hold slices — FSDP (``-m d -ds fsdp``, a ('data',) mesh
  of 2), TP (``-tp 2``, (1, 2) over ('data', 'model')) and a pipeline of
  2 stages ((1, 2) over ('data', 'pipe'), the MLP stages, 2
  microbatches) — ``grad_norm``, ``param_norm``, ``update_norm`` and
  ``update_ratio`` over 2 Adam steps equal those of ``SyncEngine`` at
  n = 1 (or, for the pipeline, its sequential model under the same Adam
  and capture) from the same weights and batch, within relative 1e-5
  (f32 sums in another order: the slices' squares summed across ranks);
* every rank reports the same stats;
* the injection poisons every leaf at step 3: the non-finite count is the
  model's leaf count, each leaf sliced over two ranks counted once (a
  pipeline's block leaf stacked over the stages is one leaf, as JAX's
  ``params["blocks"]``);
* where the ranks hold their own copies — local SGD (``sync_every`` 2)
  and gossip (``mix_every`` 2), whose captures see each rank's own local
  step — the norms and the ratio are the worst rank's (the max of each
  rank's n = 1 reference on its rows) and the count with every leaf of
  both ranks poisoned is the sum over the ranks.

One module fixture spawns the 2 ranks once; each forms its meshes in
turn on the one process group.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

WORLD = 2
LR = 1e-2
BATCH = 16
STEPS = 2
MLP_KW = dict(num_classes=10, hidden=32, dropout_rate=0.0)
KEYS = ("grad_norm", "param_norm", "update_norm", "update_ratio")
# f32 squared norms summed over the ranks' slices in another order
STATS = dict(rtol=1e-5, atol=0)


def _data(n: int = BATCH * (STEPS + 1), seed: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 8, 8, 1), dtype=np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _batches(steps: int = STEPS + 1):
    x, y = _data()
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(steps)]


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _stats(m: dict) -> np.ndarray:
    from distributed_tensorflow_tpu_torch.observability import health as hl

    return np.asarray([float(m[k]) for k in hl.HEALTH_KEYS[:5]])


def _train(eng, state, batches) -> np.ndarray:
    rows = []
    for x, y in batches:
        state, m = eng.step(state, *eng.shard_batch(x, y))
        rows.append(_stats(m))
    return np.stack(rows)


def _sync_reference(whole: dict, batches) -> np.ndarray:
    """``SyncEngine`` at n = 1 with health on, from the whole weights."""
    from distributed_tensorflow_tpu_torch.engines import SyncEngine
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    eng = SyncEngine(MLP(**MLP_KW, device="cpu"), optimizer=_adam,
                     device="cpu")
    eng.enable_health()
    state = eng.init_state(torch.Generator().manual_seed(0),
                           batches[0][0][:1])
    state.model.load_state_dict(whole)
    return _train(eng, state, batches)


def _sequential_reference(model, batches) -> np.ndarray:
    """The pipeline's sequential model under the same Adam and capture,
    stepped as ``SyncEngine`` at n = 1 steps."""
    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy
    from distributed_tensorflow_tpu_torch.observability import health as hl

    params = list(model.parameters())
    opt = hl.wrap_optimizer(_adam(params), hl.HealthConfig(), params)
    rows = []
    for x, y in batches:
        opt.zero_grad(set_to_none=True)
        cross_entropy(model(torch.from_numpy(x), train=True),
                      torch.from_numpy(y)).mean().backward()
        opt.step()
        rows.append(_stats(hl.from_opt_state(opt)))
    return np.stack(rows)


def _sliced(out: dict, tag: str, mesh, make, inject: bool) -> None:
    """A sliced engine from its own seeded weights (every rank draws the
    same), its stats over the batches, and the n = 1 reference from the
    same whole weights (rank 0)."""
    from distributed_tensorflow_tpu_torch.observability import health as hl

    eng = make(mesh)
    eng.enable_health(hl.HealthConfig(inject_nan_at=3 if inject else None))
    x0 = _data()[0][:1]
    state = eng.init_state(torch.Generator().manual_seed(0), x0)
    if tag == "pp":
        ref_model = eng.eval_params(state)     # a collective
    else:
        whole = eng.full_state_dict(state)     # a collective
    batches = _batches()
    out[f"{tag}/got"] = _train(eng, state, batches)
    out[f"{tag}/leaves"] = np.asarray(len(list(state.model.parameters())))
    if mesh.rank == 0:
        out[f"{tag}/want"] = (_sequential_reference(ref_model,
                                                    batches[:STEPS])
                              if tag == "pp" else
                              _sync_reference(whole, batches[:STEPS]))
        out[f"{tag}/whole_leaves"] = np.asarray(
            len(list(ref_model.parameters())) if tag == "pp"
            else len(whole))


def _per_rank(out: dict, tag: str, mesh, cls, inject_at: int,
              **kw) -> None:
    """Local SGD or gossip from the same seeded weights: the capture of
    each rank's own step, against this rank's n = 1 reference on its
    rows."""
    from distributed_tensorflow_tpu_torch.engines import SyncEngine
    from distributed_tensorflow_tpu_torch.models.mlp import MLP
    from distributed_tensorflow_tpu_torch.observability import health as hl

    eng = cls(MLP(**MLP_KW, device="cpu"), mesh=mesh, optimizer=_adam, **kw)
    eng.enable_health(hl.HealthConfig(inject_nan_at=inject_at))
    x0 = _data()[0][:1]
    state = eng.init_state(torch.Generator().manual_seed(0), x0)
    whole = {k: v.clone() for k, v in state.model.state_dict().items()}
    batches = _batches()[:inject_at]
    out[f"{tag}/got"] = _train(eng, state, batches)
    half = BATCH // WORLD
    mine = [(x[mesh.rank * half:(mesh.rank + 1) * half],
             y[mesh.rank * half:(mesh.rank + 1) * half])
            for x, y in batches[:STEPS]]
    ref = SyncEngine(MLP(**MLP_KW, device="cpu"), optimizer=_adam,
                     device="cpu")
    ref.enable_health()
    rstate = ref.init_state(torch.Generator().manual_seed(0), x0)
    rstate.model.load_state_dict(whole)
    out[f"{tag}/mine"] = _train(ref, rstate, mine)
    out[f"{tag}/leaves"] = np.asarray(len(whole))


def _rank(rank: int, port: int, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch.engines import (
        AsyncLocalEngine, FSDPEngine, GossipEngine, PipelineEngine,
        TensorParallelEngine, TPMLP)
    from distributed_tensorflow_tpu_torch.models.mlp import MLP

    torch.set_num_threads(1)
    out: dict = {}
    meshlib.init_process_group("cpu", WORLD, rank, f"tcp://127.0.0.1:{port}")
    try:
        cases = {
            "fsdp": (lambda: meshlib.create_mesh(WORLD, device="cpu"),
                     lambda mesh: FSDPEngine(MLP(**MLP_KW, device="cpu"),
                                             mesh=mesh, optimizer=_adam)),
            "tp": (lambda: meshlib.create_mesh(
                       WORLD, device="cpu", shape=(1, 2),
                       axis_names=("data", "model")),
                   lambda mesh: TensorParallelEngine(
                       TPMLP(**MLP_KW, device="cpu"), mesh=mesh,
                       optimizer=_adam)),
            "pp": (lambda: meshlib.create_mesh(
                       WORLD, device="cpu", shape=(1, 2),
                       axis_names=("data", "pipe")),
                   lambda mesh: PipelineEngine(
                       num_classes=10, hidden=16, microbatches=2,
                       mesh=mesh, optimizer=_adam)),
        }
        for tag, (make_mesh, make) in cases.items():
            mesh = make_mesh()
            _sliced(out, tag, mesh, make, inject=True)
            mesh.close()
        mesh = meshlib.create_mesh(WORLD, device="cpu")
        _per_rank(out, "async", mesh, AsyncLocalEngine, STEPS + 1,
                  sync_every=2)
        _per_rank(out, "gossip", mesh, GossipEngine, STEPS + 1,
                  mix_every=2)
        mesh.close()
        # the (1, 2) meshes made sub-groups of one rank each: meet before
        # the store goes
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("health_dist")
    mp.spawn(_rank, args=(meshlib.free_port(), str(out)), nprocs=WORLD,
             join=True)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("tag", ["fsdp", "tp", "pp"])
def test_sliced_engines_report_the_whole_models_norms(spawn_run, tag):
    r0, r1 = spawn_run
    got, want = r0[f"{tag}/got"], r0[f"{tag}/want"]
    np.testing.assert_array_equal(r1[f"{tag}/got"], got)
    for i, key in enumerate(KEYS):
        np.testing.assert_allclose(got[:STEPS, i], want[:, i],
                                   err_msg=key, **STATS)
    assert (got[:STEPS, 4] == 0).all() and (want[:, 4] == 0).all()


@pytest.mark.parametrize("tag", ["fsdp", "tp", "pp"])
def test_a_poisoned_sliced_leaf_counts_once(spawn_run, tag):
    r0, r1 = spawn_run
    # step 3's gradients times inf: every leaf of the whole model turns
    # non-finite, each counted once however many ranks hold its slices —
    # a pipeline's block leaf is one leaf stacked over the stages (JAX's
    # params["blocks"]), not one per stage
    leaves = int(r0[f"{tag}/leaves"])
    assert r0[f"{tag}/got"][STEPS, 4] == r1[f"{tag}/got"][STEPS, 4] == \
        leaves
    if tag == "pp":
        assert int(r0["pp/whole_leaves"]) > leaves
    else:
        assert int(r0[f"{tag}/whole_leaves"]) == leaves
    assert not np.isfinite(r0[f"{tag}/got"][STEPS, 2])


@pytest.mark.parametrize("tag", ["async", "gossip"])
def test_per_rank_engines_report_the_worst_rank_and_the_count_sum(
        spawn_run, tag):
    r0, r1 = spawn_run
    got = r0[f"{tag}/got"]
    np.testing.assert_array_equal(r1[f"{tag}/got"], got)
    worst = np.maximum(r0[f"{tag}/mine"], r1[f"{tag}/mine"])
    assert not np.array_equal(r0[f"{tag}/mine"], r1[f"{tag}/mine"])
    for i, key in enumerate(KEYS):
        np.testing.assert_allclose(got[:STEPS, i], worst[:, i],
                                   err_msg=key, **STATS)
    # every leaf of both ranks' copies poisoned at step 3: the sum
    assert got[STEPS, 4] == WORLD * int(r0[f"{tag}/leaves"])
