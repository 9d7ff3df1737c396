"""The port's tensor parallelism (``TensorParallelEngine``, ``TPMLP``,
``partition_model`` in the GPT and BERT, fsdp × tp) and the global-norm
clip under TP and EP, against the JAX package on gloo ranks (CPU).

One spawn of 4 ranks, run once by a module fixture.  The rank bodies
live at module level in this file, which imports no JAX at the top (a
spawned child re-imports the module of its target); the JAX references
are computed in the parent on the 8-device CPU mesh while the ranks run.
The ranks first form a group of 4 (a (data, model) mesh of (2, 2), and a
(data, expert) one for EP), then ranks 0 and 1 a group of 2 (a (1, 2)
mesh), then rank 0 a group of 1.  Every model starts from the JAX
engine's initial weights, unboxed (``flax.linen.unbox``) and converted in
the parent, then cut to each rank's slice (``convert.tp_shard_state_dict``
or the engine's ``load_full_state_dict``).  Dropout is 0: JAX draws one
mask over its global array, which per-rank torch streams cannot
reproduce.  Tolerances, each with its reason:

* ``TPMLP`` on (2, 2), SGD 0.5, 3 steps, against JAX's
  ``TensorParallelEngine`` on (2, 2): 1e-5 (JAX
  ``test_tp_matches_single_device``'s bound), the loss 1e-5.
* The GPT with ``partition_model`` (heads 4, kv_heads 2, dense) on
  (2, 2) and (1, 2), SGD 0.1, 3 steps, against JAX's single-device model
  (its ``TensorParallelEngine`` on (1, 1)): atol 2e-5, rtol 1e-4 (JAX
  ``test_tp_grad_accum_matches_k1``'s bound for this model); the GPT on
  ``flash`` (the plain version on the local heads) and with an untied
  head at the same bound.
* BERT-tiny with ``partition_model`` on (2, 2) and (1, 2), SGD 0.1, 2
  steps: atol 1e-4, rtol 1e-3 (JAX ``test_tp_bert_matches_single_device``).
* fsdp × tp on (2, 2), BERT, SGD 0.5, 3 steps, against JAX's
  ``FSDPEngine`` on (2, 2): atol 2e-5, rtol 1e-4 (JAX
  ``test_fsdp_tp_matches_sync_math``); each leaf's layout equals JAX's
  ``PartitionSpec``, leaf for leaf.
* A replicated parameter is bitwise the same on both ranks of a 'model'
  group after the steps.
* ``--clip-norm`` (``ScheduledAdamW``, eps 1 so that the update scales
  with the clipped gradient) under TP on (2, 2) against JAX's single
  device with ``optax.chain(clip_by_global_norm, adam)``: 1e-5; under EP
  on (2, 2) against JAX's ``ExpertParallelEngine``: 1e-5 (the bound of
  ``test_torch_expert_parallel.py``).
* A TP checkpoint written on (2, 2) restores bitwise under ``SyncEngine``
  on one rank.
* ``cli.main`` with ``-tp 2 -n 4`` and ``-m d -ds fsdp -tp 2 -n 4`` in
  the group of 4: summaries named ``tensor_parallel`` and
  ``fsdp_tp[fsdp*tp]`` (JAX's names, ``harness.py:1036, :1063``).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

WORLD = 4
GPT = dict(num_classes=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
           max_len=16, dropout_rate=0.0)
BERT = dict(num_classes=2, vocab_size=128, hidden=32, layers=2, heads=2,
            ffn=64, max_len=32, dropout_rate=0.0)
FSDP_BERT = dict(num_classes=2, vocab_size=64, hidden=32, layers=1, heads=2,
                 ffn=64, max_len=16, dropout_rate=0.0)
MOE = dict(num_classes=10, num_experts=4, embed_dim=16, expert_hidden=32,
           dropout_rate=0.0, router_top_k=1, capacity_factor=1.0)
TPMLP_KW = dict(num_classes=4, hidden=64, dropout_rate=0.0)
CLIP, CLIP_EPS, CLIP_LR = 0.05, 1.0, 0.05
GPT_TOL = dict(atol=2e-5, rtol=1e-4)
# the partitioned GPT's runs: attention, and the untied column-parallel
# head (its whole bias added after the logits' all-gather)
GPT_VARIANTS = {"dense": {}, "flash": {"attention_impl": "flash"},
                "untied": {"tie_embeddings": False}}
BERT_TOL = dict(atol=1e-4, rtol=1e-3)
CLI = {"tp": ["-tp", "2", "-n", "4", "-b", "8", "--model", "mlp",
              "--dataset", "synthetic", "--log-every", "0"],
       "fsdp_tp": ["-m", "d", "-ds", "fsdp", "-tp", "2", "-n", "4", "-b",
                   "8", "--model", "mlp", "--dataset", "synthetic",
                   "--log-every", "0"]}


def _images(n=64):
    rng = np.random.default_rng(5)
    return (rng.random((n, 8, 8, 1), dtype=np.float32),
            rng.integers(0, 4, n).astype(np.int32))


def _tokens():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 64, (8, 16)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _bert_tokens(vocab=128, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, vocab, (8, 16)).astype(np.int32),
            (np.arange(8) % 2).astype(np.int32))


def _moe_data():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((16, 8, 8)).astype(np.float32),
            rng.integers(0, 10, 16).astype(np.int32))


def _sgd(lr):
    return lambda params: torch.optim.SGD(params, lr=lr)


def _clip_opt(params):
    from distributed_tensorflow_tpu_torch.utils import optim

    params = list(params)
    return optim.ScheduledAdamW(params, CLIP_LR, eps=CLIP_EPS,
                                decay_mask=[False] * len(params),
                                clip_norm=CLIP)


def _train(out, prefix, eng, state, batches):
    for s, (x, y) in enumerate(batches, 1):
        state, m = eng.step(state, *eng.shard_batch(x, y))
        out[f"{prefix}/{s}/loss"] = np.asarray(float(m["loss"]))
        for k, v in eng.full_state_dict(state).items():
            out[f"{prefix}/{s}/{k}"] = v.float().numpy().copy()
    return state


def _model_run(out, prefix, mesh, make, init, opt, batches, cls=None,
               sample=None, **kw):
    """``make()`` under ``cls`` (``TensorParallelEngine``) on ``mesh``
    from the whole ``init``, cut by ``convert.tp_shard_state_dict``."""
    from distributed_tensorflow_tpu_torch.engines import TensorParallelEngine
    from distributed_tensorflow_tpu_torch.models import convert

    cls = cls or TensorParallelEngine
    eng = cls(make(), mesh=mesh, optimizer=opt, **kw)
    state = eng.init_state(torch.Generator().manual_seed(0), sample)
    if cls is TensorParallelEngine:
        state.model.load_state_dict(convert.tp_shard_state_dict(
            init, eng.param_specs, eng.tp,
            mesh.axis_index(meshlib.MODEL_AXIS)))
    else:
        eng.load_full_state_dict(state, init)
    return eng, _train(out, prefix, eng, state, batches)


def _gpt(**kw):
    from distributed_tensorflow_tpu_torch.models import create_model

    return create_model("gpt", **{**GPT, "partition_model": True,
                                  "device": "cpu", **kw})


def _bert(kw=BERT):
    from distributed_tensorflow_tpu_torch.models import create_model

    return create_model("bert_tiny", **kw, partition_model=True,
                        device="cpu")


def _sequence_runs(out, tag, mesh, inits):
    ids, tgt = _tokens()
    gpt_batches = [(ids, tgt)] * 3
    for impl, kw in GPT_VARIANTS.items():
        eng, state = _model_run(
            out, f"{tag}/gpt_{impl}", mesh, lambda: _gpt(**kw),
            inits["gpt_untied" if impl == "untied" else "gpt"], _sgd(0.1),
            gpt_batches)
        out[f"{tag}/gpt_{impl}/heads"] = np.asarray(
            [state.model.blocks[0].attn.heads,
             state.model.blocks[0].attn.kv_heads])
        for name, p in state.model.named_parameters():
            if not eng.param_specs.get(name):
                out[f"{tag}/replicated/{impl}/{name}"] = (
                    p.detach().numpy().copy())
    _model_run(out, f"{tag}/bert", mesh, _bert, inits["bert"], _sgd(0.1),
               [_bert_tokens()] * 2)


def _group_of_four(rank, inits, out_dir, out):
    from distributed_tensorflow_tpu_torch import cli
    from distributed_tensorflow_tpu_torch.engines import (
        ExpertParallelEngine, FSDPEngine, TPMLP)
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    mesh = meshlib.create_mesh(WORLD, device="cpu", shape=(2, 2),
                               axis_names=("data", "model"))
    x, y = _images()
    _model_run(out, "tpmlp", mesh,
               lambda: TPMLP(**TPMLP_KW, device="cpu"), inits["tpmlp"],
               _sgd(0.5), [(x, y)] * 3, sample=x[:1])
    _sequence_runs(out, "22", mesh, inits)
    eng, _ = _model_run(out, "fsdp_tp", mesh, lambda: _bert(FSDP_BERT),
                        inits["fsdp_tp"], _sgd(0.5),
                        [_bert_tokens(64, 5)] * 3, cls=FSDPEngine)
    out["fsdp_tp/specs"] = json.dumps(eng.param_specs)
    ids, tgt = _tokens()
    _model_run(out, "clip_tp", mesh, _gpt, inits["gpt"], _clip_opt,
               [(ids, tgt)] * 3)
    # a TP checkpoint (Adam, 2 steps), restored under sync on one rank
    eng, state = _model_run(out, "ckpt", mesh, _gpt, inits["gpt"],
                            lambda p: torch.optim.Adam(p, lr=1e-2),
                            [(ids, tgt)] * 2)
    CheckpointManager(f"{out_dir}/ckpt").save(state)
    for k, v in eng.checkpoint_state(state).items():
        if isinstance(v, torch.Tensor):
            out[f"ckpt/written/{k}"] = v.numpy().copy()
    for name, argv in CLI.items():
        out[f"cli/{name}"] = json.dumps(cli.main(argv + ["--device",
                                                         "cpu"]))
    mesh.close()
    # global-norm clip under EP, on a (data, expert) mesh
    mesh = meshlib.create_mesh(WORLD, device="cpu", shape=(2, 2),
                               axis_names=("data", "expert"))
    mx, my = _moe_data()
    eng = ExpertParallelEngine(create_model("moe", **MOE, device="cpu"),
                               mesh=mesh, optimizer=_clip_opt,
                               aux_weight=0.01)
    state = eng.init_state(torch.Generator().manual_seed(0), mx[:1])
    eng.load_full_state_dict(state, inits["clip_ep"])
    _train(out, "clip_ep", eng, state, [(mx, my)] * 2)
    mesh.close()


def _group_of_two(inits, out):
    mesh = meshlib.create_mesh(2, device="cpu", shape=(1, 2),
                               axis_names=("data", "model"))
    _sequence_runs(out, "12", mesh, inits)
    mesh.close()


def _group_of_one(out_dir, inits, out):
    from distributed_tensorflow_tpu_torch.engines import SyncEngine
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    mesh = meshlib.create_mesh(1, device="cpu")
    eng = SyncEngine(_gpt(partition_model=False), mesh=mesh,
                     optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))
    state = eng.init_state(torch.Generator().manual_seed(1))
    CheckpointManager(f"{out_dir}/ckpt").restore(state)
    for k, v in eng.checkpoint_state(state).items():
        if isinstance(v, torch.Tensor):
            out[f"ckpt/sync/{k}"] = v.numpy().copy()
    mesh.close()


def _rank(rank: int, ports, inits, out_dir: str) -> None:
    torch.set_num_threads(1)
    out: dict = {}
    meshlib.init_process_group("cpu", WORLD, rank,
                               f"tcp://127.0.0.1:{ports[0]}")
    try:
        _group_of_four(rank, inits, out_dir, out)
    finally:
        dist.destroy_process_group()
    if rank < 2:
        meshlib.init_process_group("cpu", 2, rank,
                                   f"tcp://127.0.0.1:{ports[1]}")
        try:
            _group_of_two(inits, out)
        finally:
            dist.destroy_process_group()
    if rank == 0:
        _group_of_one(out_dir, inits, out)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


# ------------------------------------------------------------- the parent


def _jnp_tree(params):
    import flax.linen as nn
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        nn.unbox(params))


def _jax_mesh(shape, axes=("data", "model")):
    from distributed_tensorflow_tpu.parallel import mesh as jmesh

    return jmesh.create_mesh(int(np.prod(shape)), shape=shape,
                             axis_names=axes)


class _JaxRun:
    """A JAX engine's initial weights (``to_sd``, converted) and the
    state_dict and loss after each of its steps."""

    def __init__(self, eng, sample, to_sd, key=0):
        import jax

        self.eng, self.to_sd = eng, to_sd
        self.state = eng.init_state(jax.random.key(key), sample)
        self.init = to_sd(_jnp_tree(self.state.params))
        self.steps = []

    def run(self, batches):
        state = self.state
        for x, y in batches:
            state, m = self.eng.step(state, *self.eng.shard_batch(x, y))
            sd = self.to_sd(_jnp_tree(state.params))
            self.steps.append((float(m["loss"]),
                               {k: v.numpy() for k, v in sd.items()}))
        self.state = state
        return self


def _jax_runs():
    import jax.numpy as jnp  # noqa: F401
    import optax

    from distributed_tensorflow_tpu.engines.expert_parallel import (
        ExpertParallelEngine)
    from distributed_tensorflow_tpu.engines.fsdp import FSDPEngine
    from distributed_tensorflow_tpu.engines.tensor_parallel import (
        TPMLP, TensorParallelEngine)
    from distributed_tensorflow_tpu.models import create_model
    from distributed_tensorflow_tpu_torch.models import convert

    clip = optax.chain(optax.clip_by_global_norm(CLIP),
                       optax.adam(CLIP_LR, eps=CLIP_EPS))
    x, _ = _images()
    ids, _ = _tokens()
    gpt = dict(GPT, partition_model=True)
    return {
        "tpmlp": _JaxRun(TensorParallelEngine(
            TPMLP(**TPMLP_KW), optimizer=optax.sgd(0.5),
            mesh=_jax_mesh((2, 2))), x, convert.mlp_state_dict),
        "gpt": _JaxRun(TensorParallelEngine(
            create_model("gpt", **gpt), optimizer=optax.sgd(0.1),
            mesh=_jax_mesh((1, 1))), ids, convert.gpt_state_dict),
        "gpt_untied": _JaxRun(TensorParallelEngine(
            create_model("gpt", **gpt, tie_embeddings=False),
            optimizer=optax.sgd(0.1), mesh=_jax_mesh((1, 1))), ids,
            convert.gpt_state_dict),
        "bert": _JaxRun(TensorParallelEngine(
            create_model("bert_tiny", **BERT, partition_model=True),
            optimizer=optax.sgd(0.1), mesh=_jax_mesh((1, 1))),
            _bert_tokens()[0], convert.bert_state_dict),
        "fsdp_tp": _JaxRun(FSDPEngine(
            create_model("bert_tiny", **FSDP_BERT, partition_model=True),
            optimizer=optax.sgd(0.5), mesh=_jax_mesh((2, 2))),
            _bert_tokens(64, 5)[0], convert.bert_state_dict),
        "clip_tp": _JaxRun(TensorParallelEngine(
            create_model("gpt", **gpt), optimizer=clip,
            mesh=_jax_mesh((1, 1))), ids, convert.gpt_state_dict),
        "clip_ep": _JaxRun(ExpertParallelEngine(
            create_model("moe", partition_experts=True, **MOE),
            optimizer=clip, aux_weight=0.01,
            mesh=_jax_mesh((2, 2), ("data", "expert"))), _moe_data()[0][:1],
            convert.moe_state_dict),
    }


def _jax_specs(run) -> dict:
    """Each leaf's layout in JAX's FSDP state, by the port's name, in the
    port's (out, in) layout: a Dense kernel's spec reversed."""
    import jax

    from distributed_tensorflow_tpu_torch.models import convert

    flat = jax.tree_util.tree_flatten_with_path(
        run.eng._state_shardings.params)[0]
    shapes = jax.tree.leaves(_jnp_tree(run.state.params))
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(_jnp_tree(run.state.params)),
        [np.full(s.shape, i, np.float32) for i, s in enumerate(shapes)])
    out = {}
    for name, t in convert.bert_state_dict(marked).items():
        i = int(t.reshape(-1)[0])
        path, sharding = flat[i]
        spec = tuple(sharding.spec) + (None,) * (t.dim() - len(
            sharding.spec))
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            spec = spec[::-1]
        out[name] = spec if any(a is not None for a in spec) else ()
    return out


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    runs = _jax_runs()
    inits = {name: run.init for name, run in runs.items()}
    out = tmp_path_factory.mktemp("tp")
    ranks = mp.spawn(_rank, args=([meshlib.free_port(), meshlib.free_port()],
                                  inits, str(out)), nprocs=WORLD, join=False)
    x, y = _images()
    ids, tgt = _tokens()
    runs["tpmlp"].run([(x, y)] * 3)
    runs["gpt"].run([(ids, tgt)] * 3)
    runs["gpt_untied"].run([(ids, tgt)] * 3)
    runs["bert"].run([_bert_tokens()] * 2)
    runs["fsdp_tp"].run([_bert_tokens(64, 5)] * 3)
    runs["clip_tp"].run([(ids, tgt)] * 3)
    runs["clip_ep"].run([_moe_data()] * 2)
    specs = _jax_specs(runs["fsdp_tp"])
    while not ranks.join():
        pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return runs, specs, got


def _held(got, prefix, run, ranks, **tol):
    for r in ranks:
        for s, (loss, params) in enumerate(run.steps, 1):
            np.testing.assert_allclose(got[r][f"{prefix}/{s}/loss"], loss,
                                       rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} {s} loss")
            for k, w in params.items():
                np.testing.assert_allclose(
                    got[r][f"{prefix}/{s}/{k}"], w, err_msg=f"{r} {s} {k}",
                    **tol)


def test_tpmlp_matches_jax_on_2x2(spawn_run):
    runs, _, got = spawn_run
    _held(got, "tpmlp", runs["tpmlp"], range(WORLD), rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", list(GPT_VARIANTS))
@pytest.mark.parametrize("tag,ranks", [("22", range(4)), ("12", range(2))])
def test_partitioned_gpt_matches_single_device(spawn_run, impl, tag, ranks):
    runs, _, got = spawn_run
    _held(got, f"{tag}/gpt_{impl}",
          runs["gpt_untied" if impl == "untied" else "gpt"], ranks,
          **GPT_TOL)
    for r in ranks:
        # 4 query and 2 K/V heads over 2 'model' ranks
        assert got[r][f"{tag}/gpt_{impl}/heads"].tolist() == [2, 1]


@pytest.mark.parametrize("tag,ranks", [("22", range(4)), ("12", range(2))])
def test_partitioned_bert_matches_single_device(spawn_run, tag, ranks):
    runs, _, got = spawn_run
    _held(got, f"{tag}/bert", runs["bert"], ranks, **BERT_TOL)


@pytest.mark.parametrize("tag,pairs", [("22", [(0, 1), (2, 3)]),
                                       ("12", [(0, 1)])])
def test_replicated_params_equal_on_every_model_rank(spawn_run, tag, pairs):
    _, _, got = spawn_run
    keys = [k for k in got[0] if k.startswith(f"{tag}/replicated/")]
    assert any("ln_f" in k for k in keys) and any("pos_embed" in k
                                                  for k in keys)
    assert any(k.endswith("lm_head.bias") for k in keys)
    for a, b in pairs:
        for k in keys:
            assert np.array_equal(got[a][k], got[b][k]), (a, b, k)


def test_fsdp_tp_matches_jax_leaf_for_leaf(spawn_run):
    runs, specs, got = spawn_run
    mine = json.loads(str(got[0]["fsdp_tp/specs"]))
    want = {k: list(v) for k, v in specs.items() if v}
    assert mine == want
    assert any("data" in v and "model" in v for v in mine.values())
    _held(got, "fsdp_tp", runs["fsdp_tp"], range(WORLD), **GPT_TOL)


@pytest.mark.parametrize("name", ["clip_tp", "clip_ep"])
def test_clip_norm_takes_the_global_norm(spawn_run, name):
    runs, _, got = spawn_run
    _held(got, name, runs[name], range(WORLD), rtol=0, atol=1e-5)


def test_tp_checkpoint_restores_under_sync(spawn_run):
    _, _, got = spawn_run
    written = {k[len("ckpt/written/"):]: v for k, v in got[0].items()
               if k.startswith("ckpt/written/")}
    restored = {k[len("ckpt/sync/"):]: v for k, v in got[0].items()
                if k.startswith("ckpt/sync/")}
    assert written["model/token_embed.weight"].shape == (64, 32)
    assert set(written) == set(restored)
    for k, v in written.items():
        assert np.array_equal(restored[k], v), k


@pytest.mark.parametrize("name,engine", [("tp", "tensor_parallel"),
                                         ("fsdp_tp", "fsdp_tp[fsdp*tp]")])
def test_cli_runs_tp_and_fsdp_tp_in_a_group_of_four(spawn_run, name,
                                                    engine):
    _, _, got = spawn_run
    for r in range(WORLD):
        summary = json.loads(str(got[r][f"cli/{name}"]))
        assert summary["engine"] == engine
        assert (summary["n_devices"], summary["data_parallel"],
                summary["tensor_parallel"]) == (4, 2, 2)
        assert np.isfinite(summary["test_loss"])
