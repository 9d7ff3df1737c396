"""The port's composites without the pipeline (``CompositeEngine``: tp×sp,
ep×sp, ep×tp×sp; ep×tp in ``ExpertParallelEngine``; grouped routing and
the 2-D expert layout in ``MoELayer``) against the JAX package, on gloo
ranks (CPU).

One spawn of 8 ranks, run once by a module fixture.  The rank bodies live
at module level in this file, which imports no JAX at the top (a spawned
child re-imports the module of its target); the JAX references are
computed in the parent on the 8-device CPU mesh while the ranks run.  The
ranks first form a group of 8, then ranks 0-3 a group of 4.  Every engine
starts from the JAX engine's initial weights, unboxed and converted in the
parent, cut to each rank's slices by ``convert.tp_shard_state_dict`` (the
'model' and the 'expert' cut).  Dropout is 0: JAX draws one mask over its
global arrays, which per-rank torch streams cannot reproduce.  SGD, which
is linear in the gradient, so a wrong scale shows.  Inside ``shard_map``
JAX runs its jnp attention twins, so the port's ``ring_flash`` runs its
plain block versions here (the card holds the kernels: ``chip_smoke.py``
phase 5m and ``test_torch_composite_cuda.py``).  Tolerances:

* tp×sp against JAX's ``CompositeEngine`` on (2, 2, 2) (data, model,
  seq): BERT-tiny with ``ring`` (2 steps) and ``ulysses`` (heads 4, 1
  step), and ``ring`` with ``grad_accum`` 2 held to JAX's K = 1 run (JAX
  ``test_composite_grad_accum_parity_*``); on (1, 2, 2) the GPT LM with
  ``ring_flash`` and grouped K/V heads (2 steps).  Parameters atol 1e-4,
  rtol 1e-3, the loss 1e-4 (JAX ``test_composite_matches_single_device``).
* ep×sp against JAX's ``CompositeEngine`` on (2, 2, 2) (data, expert,
  seq): the MoE GPT with ``ring`` and BERT with MoE layers, capacity
  factor 1.0, so that tokens drop, with the aux and z weights on (2 and
  1 steps).  One group of every data rank's tokens of a seq block, so the
  capacity and the slots are global.  Parameters atol 1e-5, rtol 1e-4
  (JAX ``test_ep_sp_matches_single_device``); ``loss``, ``total_loss``
  and ``overflow`` 1e-5.
* ep×tp against JAX's ``ExpertParallelEngine`` on (2, 2, 2) (data,
  expert, model): the MoE classifier with the 2-D layout, top-2, with
  drops (2 steps), at ``test_torch_expert_parallel.py``'s 1e-5.
* ep×tp×sp against JAX's ``CompositeEngine`` on (1, 2, 2, 2) (data,
  expert, seq, model): the partitioned MoE GPT (1 step), at the ep×sp
  bounds.
* Grouped routing with no engine: ``MoELayer(group_size=S)`` on a (2, 2)
  (data, expert) mesh, 12 tokens a rank, against JAX's ``MoELayer`` over
  the 48 global tokens, top-2 with drops: S = 4 (groups inside a rank),
  24 (groups spanning ranks), 8 (groups cut across rank boundaries) and
  7 (does not divide: one group).  Outputs, ``aux_loss``, ``z_loss``,
  ``overflow`` and the gradients of ``sum(y·c) + aux + z`` within 1e-5.
* ``cli.main`` with ``-n 8 -ep 2 -sp 2`` and ``-n 8 -ep 2 -tp 2 -sp 2``
  (the MoE GPT, a 32-row LM set): JAX's summary names
  (``harness.py:1572-1573``), finite perplexity.
* A whole-leaf checkpoint written under ep×tp×sp holds every expert and
  every hidden column, equals the engine's gathered state, and restores
  bitwise into a fresh state.
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

WORLD, LR = 8, 0.1
BERT = dict(num_classes=2, vocab_size=128, hidden=32, layers=1, heads=2,
            ffn=64, max_len=64, dropout_rate=0.0)
GPT = dict(num_classes=64, hidden=32, layers=1, heads=2, ffn=64,
           max_len=64, dropout_rate=0.0)
MOE_KW = dict(moe_experts=4, moe_capacity_factor=1.0, partition_experts=True)
CLASSIFIER = dict(num_classes=10, num_experts=4, embed_dim=16,
                  expert_hidden=32, dropout_rate=0.0, router_top_k=2,
                  capacity_factor=1.0)
ROUTER = dict(aux_weight=0.01, router_z_weight=1e-3)
TP_SP, EP_SP = ("data", "model", "seq"), ("data", "expert", "seq")
EP_TP, EP_TP_SP = ("data", "expert", "model"), ("data", "expert", "seq",
                                                "model")
# name: (family, mesh shape, axes, model kwargs, steps, engine kwargs)
CASES = {
    "bert_ring": ("bert", (2, 2, 2), TP_SP,
                  dict(attention_impl="ring", partition_model=True), 2, {}),
    "bert_ulysses": ("bert", (2, 2, 2), TP_SP,
                     dict(attention_impl="ulysses", partition_model=True,
                          heads=4), 1, {}),
    "bert_ring_accum": ("bert", (2, 2, 2), TP_SP,
                        dict(attention_impl="ring", partition_model=True), 1,
                        dict(grad_accum=2)),
    "gpt_moe_ep_sp": ("gpt", (2, 2, 2), EP_SP,
                      dict(attention_impl="ring", **MOE_KW), 2, ROUTER),
    "bert_moe_ep_sp": ("bert", (2, 2, 2), EP_SP,
                       dict(attention_impl="ring", **MOE_KW), 1, ROUTER),
    "moe_ep_tp": ("moe", (2, 2, 2), EP_TP,
                  dict(partition_experts=True, partition_model=True), 2,
                  ROUTER),
    "gpt_moe_ep_tp_sp": ("gpt", (1, 2, 2, 2), EP_TP_SP,
                         dict(attention_impl="ring", partition_model=True,
                              **MOE_KW), 1, ROUTER),
    "gpt_ring_flash": ("gpt", (1, 2, 2), TP_SP,
                       dict(attention_impl="ring_flash", partition_model=True,
                            heads=4, kv_heads=2), 2, {}),
}
# the grad_accum case is held to JAX's K = 1 run of the same model
JAX_TWIN = {"bert_ring_accum": "bert_ring"}
GROUP_OF_FOUR = ("gpt_ring_flash",)
# cases whose evaluate (12 rows in batches of 8: a padded last batch) is
# held to JAX's: an LM's totals sum over 'seq', a classifier's do not
EVALUATED = ("gpt_moe_ep_sp", "bert_ring")
TP_SP_TOL = dict(atol=1e-4, rtol=1e-3)
EP_TOL = dict(atol=1e-5, rtol=1e-4)
METRIC_ATOL = {"tp_sp": 1e-4, "ep": 1e-5}
ROUTING = dict(d=8, experts=4, hidden=16, tokens=12, top_k=2)
GROUP_SIZES = (4, 24, 8, 7)
CLI_ARGV = {
    "ep_sp": ["-n", "8", "-ep", "2", "-sp", "2", "-b", "4", "--sample", "4",
              "--sample-prompt-len", "4"],
    "ep_tp_sp": ["-n", "8", "-ep", "2", "-tp", "2", "-sp", "2", "-b", "4",
                 "--sample", "4", "--sample-prompt-len", "4", "--serve",
                 "4", "--serve-max-new", "4", "--serve-prompt-len", "4"],
}
# decode after a 'model' axis: tp×sp, the dense GPT, sampled and served
DECODE_ARGV = ["-n", "8", "-tp", "2", "-sp", "2", "-b", "4", "--sample",
               "4", "--sample-prompt-len", "4", "--serve", "4",
               "--serve-max-new", "4", "--serve-prompt-len", "4",
               "--serve-kv-layout", "paged", "--serve-prefix-block", "4"]
CLI_COMMON = ["--model", "gpt", "--dataset", "lm_synth", "--num-experts",
              "4", "--model-arg", "hidden=32", "--model-arg", "layers=1",
              "--model-arg", "heads=2", "--model-arg", "ffn=64",
              "--model-arg", "max_len=16", "--log-every", "0"]
CLI_NAMES = {"ep_sp": "expert_sp[dp*ep*sp,ring]",
             "ep_tp_sp": "expert_tp_sp[dp*ep*tp*sp,ring]"}


def _batches(family, steps):
    """``steps`` global batches of 8 rows: next-token pairs of 32 tokens
    for the GPT, padded token rows with binary labels for BERT, 8×8
    images for the MoE classifier."""
    rng = np.random.default_rng({"gpt": 1, "bert": 2, "moe": 3}[family])
    out = []
    for _ in range(steps):
        if family == "gpt":
            tok = rng.integers(0, 64, (8, 33)).astype(np.int32)
            out.append((tok[:, :-1], tok[:, 1:]))
        elif family == "bert":
            x = rng.integers(1, 128, (8, 32)).astype(np.int32)
            for r in range(8):
                x[r, rng.integers(4, 33):] = 0
            out.append((x, (np.arange(8) % 2).astype(np.int32)))
        else:
            out.append((rng.standard_normal((16, 8, 8)).astype(np.float32),
                        rng.integers(0, 10, 16).astype(np.int32)))
    return out


def _eval_set(family):
    """12 held-out rows of ``family``'s batches."""
    (x, y), (x2, y2) = _batches(family, 6)[4:]
    return np.concatenate([x, x2[:4]]), np.concatenate([y, y2[:4]])


def _model_kw(family, kw):
    base = {"gpt": GPT, "bert": BERT, "moe": CLASSIFIER}[family]
    return {**base, **kw}


def _small_lm(batch_size, type="train"):
    """A picklable ``dataset_fn``: 32 rows of 16 tokens over 64 ids."""
    del batch_size
    return tloaders.load_lm_dataset("lm_synth", split=type, seq_len=16,
                                    vocab_size=64, n_train=32, n_test=16)


# ------------------------------------------------------------ the ranks


def _engine_case(out, name, mesh, init, ckpt_dir=None):
    from distributed_tensorflow_tpu_torch.engines import (
        CompositeEngine, ExpertParallelEngine)
    from distributed_tensorflow_tpu_torch.models import convert, create_model

    family, _, _, kw, steps, eng_kw = CASES[name]
    model = create_model({"gpt": "gpt", "bert": "bert_tiny",
                          "moe": "moe"}[family], device="cpu",
                         **_model_kw(family, kw))
    cls = ExpertParallelEngine if family == "moe" else CompositeEngine
    eng = cls(model, mesh=mesh, **eng_kw,
              optimizer=lambda p: torch.optim.SGD(p, lr=LR))
    batches = _batches(family, steps)
    state = eng.init_state(torch.Generator().manual_seed(0), batches[0][0])
    size = mesh.shape
    state.model.load_state_dict(convert.tp_shard_state_dict(
        init, eng.param_specs, size.get("model", 1),
        mesh.axis_index("model") if "model" in size else 0,
        size.get("expert", 1),
        mesh.axis_index("expert") if "expert" in size else 0))
    out[f"{name}/shapes"] = json.dumps(
        {k: list(v.shape) for k, v in state.model.state_dict().items()})
    for s, (x, y) in enumerate(batches, 1):
        state, m = eng.step(state, *eng.shard_batch(x, y))
        for key, v in m.items():
            out[f"{name}/{s}/{key}"] = np.asarray(float(v))
        out.update({f"{name}/{s}/{k}": v.numpy().copy()
                    for k, v in eng.full_state_dict(state).items()})
    if name in EVALUATED:
        tx, ty = _eval_set(family)
        ev = eng.evaluate(state, tloaders.Dataset(
            x=tx, y=ty, num_classes=_model_kw(family, kw)["num_classes"]),
            batch_size=8)
        out[f"{name}/eval"] = np.asarray([ev["accuracy"], ev["loss"],
                                          ev["count"]])
    if ckpt_dir is not None:
        _checkpoint_roundtrip(out, name, eng, state, ckpt_dir)


def _checkpoint_roundtrip(out, name, eng, state, ckpt_dir):
    """Save (whole leaves), then restore into a fresh state of the same
    engine; the restored state's gathered parameters must be the
    written ones."""
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    mgr = CheckpointManager(ckpt_dir)
    mgr.save(state)
    written = eng.full_state_dict(state)
    fresh = eng.init_state(torch.Generator().manual_seed(5))
    mgr.restore(fresh)
    got = eng.full_state_dict(fresh)
    out[f"ckpt/{name}/equal"] = np.asarray(
        all(torch.equal(got[k], v) for k, v in written.items()))
    saved = torch.load(f"{ckpt_dir}/step_{state.step}/state.pt",
                       weights_only=True)
    out[f"ckpt/{name}/shapes"] = json.dumps(
        {k[len("model/"):]: list(v.shape) for k, v in saved.items()
         if k.startswith("model/")})


def _routing_case(out, mesh, init, s):
    """``MoELayer(group_size=s)`` on this rank's 12 tokens: its output,
    router values and the gradients of sum(y·c) + aux + z, summed over
    the ranks (the experts' over 'data')."""
    from distributed_tensorflow_tpu_torch.engines.base import (
        all_reduce_grads_)
    from distributed_tensorflow_tpu_torch.models.moe import (
        MoELayer, bind_expert_mesh, shard_experts)

    r = ROUTING
    layer = MoELayer(r["d"], r["experts"], r["hidden"], 1.0, r["top_k"],
                     partition_experts=True, device="cpu")
    layer.load_state_dict(init["params"])
    shard_experts(layer, mesh, every_layer=True)
    bind_expert_mesh(layer, mesh)
    rank = mesh.axis_index("data") * 2 + mesh.axis_index("expert")
    t = r["tokens"]
    x = torch.as_tensor(init["x"][rank * t:(rank + 1) * t])
    c = torch.as_tensor(init["c"][rank * t:(rank + 1) * t])
    y = layer(x, group_size=s)
    ((y * c).sum() + layer.aux_loss + layer.z_loss).backward()
    all_reduce_grads_([layer.gate], mesh)
    all_reduce_grads_([layer.w1, layer.w2], mesh, axis="data")
    tag = f"route/{s}"
    out[f"{tag}/y"] = y.detach().numpy().copy()
    for key in ("aux_loss", "z_loss", "overflow"):
        out[f"{tag}/{key}"] = np.asarray(float(getattr(layer,
                                                       key).detach()))
    for p in ("gate", "w1", "w2"):
        out[f"{tag}/grad_{p}"] = getattr(layer, p).grad.numpy().copy()


def _ulysses_heads() -> str:
    """The error of a partitioned GPT whose local heads (2 / tp 2) do not
    split over 'seq' (2) under Ulysses, on a (1, 2, 2) mesh."""
    from distributed_tensorflow_tpu_torch.engines import CompositeEngine
    from distributed_tensorflow_tpu_torch.models import create_model

    mesh = meshlib.create_mesh(4, device="cpu", shape=(1, 2, 2),
                               axis_names=TP_SP)
    eng = CompositeEngine(create_model(
        "gpt", device="cpu", **_model_kw("gpt", dict(
            attention_impl="ulysses", partition_model=True))), mesh=mesh)
    state = eng.init_state(torch.Generator().manual_seed(0))
    x, y = _batches("gpt", 1)[0]
    try:
        eng.step(state, *eng.shard_batch(x, y))
    except ValueError as e:
        return str(e)
    return ""


def _rank(rank: int, ports, inits, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch import cli

    torch.set_num_threads(1)
    out: dict = {}
    meshlib.init_process_group("cpu", WORLD, rank,
                               f"tcp://127.0.0.1:{ports[0]}")
    try:
        for name, (_, shape, axes, *_rest) in CASES.items():
            if name in GROUP_OF_FOUR:
                continue
            mesh = meshlib.create_mesh(WORLD, device="cpu", shape=shape,
                                       axis_names=axes)
            _engine_case(out, name, mesh, inits[JAX_TWIN.get(name, name)],
                         f"{out_dir}/ckpt" if name == "gpt_moe_ep_tp_sp"
                         else None)
        for name, argv in CLI_ARGV.items():
            out[f"cli/{name}"] = json.dumps(cli.main(
                argv + CLI_COMMON + ["--device", "cpu"],
                dataset_fn=_small_lm))
        out["cli/tp_sp"] = json.dumps(cli.main(
            DECODE_ARGV + CLI_COMMON + ["--device", "cpu"],
            dataset_fn=_small_lm))
    finally:
        dist.destroy_process_group()
    if rank < 4:
        meshlib.init_process_group("cpu", 4, rank,
                                   f"tcp://127.0.0.1:{ports[1]}")
        try:
            for name in GROUP_OF_FOUR:
                _, shape, axes, *_rest = CASES[name]
                mesh = meshlib.create_mesh(4, device="cpu", shape=shape,
                                           axis_names=axes)
                _engine_case(out, name, mesh, inits[name])
            mesh = meshlib.create_mesh(4, device="cpu", shape=(2, 2),
                                       axis_names=("data", "expert"))
            for s in GROUP_SIZES:
                _routing_case(out, mesh, inits["routing"], s)
            out["ulysses_heads"] = _ulysses_heads()
        finally:
            dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


# ------------------------------------------------------------ the parent


def _jnp_tree(params):
    import flax.linen as nn
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        nn.unbox(params))


def _jax_case(name):
    """The JAX engine of case ``name`` on its mesh, its initial state, and
    that state's weights converted."""
    import jax
    import optax

    from distributed_tensorflow_tpu.engines.composite import CompositeEngine
    from distributed_tensorflow_tpu.engines.expert_parallel import (
        ExpertParallelEngine)
    from distributed_tensorflow_tpu.models import create_model
    from distributed_tensorflow_tpu.parallel import mesh as jmesh

    family, shape, axes, kw, steps, eng_kw = CASES[name]
    model = create_model({"gpt": "gpt", "bert": "bert_tiny",
                          "moe": "moe"}[family], **_model_kw(family, kw))
    cls = ExpertParallelEngine if family == "moe" else CompositeEngine
    eng = cls(model, optimizer=optax.sgd(LR), **eng_kw,
              mesh=jmesh.create_mesh(int(np.prod(shape)), shape=shape,
                                     axis_names=axes))
    state = eng.init_state(jax.random.key(0), _batches(family, 1)[0][0])
    return eng, state, _to_sd(family, state.params)


def _to_sd(family, params):
    from distributed_tensorflow_tpu_torch.models import convert

    return {"gpt": convert.gpt_state_dict, "bert": convert.bert_state_dict,
            "moe": convert.moe_state_dict}[family](_jnp_tree(params))


def _jax_steps(name, eng, state):
    """Each step's metrics and converted parameters, and the evaluation
    (None for a case not in ``EVALUATED``)."""
    from distributed_tensorflow_tpu.data import loaders as jloaders

    family, _, _, kw, steps, _ = CASES[name]
    per_step = []
    for x, y in _batches(family, steps):
        state, m = eng.step(state, *eng.shard_batch(x, y))
        per_step.append(({k: float(v) for k, v in m.items()},
                         {k: v.numpy() for k, v in
                          _to_sd(family, state.params).items()}))
    ev = None
    if name in EVALUATED:
        tx, ty = _eval_set(family)
        ev = eng.evaluate(state, jloaders.Dataset(
            x=tx, y=ty, num_classes=_model_kw(family, kw)["num_classes"]),
            batch_size=8)
    return per_step, ev


def _jax_routing():
    """JAX's ``MoELayer`` weights and the 48 global tokens and cotangents,
    and a function giving, per group size, the output, router values and
    the gradients of sum(y·c) + aux + z over those tokens."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.moe import MoELayer
    from distributed_tensorflow_tpu_torch.models import convert

    r = ROUTING
    rng = np.random.default_rng(9)
    n = 4 * r["tokens"]
    x = rng.standard_normal((n, r["d"])).astype(np.float32)
    c = rng.standard_normal((n, r["d"])).astype(np.float32)

    def layer(s):
        return MoELayer(num_experts=r["experts"], hidden=r["hidden"],
                        capacity_factor=1.0, router_top_k=r["top_k"],
                        group_size=s)

    params = jax.jit(layer(None).init)(jax.random.key(4),
                                       jnp.asarray(x))["params"]

    def want(s):
        def f(p):
            y, col = layer(s).apply({"params": p}, jnp.asarray(x),
                                    mutable=["intermediates"])
            inter = col["intermediates"]
            aux, z = inter["aux_loss"][0], inter["z_loss"][0]
            return (y * c).sum() + aux + z, (y, aux, z,
                                              inter["overflow"][0])

        (_, (y, aux, z, overflow)), g = jax.jit(jax.value_and_grad(
            f, has_aux=True))(params)
        return {"y": np.asarray(y), "aux_loss": float(aux),
                "z_loss": float(z), "overflow": float(overflow),
                **{f"grad_{k}": np.asarray(v) for k, v in g.items()}}

    sd = convert.moe_state_dict({"MoELayer_0": jax.tree.map(np.asarray,
                                                            params)})
    init = {"params": {k.rsplit(".", 1)[1]: v for k, v in sd.items()},
            "x": x, "c": c}
    return init, want


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    """The ranks start from the JAX engines' initial weights and run
    while the parent steps the JAX engines."""
    engines = {name: _jax_case(name) for name in CASES
               if name not in JAX_TWIN}
    route_init, route_want = _jax_routing()
    inits = {name: run[2] for name, run in engines.items()}
    inits["routing"] = route_init
    out = tmp_path_factory.mktemp("composite")
    ranks = mp.spawn(_rank, args=((meshlib.free_port(),
                                   meshlib.free_port()), inits, str(out)),
                     nprocs=WORLD, join=False)
    jax_cases = {name: (inits[name], *_jax_steps(name, eng, state))
                 for name, (eng, state, _) in engines.items()}
    want = {s: route_want(s) for s in GROUP_SIZES}
    while not ranks.join():
        pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return jax_cases, want, got


def _tol(name):
    return (EP_TOL, METRIC_ATOL["ep"]) if "moe" in name else (
        TP_SP_TOL, METRIC_ATOL["tp_sp"])


@pytest.mark.parametrize("name", list(CASES))
def test_engine_equals_jax_every_step(spawn_run, name):
    jax_cases, _, ranks = spawn_run
    _, per_step, _ = jax_cases[JAX_TWIN.get(name, name)]
    tol, metric_atol = _tol(name)
    n = 4 if name in GROUP_OF_FOUR else WORLD
    for r, got in enumerate(ranks[:n]):
        for s, (metrics, params) in enumerate(per_step[:CASES[name][4]], 1):
            for key, w in metrics.items():
                np.testing.assert_allclose(got[f"{name}/{s}/{key}"], w,
                                           rtol=0, atol=metric_atol,
                                           err_msg=f"rank {r} {s} {key}")
            for key, w in params.items():
                np.testing.assert_allclose(got[f"{name}/{s}/{key}"], w,
                                           **tol,
                                           err_msg=f"rank {r} {s} {key}")
    if "moe" in name:
        first = per_step[0][0]
        # the router terms count, and tokens overflowed capacity
        assert first["total_loss"] - first["loss"] > 1e-4
        assert max(m["overflow"] for m, _ in per_step) > 0


def test_ranks_hold_their_slices(spawn_run):
    """The 2-D expert layout and the Megatron cut on each rank."""
    _, _, ranks = spawn_run
    ep_tp = json.loads(str(ranks[0]["moe_ep_tp/shapes"]))
    assert ep_tp["moe.0.w1"] == [2, 16, 16] and ep_tp["moe.0.w2"] == [2, 16,
                                                                      16]
    four_d = json.loads(str(ranks[0]["gpt_moe_ep_tp_sp/shapes"]))
    assert four_d["blocks.0.moe.w1"] == [2, 32, 32]
    assert four_d["blocks.0.attn.query.weight"] == [16, 32]
    ep_sp = json.loads(str(ranks[0]["gpt_moe_ep_sp/shapes"]))
    assert ep_sp["blocks.0.moe.w1"] == [2, 32, 64]


@pytest.mark.parametrize("s", GROUP_SIZES)
def test_grouped_routing_equals_jax(spawn_run, s):
    _, want, ranks = spawn_run
    t = ROUTING["tokens"]
    for r, got in enumerate(ranks[:4]):
        w = want[s]
        np.testing.assert_allclose(got[f"route/{s}/y"],
                                   w["y"][r * t:(r + 1) * t], rtol=0,
                                   atol=1e-5)
        for key in ("aux_loss", "z_loss", "overflow"):
            np.testing.assert_allclose(got[f"route/{s}/{key}"], w[key],
                                       rtol=0, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got[f"route/{s}/grad_gate"],
                                   w["grad_gate"], rtol=0, atol=1e-5)
        e = r % 2      # (data, expert): the expert index
        for p in ("w1", "w2"):
            np.testing.assert_allclose(got[f"route/{s}/grad_{p}"],
                                       w[f"grad_{p}"][2 * e:2 * e + 2],
                                       rtol=0, atol=1e-5, err_msg=p)
    # top-2 at capacity factor 1.0 drops tokens in every placement
    assert want[s]["overflow"] > 0


def test_checkpoint_under_a_composite_is_whole(spawn_run):
    _, _, ranks = spawn_run
    got = ranks[0]
    assert bool(got["ckpt/gpt_moe_ep_tp_sp/equal"])
    shapes = json.loads(str(got["ckpt/gpt_moe_ep_tp_sp/shapes"]))
    assert shapes["blocks.0.moe.w1"] == [4, 32, 64]
    assert shapes["blocks.0.attn.query.weight"] == [32, 32]
    assert shapes["token_embed.weight"] == [64, 32]


@pytest.mark.parametrize("name", list(CLI_ARGV))
def test_cli_runs_the_composite(spawn_run, name):
    _, _, ranks = spawn_run
    summary = json.loads(str(ranks[0][f"cli/{name}"]))
    assert summary["engine"] == CLI_NAMES[name]
    assert summary["n_devices"] == 8 and summary["expert_parallel"] == 2
    assert summary["seq_parallel"] == 2 and summary["num_experts"] == 4
    assert summary["steps"] > 0
    assert np.isfinite(summary["test_perplexity"])
    # a window of 50 steps: fewer steps leave the monitor's mean unset
    mean = summary["expert_overflow_window_mean"]
    assert mean is None or 0.0 <= mean <= 1.0
    # every rank reports the same all-reduced evaluation
    assert len({json.loads(str(g[f"cli/{name}"]))["test_loss"]
                for g in ranks}) == 1


@pytest.mark.parametrize("name", EVALUATED)
def test_evaluate_equals_jax(spawn_run, name):
    jax_cases, _, ranks = spawn_run
    want = jax_cases[name][2]
    for got in ranks:
        acc, loss, count = got[f"{name}/eval"]
        assert count == want["count"]
        np.testing.assert_allclose([acc, loss],
                                   [want["accuracy"], want["loss"]],
                                   rtol=0, atol=1e-5)


def test_sampling_after_ep_sp_decodes_every_prompt(spawn_run):
    """``--sample`` after a run without a 'model' axis decodes one prompt
    per data shard from the gathered experts (``eval_params``)."""
    _, _, ranks = spawn_run
    summary = json.loads(str(ranks[0]["cli/ep_sp"]))
    samples = np.asarray(summary["samples"])
    assert samples.shape == (2, 4)
    assert ((samples >= 0) & (samples < 64)).all()
    assert np.asarray(summary["sample_prompts"]).shape == (2, 4)


def test_ulysses_needs_local_heads_divisible_by_seq(spawn_run):
    """JAX's message (``parallel/ring_attention.py:144``) on the local
    heads: 2 heads over 'model' 2 leave 1, which 'seq' 2 cannot split."""
    _, _, ranks = spawn_run
    assert str(ranks[0]["ulysses_heads"]) == (
        "num_heads 1 not divisible by axis size 2")


# ------------------------------------------------------------ no ranks


def _fake_mesh(shape, axes, world=None):
    """A mesh value of ``shape`` for the constructors' checks, which read
    its axes and this rank's coordinates only (no process group)."""
    return meshlib.Mesh(rank=0, world_size=world or int(np.prod(shape)),
                        device=torch.device("cpu"), backend="gloo",
                        axis_names=axes, dims=shape)


def _messages(jax_fn, port_fn, exc=ValueError):
    with pytest.raises(exc) as want:
        jax_fn()
    with pytest.raises(exc) as got:
        port_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


def _jax_bert(attention_impl, **kw):
    from distributed_tensorflow_tpu.models import create_model

    return create_model("bert_tiny", **_model_kw("bert", dict(
        attention_impl=attention_impl, partition_model=True, **kw)))


def _port_bert(attention_impl, **kw):
    from distributed_tensorflow_tpu_torch.models import create_model

    return create_model("bert_tiny", device="cpu", **_model_kw("bert", dict(
        attention_impl=attention_impl, partition_model=True, **kw)))


def test_composite_validation_messages_equal_jax():
    """JAX ``test_composite_validation``: no data axis, dense attention
    with 'seq' > 1, a sequence length that does not split."""
    from distributed_tensorflow_tpu.engines.composite import (
        CompositeEngine as JaxComposite)
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu_torch.engines import CompositeEngine

    _messages(lambda: JaxComposite(_jax_bert("ring"), mesh=jmesh.create_mesh(
        8, axis_names=("model",))), lambda: CompositeEngine(
        _port_bert("ring"), mesh=_fake_mesh((8,), ("model",))))

    def j3():
        return jmesh.create_mesh(8, shape=(2, 2, 2), axis_names=TP_SP)

    _messages(lambda: JaxComposite(_jax_bert("dense"), mesh=j3()),
              lambda: CompositeEngine(_port_bert("dense"),
                                      mesh=_fake_mesh((2, 2, 2), TP_SP)))
    x, y = _batches("bert", 1)[0]
    jeng = JaxComposite(_jax_bert("ring"), mesh=j3())
    peng = CompositeEngine(_port_bert("ring"),
                           mesh=_fake_mesh((2, 2, 2), TP_SP))
    _messages(lambda: jeng.shard_batch(x[:, :31], y),
              lambda: peng.shard_batch(x[:, :31], y))
    with pytest.raises(ValueError, match="unsupported mesh axes"):
        CompositeEngine(_port_bert("ring"),
                        mesh=_fake_mesh((1, 1), ("data", "pipe")))


@pytest.mark.parametrize("case", ["no_moe", "no_partition", "indivisible"])
def test_ep_sp_validation_messages_equal_jax(case):
    """JAX ``test_ep_sp_validation``: an 'expert' axis over a model with no
    MoE blocks, without ``partition_experts``, or with an expert count it
    does not split."""
    from distributed_tensorflow_tpu.engines.composite import (
        CompositeEngine as JaxComposite)
    from distributed_tensorflow_tpu.models import create_model as jcreate
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu_torch.engines import CompositeEngine
    from distributed_tensorflow_tpu_torch.models import create_model

    kw = {"no_moe": dict(attention_impl="ring"),
          "no_partition": dict(attention_impl="ring", moe_experts=4),
          "indivisible": dict(attention_impl="ring", **MOE_KW)}[case]
    shape = (1, 8, 1) if case == "indivisible" else (2, 2, 2)
    msg = _messages(
        lambda: JaxComposite(jcreate("gpt", **_model_kw("gpt", kw)),
                             mesh=jmesh.create_mesh(8, shape=shape,
                                                    axis_names=EP_SP)),
        lambda: CompositeEngine(
            create_model("gpt", device="cpu", **_model_kw("gpt", kw)),
            mesh=_fake_mesh(shape, EP_SP)))
    assert {"no_moe": "moe_experts", "no_partition": "partition_experts",
            "indivisible": "not divisible"}[case] in msg


def test_moe_partition_model_requires_experts():
    """JAX's ``MoELayer`` refuses ``partition_model`` without
    ``partition_experts`` at init, the port's at construction."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.moe import MoELayer as JaxMoE
    from distributed_tensorflow_tpu_torch.models.moe import MoELayer

    _messages(lambda: JaxMoE(num_experts=4, hidden=16, partition_model=True,
                             partition_experts=False).init(
        jax.random.key(0), jnp.zeros((8, 8))),
        lambda: MoELayer(8, 4, 16, partition_model=True,
                         partition_experts=False, device="cpu"))


PIPELINE_COMBOS = [
    {"pipeline_parallel": 2, "tensor_parallel": 2},
    {"pipeline_parallel": 2, "seq_parallel": 2},
    {"pipeline_parallel": 2, "expert_parallel": 2},
    {"pipeline_parallel": 2, "tensor_parallel": 2, "seq_parallel": 2},
    {"pipeline_parallel": 2, "expert_parallel": 2, "tensor_parallel": 2},
    {"pipeline_parallel": 2, "expert_parallel": 2, "seq_parallel": 2},
    {"pipeline_parallel": 2, "expert_parallel": 2, "tensor_parallel": 2,
     "seq_parallel": 2},
]


@pytest.mark.parametrize("factors", PIPELINE_COMBOS,
                         ids=lambda f: "x".join(sorted(f)))
def test_pipeline_combos_cite_pipeline_composites(factors):
    """Every pipeline composite is ported: the dense ones (pp×tp, pp×sp,
    pp×tp×sp; tests/test_torch_pipeline_composite.py) and the MoE ones
    (pp×ep with or without tp and sp; tests/test_torch_pipeline_ep.py)
    reach their mesh: on 2 devices, JAX's message that 2 do not hold
    it."""
    from distributed_tensorflow_tpu.utils import harness as jharness
    from distributed_tensorflow_tpu_torch.utils import harness

    kw = dict(model="gpt", dataset="lm_synth", **factors)
    msg = _messages(
        lambda: jharness._setup(jharness.ExperimentConfig(**kw,
                                                          n_devices=2)),
        lambda: harness._setup(harness.ExperimentConfig(**kw, n_devices=2,
                                                        device="cpu")))
    assert "n_devices 2 not divisible by pipeline_parallel×" in msg


@pytest.mark.parametrize("kw", [
    dict(model="moe", dataset="synthetic", expert_parallel=2,
         seq_parallel=2),
    dict(model="gpt", dataset="lm_synth", expert_parallel=2, seq_parallel=2,
         num_experts=3),
    dict(model="gpt", dataset="lm_synth", expert_parallel=2, seq_parallel=2,
         attention_impl="flash"),
    dict(model="bert_tiny", dataset="glue_synth", tensor_parallel=2,
         seq_parallel=2, router_z_weight=1e-3),
], ids=["non_sequence_model", "experts_indivisible", "flash", "z_weight"])
def test_harness_rejections_equal_jax(kw):
    """JAX's ``_setup_expert_sp`` rejections and the ``--router-z-weight``
    rule (a tp×sp composite applies it only to a MoE model), raised before
    any mesh is made."""
    from distributed_tensorflow_tpu.utils import harness as jharness
    from distributed_tensorflow_tpu_torch.utils import harness

    _messages(lambda: jharness._setup(jharness.ExperimentConfig(**kw)),
              lambda: harness._setup(harness.ExperimentConfig(
                  **kw, device="cpu")))


@pytest.mark.parametrize("flags", [
    dict(tensor_parallel=2, seq_parallel=2),
    dict(expert_parallel=2, tensor_parallel=2, seq_parallel=2)])
def test_decode_after_a_model_axis_is_not_ported(spawn_run, flags):
    """Decode after a run with a 'model' axis (TP decode; refused before
    it was ported, whence the name): ``--sample`` after tp×sp and
    ep×tp×sp decodes one prompt per data shard over the run's mesh, and
    ``--serve`` serves the whole model replicated (the mesh holds 'seq'),
    every request completed; every rank reports the same samples."""
    _, _, ranks = spawn_run
    name = "ep_tp_sp" if "expert_parallel" in flags else "tp_sp"
    summaries = [json.loads(str(g[f"cli/{name}"])) for g in ranks]
    dp = 8 // (2 * flags.get("expert_parallel", 1) * 2)
    samples = np.asarray(summaries[0]["samples"])
    assert samples.shape == (dp, 4)
    assert ((samples >= 0) & (samples < 64)).all()
    assert all(s["samples"] == summaries[0]["samples"] for s in summaries)
    serve = summaries[0]["serve"]
    assert serve["completed"] == serve["requests"] == 4
    assert serve["tokens_generated"] == 16
