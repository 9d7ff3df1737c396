"""TP decode: a GPT bound to a (data, model) mesh decodes (cursor decode,
``generate(mesh=...)``, the monolithic and paged ``SlotKVCache(mesh=...)``,
``--sample``/``--serve`` after -tp, fsdp×tp, tp×sp and ep×tp through
``cli.main``), on gloo ranks (CPU), against the JAX package and the
port's own unpartitioned model.

One spawn of 4 ranks, a (data 2, model 2) mesh, run once by a module
fixture.  The rank bodies live at module level in this file, which
imports no JAX at the top (a spawned child re-imports the module of its
target); the JAX references and the unpartitioned model's are computed in
the parent while the ranks run.  Every model starts from a JAX GPT's
initial weights, every Dense kernel and embedding scaled by 3 so that the
greedy streams vary, converted in the parent (``convert.gpt_state_dict``).
Each rank's model is the whole model cut by ``generate``'s placement
(``models.gpt.decode_model``).  Equalities and tolerances, each with its
reason:

* ``generate(mesh=...)`` greedy, B = 4 prompts of 5 tokens, 10 new ones,
  for MHA (4 heads), GQA (``kv_heads=2``), rope with GQA, and 3 heads
  (which do not split over 'model' 2: the attention stays whole on each
  rank): the tokens equal JAX's single-device ``generate`` and the
  unbound port model's, on every rank.
* Cursor decode of the bound model (each rank's cache holds its K/V
  heads): the logits of the prompt's prefill and of one more step within
  ``atol=2e-5, rtol=1e-5`` of the unbound model's (the row-parallel
  all-reduce sums the two ranks' f32 partial products, which the whole
  GEMM sums in another order).
* ``SlotKVCache(mesh=...)`` on the GQA model, 2 slots (each rank holds 1
  of the 2 K/V heads), monolithic and paged: f32 with the prefix pool
  (byte copies, or the zero-copy pool) and ``multi_step`` 3, bf16 and
  int8 storage with the pool, and a ``self`` draft (draft_k 3): the
  batcher's streams on every rank equal the unbound table's, bitwise;
  those of the f32 runs and the paged int8 one (``JAX_TABLES``; JAX's
  tables compile for seconds each, in the parent) equal JAX's batcher
  over JAX's ``SlotKVCache(mesh=...)`` of the same weights on a (2, 2)
  (data, model) mesh of CPU devices, the model cloned with
  ``partition_model`` (JAX's TP table: its kv heads split over 'model'),
  bitwise.
* Temperature sampling on a TP table: every rank draws the same tokens
  (the table's generator is seeded alike on every rank).
* The batcher over a TP table refuses wall-clock arrivals after 0 (each
  rank's batcher could admit them apart) and serves them on a
  ``VirtualClock``, alike on every rank.
* JAX's refusals, with JAX's messages: a batch that does not divide by
  'data' (``generate``) and slots that do not (the tables).
* ``cli.main`` with ``-tp 2 -n 4`` (a TP table), ``-m d -ds fsdp -tp 2
  -n 4`` (a TP table), ``-tp 2 -sp 2 -n 4`` and ``-ep 2 -tp 2 -n 4`` over
  a MoE GPT ``model_fn`` (the whole model, replicated), each with
  ``--sample`` and a paged ``--serve``: the samples and the serve streams
  equal the engine's gathered whole model decoding the same prompts with
  ``generate`` and an unbound table, and the serve streams equal those of
  a TP table over the engine's own bound model on the run's mesh,
  bitwise, on every rank.
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

WORLD, SHAPE, AXES = 4, (2, 2), ("data", "model")
BASE = dict(vocab_size=64, hidden=32, layers=2, heads=4, ffn=64,
            max_len=32, dropout_rate=0.0)
VARIANTS = {"mha": {}, "gqa": {"kv_heads": 2},
            "rope": {"positional": "rope", "kv_heads": 2},
            "heads3": {"hidden": 24, "heads": 3}}
NEW = 10
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)
SLOTS, BLOCK = 2, 4
# table runs on the GQA model: (layout, kv_dtype, prefix pool, draft,
# multi_step)
TABLES = {f"{layout}/{name}": (layout, *spec)
          for layout in ("monolithic", "paged")
          for name, spec in {"f32": (None, 8, False, 3),
                             "bf16": ("bfloat16", 8, False, None),
                             "int8": ("int8", 8, False, None),
                             "spec": (None, 0, True, None)}.items()}
# the table runs held against JAX's batcher over JAX's TP table
JAX_TABLES = ("monolithic/f32", "paged/f32", "paged/int8")
CLI_MODEL = ["--model", "gpt", "--dataset", "lm_synth", "--model-arg",
             "hidden=32", "--model-arg", "layers=1", "--model-arg",
             "heads=2", "--model-arg", "ffn=64", "--model-arg", "max_len=32"]
CLI_DECODE = ["-b", "4", "--log-every", "0", "--device", "cpu", "--sample",
              "4", "--sample-prompt-len", "4", "--serve", "4",
              "--serve-slots", "2", "--serve-max-new", "4",
              "--serve-prompt-len", "4", "--serve-kv-layout", "paged",
              "--serve-prefix-cache", "8", "--serve-prefix-block", "4",
              "--serve-shared-prefix", "4"]
CLI_RUNS = {"tp": ["-tp", "2", "-n", "4"] + CLI_MODEL,
            "fsdp_tp": ["-m", "d", "-ds", "fsdp", "-tp", "2", "-n", "4"]
            + CLI_MODEL,
            "tp_sp": ["-tp", "2", "-sp", "2", "-n", "4"] + CLI_MODEL,
            "ep_tp": ["-ep", "2", "-tp", "2", "-n", "4", "--num-experts",
                      "4", "--dataset", "lm_synth"]}
# whether the run's serve table takes the mesh (JAX harness.py:2462-2470)
CLI_TP_TABLE = {"tp": True, "fsdp_tp": True, "tp_sp": False,
                "ep_tp": False}


def _prompts(b=4, lp=5, seed=7):
    return np.random.default_rng(seed).integers(0, 64, (b, lp)).astype(
        np.int32)


def _requests():
    """Six requests behind a shared 8-token prefix (two pool blocks), 6
    new tokens each, every arrival at 0."""
    from distributed_tensorflow_tpu_torch.serving import Request

    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, 8).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate(
        [shared, rng.integers(0, 64, 3 + i % 4).astype(np.int32)]),
        max_new_tokens=6) for i in range(6)]


def _small_lm(batch_size, type="train"):
    """A picklable ``dataset_fn``: 32 rows of 16 tokens over 64 ids."""
    del batch_size
    return tloaders.load_lm_dataset("lm_synth", split=type, seq_len=16,
                                    vocab_size=64, n_train=32, n_test=16)


def _moe_gpt():
    """The ep×tp run's ``model_fn``: a partitioned GPT with MoE blocks
    (the 2-D expert layout)."""
    from distributed_tensorflow_tpu_torch.models import create_model

    return create_model("gpt", num_classes=64, hidden=32, layers=1, heads=2,
                        ffn=64, max_len=32, dropout_rate=0.0, moe_experts=4,
                        partition_model=True, partition_experts=True,
                        device="cpu")


def _gpt(partition_model, **kw):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(device="cpu", partition_model=partition_model,
                 **{**BASE, **kw})


def _table(model, sd, name, mesh=None, **kw):
    """The table and batcher of run ``name`` (``TABLES``): returns the
    streams by request id."""
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, SlotKVCache)

    layout, kv_dtype, pool, draft, multi = TABLES[name]
    table_kw = dict(kv_layout=layout, kv_dtype=kv_dtype, device="cpu",
                    mesh=mesh, prefix_cache_blocks=pool, prefix_block=BLOCK)
    kv = SlotKVCache(model, sd, SLOTS, **table_kw, **kw)
    draft_kv = (SlotKVCache(kv.model, None, SLOTS, device="cpu", mesh=mesh)
                if draft else None)
    summary = ContinuousBatcher(kv, draft_kv=draft_kv, draft_k=3,
                                multi_step=multi).run(_requests())
    return kv, {r.rid: list(r.tokens) for r in summary["results"]}


# ------------------------------------------------------------ the ranks


def _decode_cases(out, mesh, sds):
    from distributed_tensorflow_tpu_torch.models.gpt import (
        decode_model, generate)

    for name, kw in VARIANTS.items():
        out[f"gen/{name}"] = generate(
            _gpt(True, **kw), sds[name], _prompts(), NEW, greedy=True,
            device="cpu", mesh=mesh).numpy()
        model = decode_model(_gpt(True, **kw), sds[name], mesh)
        cache = model.init_cache(4)
        ids = torch.as_tensor(_prompts()).long()
        with torch.no_grad():
            pre, cache = model(ids, cache=cache)
            step, _ = model(ids[:, -1:], cache=cache)
        out[f"cursor/{name}"] = torch.cat([pre, step], dim=1).numpy()
        out[f"cache_heads/{name}"] = np.asarray(
            [layer["cached_key"].shape[2] for layer in cache])
        out[f"bound/{name}"] = np.asarray(model.tp_mesh is not None)


def _table_cases(out, mesh, sd):
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, SlotKVCache)

    for name in TABLES:
        kv, streams = _table(_gpt(True, kv_heads=2), sd, name, mesh)
        out[f"table/{name}"] = json.dumps(streams)
        leaf = next(iter(kv.cache[0].values()))
        out[f"table_heads/{name}"] = np.asarray(
            [leaf.shape[2], leaf.is_contiguous(), kv.eager_rounds])
    kv = SlotKVCache(_gpt(True, kv_heads=2), sd, SLOTS, device="cpu",
                     mesh=mesh, greedy=False, temperature=1.0)
    summary = ContinuousBatcher(kv).run(_requests())
    out["temperature"] = json.dumps(
        {r.rid: list(r.tokens) for r in summary["results"]})
    _lockstep_cases(out, kv)


def _lockstep_cases(out, kv):
    """Arrivals after 0 over a TP table: refused on the wall clock,
    served on a ``VirtualClock`` (one arrival a tick)."""
    import dataclasses

    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, VirtualClock)

    late = [dataclasses.replace(r, arrival_s=float(r.rid))
            for r in _requests()]
    try:
        ContinuousBatcher(kv).run(late)
        out["refusal/wall_clock"] = ""
    except ValueError as e:
        out["refusal/wall_clock"] = str(e)
    summary = ContinuousBatcher(kv, clock=VirtualClock()).run(late)
    out["virtual_clock"] = json.dumps(
        {r.rid: list(r.tokens) for r in summary["results"]})


def _refusals(out, mesh, sd):
    from distributed_tensorflow_tpu_torch.models.gpt import generate
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    for key, call in (
            ("batch", lambda: generate(_gpt(True), sd, _prompts(b=3), 4,
                                       greedy=True, device="cpu",
                                       mesh=mesh)),
            ("slots", lambda: SlotKVCache(_gpt(True), sd, 3, device="cpu",
                                          mesh=mesh))):
        try:
            call()
            out[f"refusal/{key}"] = ""
        except ValueError as e:
            out[f"refusal/{key}"] = str(e)


def _recorded_cli(argv, **kw):
    """``cli.main(argv)`` keeping its trainer and its serve window's
    summary (with the per-request results)."""
    from distributed_tensorflow_tpu_torch import cli, serving
    from distributed_tensorflow_tpu_torch.utils import harness

    kept = {}

    class Served(serving.ContinuousBatcher):
        def run(self, *args, **run_kw):
            kept["serve"] = summary = super().run(*args, **run_kw)
            kept["kv"] = self.kv
            return summary

    class Recorder(harness.Trainer):
        def __init__(self, *args, **init_kw):
            super().__init__(*args, **init_kw)
            kept["trainer"] = self

    trainer, batcher = harness.Trainer, serving.ContinuousBatcher
    harness.Trainer, serving.ContinuousBatcher = Recorder, Served
    try:
        summary = cli.main(argv, dataset_fn=_small_lm, **kw)
    finally:
        harness.Trainer, serving.ContinuousBatcher = trainer, batcher
    return summary, kept


def _cli_case(out, name):
    """One ``cli.main`` run with ``--sample``/``--serve``, then the
    engine's gathered whole model decoding the same prompts: ``generate``
    and an unbound paged table with the run's pool."""
    from distributed_tensorflow_tpu_torch.models.gpt import generate
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, Request, SlotKVCache)

    summary, kept = _recorded_cli(
        CLI_RUNS[name] + CLI_DECODE,
        **({"model_fn": _moe_gpt} if name == "ep_tp" else {}))
    engine, state = kept["trainer"].engine, kept["trainer"].state
    whole = engine.model.unbound()
    whole.load_state_dict(engine.full_state_dict(state))
    prompts = np.asarray(summary["sample_prompts"], np.int32)
    samples = generate(whole, None, prompts, 4, greedy=True, device="cpu")
    served = kept["serve"]["results"]
    # the harness's requests: test rows behind a seeded 4-token prefix
    rows = _small_lm(4, "test").x
    shared = np.random.default_rng(0).integers(0, 64, 4).astype(np.int32)
    requests = [Request(rid=i, prompt=np.concatenate([shared, rows[i, :4]]),
                        max_new_tokens=4) for i in range(4)]
    table = dict(device="cpu", kv_layout="paged", prefix_cache_blocks=8,
                 prefix_block=4)
    base = ContinuousBatcher(SlotKVCache(whole, None, 2, **table)).run(
        requests)
    # the engine's own model, its Megatron cut kept, on the run's mesh
    tp = ContinuousBatcher(SlotKVCache(
        engine.eval_params(state), None, 2, mesh=engine.mesh,
        **table)).run(requests)
    out[f"cli/{name}"] = json.dumps({
        "engine": summary["engine"],
        "samples": summary["samples"], "whole_samples": samples.tolist(),
        "streams": {r.rid: list(r.tokens) for r in served},
        "whole_streams": {r.rid: list(r.tokens) for r in base["results"]},
        "tp_streams": {r.rid: list(r.tokens) for r in tp["results"]},
        "tp_table": kept["kv"].mesh is not None,
        "bound": kept["kv"].model.tp_mesh is not None,
        "completed": summary["serve"]["completed"]})


def _rank(rank: int, port: int, sds, out_dir: str) -> None:
    torch.set_num_threads(1)
    out: dict = {}
    meshlib.init_process_group("cpu", WORLD, rank,
                               f"tcp://127.0.0.1:{port}")
    try:
        mesh = meshlib.create_mesh(WORLD, device="cpu", shape=SHAPE,
                                   axis_names=AXES)
        _decode_cases(out, mesh, sds)
        _table_cases(out, mesh, sds["gqa"])
        _refusals(out, mesh, sds["mha"])
        for name in CLI_RUNS:
            _cli_case(out, name)
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


# ------------------------------------------------------------ the parent


def _jax_model(**kw):
    """A JAX GPT, its parameters (every Dense kernel and embedding × 3)
    and their conversion to the port's ``state_dict``."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
    from distributed_tensorflow_tpu_torch.models.convert import (
        gpt_state_dict)

    jm = JaxGPT(**{**BASE, **kw})
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 8), jnp.int32),
                                       train=False))(
        jax.random.key(0))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 3.0
        if path[-1].key in ("kernel", "embedding") else x, params)
    sd = {k: v.clone() for k, v in gpt_state_dict(
        jax.tree.map(np.asarray, params)).items()}
    return jm, params, sd


def _jax_refusals(jm, params):
    """JAX's messages for a batch and for slots that 'data' 2 does not
    divide, on a (2, 2) (data, model) mesh."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.gpt import generate as jgenerate
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu.serving import SlotKVCache as JaxKV

    mesh = jmesh.create_mesh(4, shape=SHAPE, axis_names=AXES)
    out = {}
    for key, call in (
            ("batch", lambda: jgenerate(jm, params,
                                        jnp.asarray(_prompts(b=3)), 4,
                                        greedy=True, mesh=mesh)),
            ("slots", lambda: JaxKV(jm, params, 3, mesh=mesh))):
        with pytest.raises(ValueError) as err:
            call()
        out[key] = str(err.value)
    return out


def _jax_tables(jm, params):
    """JAX's batcher over JAX's TP tables (``SlotKVCache(mesh=...)`` of
    ``jm`` cloned with ``partition_model``, on a (2, 2) (data, model) mesh
    of CPU devices) for the runs of ``JAX_TABLES``: their streams."""
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu.serving import (
        ContinuousBatcher, Request, SlotKVCache)

    mesh = jmesh.create_mesh(4, shape=SHAPE, axis_names=AXES)
    jm = jm.clone(partition_model=True)
    out = {}
    for name in JAX_TABLES:
        layout, kv_dtype, pool, draft, multi = TABLES[name]
        assert not draft
        kv = SlotKVCache(jm, params, SLOTS, mesh=mesh, kv_layout=layout,
                         kv_dtype=kv_dtype, prefix_cache_blocks=pool,
                         prefix_block=BLOCK)
        summary = ContinuousBatcher(kv, multi_step=multi).run(
            [Request(rid=r.rid, prompt=r.prompt,
                     max_new_tokens=r.max_new_tokens) for r in _requests()])
        out[name] = {r.rid: [int(t) for t in r.tokens]
                     for r in summary["results"]}
    return out


def _unbound_refs(sds):
    """The unbound port model's generate, cursor logits and table
    streams."""
    from distributed_tensorflow_tpu_torch.models.gpt import generate

    refs = {}
    for name, kw in VARIANTS.items():
        model = _gpt(False, **kw)
        model.load_state_dict(sds[name])
        refs[f"gen/{name}"] = generate(model, None, _prompts(), NEW,
                                       greedy=True, device="cpu").numpy()
        ids = torch.as_tensor(_prompts()).long()
        with torch.no_grad():
            pre, cache = model(ids, cache=model.init_cache(4))
            step, _ = model(ids[:, -1:], cache=cache)
        refs[f"cursor/{name}"] = torch.cat([pre, step], dim=1).numpy()
    for name in TABLES:
        refs[f"table/{name}"] = _table(_gpt(False, kv_heads=2), sds["gqa"],
                                       name)[1]
    return refs


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    """The ranks decode from the converted JAX weights while the parent
    computes JAX's and the unbound model's references."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.gpt import generate as jgenerate

    pairs = {name: _jax_model(**kw) for name, kw in VARIANTS.items()}
    sds = {name: sd for name, (_, _, sd) in pairs.items()}
    out = tmp_path_factory.mktemp("tp_decode")
    ranks = mp.spawn(_rank, args=(meshlib.free_port(), sds, str(out)),
                     nprocs=WORLD, join=False)
    jax_gen = {name: np.asarray(jgenerate(jm, params,
                                          jnp.asarray(_prompts()), NEW,
                                          greedy=True))
               for name, (jm, params, _) in pairs.items()}
    refusals = _jax_refusals(*pairs["mha"][:2])
    refs = _unbound_refs(sds)
    refs["jax_tables"] = _jax_tables(*pairs["gqa"][:2])
    while not ranks.join():
        pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return jax_gen, refusals, refs, got


@pytest.mark.parametrize("name", list(VARIANTS))
def test_generate_mesh_equals_jax_and_unbound(spawn_run, name):
    jax_gen, _, refs, ranks = spawn_run
    assert len(np.unique(jax_gen[name])) > 6
    np.testing.assert_array_equal(refs[f"gen/{name}"], jax_gen[name])
    for got in ranks:
        np.testing.assert_array_equal(got[f"gen/{name}"], jax_gen[name])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_cursor_logits_within_tolerance_of_unbound(spawn_run, name):
    _, _, refs, ranks = spawn_run
    whole_kvh = {**BASE, **VARIANTS[name]}.get(
        "kv_heads", {**BASE, **VARIANTS[name]}["heads"])
    # the 3-head attention does not split over 'model' 2: whole on each
    # rank, its cache too
    want_kvh = whole_kvh if name == "heads3" else whole_kvh // 2
    for got in ranks:
        assert bool(got[f"bound/{name}"])
        assert got[f"cache_heads/{name}"].tolist() == [want_kvh] * 2
        np.testing.assert_allclose(got[f"cursor/{name}"],
                                   refs[f"cursor/{name}"], **LOGIT_TOL)


@pytest.mark.parametrize("name", list(TABLES))
def test_tp_table_streams_equal_unbound(spawn_run, name):
    _, _, refs, ranks = spawn_run
    want = {str(k): v for k, v in refs[f"table/{name}"].items()}
    assert len(want) == 6 and all(len(v) == 6 for v in want.values())
    for got in ranks:
        assert json.loads(str(got[f"table/{name}"])) == want
        heads, contiguous, eager = got[f"table_heads/{name}"].tolist()
        # 2 K/V heads over 'model' 2; a rank's pool is its own tensor
        assert heads == 1 and contiguous and eager


@pytest.mark.parametrize("name", JAX_TABLES)
def test_tp_table_streams_equal_jax(spawn_run, name):
    """The port's TP tables (1 of 2 K/V heads a rank; paged, the kernel's
    plain version at that head count) against JAX's TP table."""
    _, _, refs, ranks = spawn_run
    want = {str(k): v for k, v in refs["jax_tables"][name].items()}
    assert len(want) == 6 and all(len(v) == 6 for v in want.values())
    for got in ranks:
        assert json.loads(str(got[f"table/{name}"])) == want


def test_tp_table_refuses_wall_clock_arrivals(spawn_run):
    _, _, _, ranks = spawn_run
    for got in ranks:
        msg = str(got["refusal/wall_clock"])
        assert msg.startswith(
            "the table's model is cut over 2 'model' ranks"), msg
        assert "[1, 2, 3, 4, 5] arrive after 0 on a wall clock" in msg
    served = [json.loads(str(got["virtual_clock"])) for got in ranks]
    assert all(s == served[0] for s in served)
    assert sorted(map(int, served[0])) == list(range(6))
    assert all(len(v) == 6 for v in served[0].values())


def test_temperature_draws_agree_on_every_rank(spawn_run):
    _, _, _, ranks = spawn_run
    draws = [json.loads(str(got["temperature"])) for got in ranks]
    assert all(d == draws[0] for d in draws)
    assert sum(len(v) for v in draws[0].values()) == 36


@pytest.mark.parametrize("key", ["batch", "slots"])
def test_refusals_equal_jax(spawn_run, key):
    _, refusals, _, ranks = spawn_run
    for got in ranks:
        assert str(got[f"refusal/{key}"]) == refusals[key]


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_sample_and_serve_equal_the_whole_model(spawn_run, name):
    _, _, _, ranks = spawn_run
    runs = [json.loads(str(got[f"cli/{name}"])) for got in ranks]
    for run in runs:
        assert run["samples"] == run["whole_samples"]
        assert run["streams"] == run["whole_streams"]
        assert run["streams"] == run["tp_streams"]
        assert run["completed"] == 4
        assert run["tp_table"] == CLI_TP_TABLE[name]
        assert run["bound"] == CLI_TP_TABLE[name]
        assert run["samples"] == runs[0]["samples"]
        assert run["streams"] == runs[0]["streams"]
    assert np.asarray(runs[0]["samples"]).shape[1] == 4


# ------------------------------------------------- no spawn: the layout


def _mesh_at(rank, shape=SHAPE, axes=AXES):
    """A ``Mesh`` at ``rank`` of a layout, without a process group (only
    its coordinates are read)."""
    return meshlib.Mesh(rank=rank, world_size=int(np.prod(shape)),
                        device=torch.device("cpu"), backend="gloo",
                        axis_names=axes, dims=shape)


@pytest.mark.parametrize("rank", range(WORLD))
def test_kv_slot_sharding_blocks(rank):
    """Rank (d, m) of (data 2, model 2) holds rows ``[4d, 4d + 4)`` of 8
    and kv heads ``[m, m + 1)`` of 2 (JAX ``kv_slot_sharding``'s spec);
    heads that do not split, or an absent axis, leave that dim whole.
    The attention binds at that block: a bound attention's cache holds
    ``kv_heads/tp`` heads, an unsplit one its whole count."""
    mesh = _mesh_at(rank)
    d, m = divmod(rank, 2)
    assert meshlib.kv_slot_sharding(mesh, 8, 2, 4) == (
        slice(4 * d, 4 * d + 4), slice(m, m + 1))
    assert meshlib.kv_slot_sharding(mesh, 8, 2, 3)[1] == slice(0, 2)
    assert meshlib.kv_slot_sharding(mesh, 8, 3)[1] == slice(0, 3)
    seq = _mesh_at(rank, (2, 2), ("data", "seq"))
    assert meshlib.kv_slot_sharding(seq, 8, 2) == (
        slice(4 * d, 4 * d + 4), slice(0, 2))
    model = _mesh_at(rank, (4,), ("model",))
    assert meshlib.kv_slot_sharding(model, 8, 4) == (
        slice(0, 8), slice(rank, rank + 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("heads, kv_heads, tp", [
    (8, 8, 1), (8, 8, 2), (8, 8, 4), (8, 8, 8), (8, 2, 1), (8, 2, 2)],
    ids=["mha_tp1", "mha_tp2", "mha_tp4", "mha_tp8", "gqa_tp1", "gqa_tp2"])
def test_paged_plan_at_per_rank_heads(heads, kv_heads, tp, dtype):
    """The paged kernel's plan at a TP rank's heads, on the serve GPT's
    table (8 slots, head_dim 64, block 8, 18 entries): the key splits
    stay a power of two within the table (the 144-token table caps them
    at 4, whatever the cut), the GQA group divides after the cut, and the
    CTA fits the card's shared memory."""
    from distributed_tensorflow_tpu_torch.ops import paged_attention as tpa

    h, kvh = heads // tp, kv_heads // tp
    assert h % kvh == 0
    splits = tpa._splits(8, kvh, 18, 8)
    assert splits == 4 and splits & (splits - 1) == 0
    quantized = dtype == torch.int8
    chunk, smem = tpa._plan(h // kvh, 64, 8, 18, splits,
                            torch.tensor([], dtype=dtype).element_size(),
                            quantized)
    assert 1 <= chunk <= -(-18 // splits)
    assert smem <= tpa._SMEM_TARGET
    assert smem == tpa.smem_bytes(h // kvh, 64, 8, mb=18, splits=splits,
                                  chunk=chunk, kv_bytes=1 if quantized
                                  else 2, quantized=quantized)
