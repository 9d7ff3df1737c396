"""The pipeline's MoE composites (``PipelineEngine`` over MoE stage blocks
with an 'expert' axis: pp×ep, pp×ep×tp, pp×ep×sp, pp×ep×tp×sp; the MoE
GPT and BERT stages) against the JAX package, on gloo ranks (CPU).

One spawn of 8 ranks, run once by a module fixture.  The rank bodies live
at module level in this file, which imports no JAX at the top (a spawned
child re-imports the module of its target); the JAX engines step in the
parent on the 8-device CPU mesh while the ranks run, and their initial
weights reach the ranks by a file.  Every engine starts from the JAX
engine's initial weights, converted and cut to each rank's stage,
'model' slice and experts by ``convert.pipeline_state_dicts``.  SGD 0.1,
which is linear in the gradient, so a wrong scale shows; 2 steps on one
batch of 8 rows of 16 tokens, M = 2; 4 experts at capacity factor 1.25,
so tokens drop, with ``aux_weight`` 0.01 and ``router_z_weight`` 1e-3.
Inside ``shard_map`` JAX runs its jnp attention twins, so the port's
stages run dense and ring attention here (the card holds the flash
kernels: ``chip_smoke.py`` phase 5o and
``test_torch_pipeline_ep_cuda.py``).

The oracle of every case is JAX's ``PipelineEngine`` step on the same
mesh (each case below ran there in the parent): the loss within 1e-5,
the overflow within 1e-6, every parameter (the stacked whole leaves, the
experts gathered, on every rank) within atol 2e-5, rtol 1e-4, the bound
of JAX's own ``test_pipeline_moe_matches_chunked_oracle`` (f32 sums in
other orders; JAX's GPipe adds the microbatches' gradients in reverse).
The cases: GPT and BERT pp×ep on (2, 2, 2) (data, pipe, expert), GPipe;
GPT pp×ep with remat, held to JAX's GPipe and bitwise to the port's
GPipe (the router terms are counted once: the recompute's); GPT
pp×ep×tp on (1, 2, 2, 2) (data, pipe, expert, model) with top-2 routing
and the 2-D expert layout; GPT pp×ep×sp on (1, 2, 2, 2) (data, pipe,
expert, seq) with ``ring``, whose overflow and gradients hold the routing
population (each seq block's router sees only its own tokens, as JAX's
'seq'-manual ``shard_map`` does); GPT pp×ep×tp×sp on (1, 2, 2, 1, 2)
(data, pipe, expert, model, seq), the harness's axis order, held to
JAX's pp×ep×sp run (its 'model' axis has one rank).

Besides: a whole-leaf checkpoint written on pp×ep (Adam) holds each
expert leaf as JAX's ``(S, E, ...)`` and restores so that the next step
is bitwise the uninterrupted one; ``cli.main -n 8`` with ``-pp 2 -ep 2``
(GPT and BERT), ``-pp 2 -ep 2 -tp 2`` and ``-pp 2 -ep 2 -sp 2``: JAX's
summary names, the router-health fields, finite losses; the refusals in
JAX's words (1F1B with MoE stages, an 'expert' axis over dense stages or
without ``partition_experts``, experts that do not split, BERT or
``flash`` under pp×ep×sp, ``--sample`` after ``-pp -ep``); and
``pipeline_state_dicts``' expert cut.
"""

from __future__ import annotations

import json
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

WORLD, LR, AUX, Z = 8, 0.1, 0.01, 1e-3
TOL = dict(atol=2e-5, rtol=1e-4)
GPT = dict(vocab_size=64, hidden=32, heads=2, ffn=64, max_len=16)
BERT = dict(num_classes=2, vocab_size=64, hidden=32, heads=2, ffn=64,
            max_len=16)
MOE = dict(moe_experts=4, partition_experts=True)
RING = dict(attention_impl="ring", seq_axis="seq")
EP = ("data", "pipe", "expert")
EP_TP = ("data", "pipe", "expert", "model")
EP_SP = ("data", "pipe", "expert", "seq")
EP_TP_SP = ("data", "pipe", "expert", "model", "seq")
# name: (family, mesh shape, axes, stage kwargs, remat)
CASES = {
    "gpt_ep": ("gpt", (2, 2, 2), EP, MOE, False),
    "gpt_ep_remat": ("gpt", (2, 2, 2), EP, MOE, True),
    "bert_ep": ("bert", (2, 2, 2), EP, MOE, False),
    "gpt_ep_tp": ("gpt", (1, 2, 2, 2), EP_TP,
                  dict(MOE, partition_model=True, moe_top_k=2), False),
    "gpt_ep_sp": ("gpt", (1, 2, 2, 2), EP_SP, dict(MOE, **RING), False),
    "gpt_ep_tp_sp": ("gpt", (1, 2, 2, 1, 2), EP_TP_SP,
                     dict(MOE, partition_model=True, **RING), False),
}
# the cases whose final state is evaluated on the small LM's test split,
# against JAX's GSPMD evaluation (the whole batch routes as one population)
EVALUATED = ("gpt_ep",)
# the JAX run a port case is held to, where it is not its own: remat
# recomputes GPipe's values, and a 'model' axis of one rank leaves JAX's
# pp×ep×sp function as it is (its 5-D engine's losses are the 4-D one's
# to the bit)
JAX_TWIN = {"gpt_ep_remat": "gpt_ep", "gpt_ep_tp_sp": "gpt_ep_sp"}
STEPS = 2
CLI_COMMON = ["--microbatches", "2", "--pipeline-hidden", "32", "-b", "4",
              "--log-every", "0", "--device", "cpu", "-n", "8",
              "--num-experts", "4"]
CLI_ARGV = {
    "pp_ep": ["-pp", "2", "-ep", "2", "--model", "gpt", "--dataset",
              "lm_synth", "--router-z-weight", "1e-3", "--model-arg",
              "moe_capacity_factor=2.0"],
    "pp_ep_bert": ["-pp", "2", "-ep", "2", "--model", "bert_tiny",
                   "--dataset", "glue_synth"],
    "pp_ep_tp": ["-pp", "2", "-ep", "2", "-tp", "2", "--model", "gpt",
                 "--dataset", "lm_synth", "--router-top-k", "2"],
    "pp_ep_sp": ["-pp", "2", "-ep", "2", "-sp", "2", "--model", "gpt",
                 "--dataset", "lm_synth"],
}
CLI_NAMES = {"pp_ep": "pipeline_ep[dp*pp*ep,gpipe]",
             "pp_ep_bert": "pipeline_ep[dp*pp*ep,gpipe]",
             "pp_ep_tp": "pipeline_ep_tp[dp*pp*ep*tp]",
             "pp_ep_sp": "pipeline_ep_sp[dp*pp*ep*sp,ring]"}


def _batch(family):
    """One global batch of 8 rows of 16 tokens: next-token pairs for the
    GPT, padded rows with binary labels for BERT."""
    rng = np.random.default_rng({"gpt": 11, "bert": 0}[family])
    if family == "gpt":
        x = rng.integers(0, 64, (8, 16)).astype(np.int32)
        return x, np.roll(x, -1, axis=1).astype(np.int32)
    x = rng.integers(1, 64, (8, 16)).astype(np.int32)
    x[:, 13:] = 0
    return x, (np.arange(8) % 2).astype(np.int32)


def _stage_kw(family, kw):
    return {**(GPT if family == "gpt" else BERT), **kw}


def _small_lm(batch_size, type="train"):
    """A picklable ``dataset_fn``: 32 rows of 16 tokens over 64 ids."""
    del batch_size
    return tloaders.load_lm_dataset(seq_len=16, vocab_size=64, n_train=32,
                                    n_test=16, split=type)


def _small_glue(batch_size, type="train"):
    """A picklable ``dataset_fn``: 32 padded rows of 16 tokens, 2 classes."""
    del batch_size
    return tloaders.load_text_dataset(seq_len=16, vocab_size=64, n_train=32,
                                      n_test=16, split=type)


# ------------------------------------------------------------ the ranks


def _engine(name, mesh, optimizer=None):
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.bert import (
        bert_pipeline_stages)
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    family, _, _, kw, remat = CASES[name]
    factory = gpt_pipeline_stages if family == "gpt" else \
        bert_pipeline_stages
    return PipelineEngine(
        microbatches=2, mesh=mesh, remat=remat, aux_weight=AUX,
        router_z_weight=Z,
        stages=factory(**_stage_kw(family, kw), device="cpu"),
        optimizer=optimizer or (lambda p: torch.optim.SGD(p, lr=LR)))


def _index(mesh, axis):
    return mesh.axis_index(axis) if axis in mesh.shape else 0


def _load(eng, state, tree):
    """This rank's stage, 'model' slice and experts of JAX's initial
    weights."""
    from distributed_tensorflow_tpu_torch.models import convert

    size = eng.mesh.shape
    embed, blocks, head = convert.pipeline_state_dicts(
        tree, eng.param_specs, size.get("model", 1),
        _index(eng.mesh, "model"), size.get("expert", 1),
        _index(eng.mesh, "expert"))
    sd = {f"embed.{k}": v for k, v in embed.items()}
    sd.update({f"block.{k}": v for k, v in blocks[eng.stage].items()})
    sd.update({f"head.{k}": v for k, v in head.items()})
    state.model.load_state_dict(sd)


def _engine_case(out, name, mesh, tree):
    eng = _engine(name, mesh)
    state = eng.init_state(torch.Generator().manual_seed(0))
    _load(eng, state, tree)
    xs, ys = eng.shard_batch(*_batch(CASES[name][0]))
    for s in range(1, STEPS + 1):
        state, m = eng.step(state, xs, ys)
        out[f"{name}/{s}/loss"] = np.asarray(float(m["loss"]))
        out[f"{name}/{s}/overflow"] = np.asarray(float(m["overflow"]))
        out.update({f"{name}/{s}/{k}": v.numpy().copy()
                    for k, v in eng.full_state_dict(state).items()})
    if name in EVALUATED:
        got = eng.evaluate(state, _small_lm(0, "test"), batch_size=8)
        out[f"{name}/eval"] = np.asarray([got["loss"], got["accuracy"],
                                          got["count"]])


def _checkpoint(out, out_dir, mesh, tree):
    """Adam, 1 step, save; restore into a fresh state; one more step of
    each."""
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    xs = ys = None
    runs = {}
    for tag in ("uninterrupted", "restored"):
        eng = _engine("gpt_ep", mesh, adam)
        state = eng.init_state(torch.Generator().manual_seed(
            0 if tag == "uninterrupted" else 9))
        xs, ys = eng.shard_batch(*_batch("gpt"))
        if tag == "uninterrupted":
            _load(eng, state, tree)
            state, _ = eng.step(state, xs, ys)
            CheckpointManager(f"{out_dir}/ckpt").save(state)
        else:
            CheckpointManager(f"{out_dir}/ckpt").restore(state)
        runs[tag] = (eng, state)
    for tag, (eng, state) in runs.items():
        state, m = eng.step(state, xs, ys)
        out[f"ckpt/{tag}/loss"] = np.asarray(float(m["loss"]))
        out.update({f"ckpt/{tag}/{k}": v.numpy().copy()
                    for k, v in eng.full_state_dict(state).items()})
    saved = torch.load(f"{out_dir}/ckpt/step_1/state.pt", weights_only=True)
    out["ckpt/shapes"] = json.dumps({k: list(v.shape)
                                     for k, v in saved.items()
                                     if k.startswith("model/")})


def _rank(rank: int, port: int, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch import cli

    torch.set_num_threads(1)
    with open(f"{out_dir}/trees.pkl", "rb") as f:
        trees = pickle.load(f)
    out: dict = {}
    meshlib.init_process_group("cpu", WORLD, rank, f"tcp://127.0.0.1:{port}")
    try:
        for name, (_, shape, axes, *_rest) in CASES.items():
            mesh = meshlib.create_mesh(WORLD, device="cpu", shape=shape,
                                       axis_names=axes)
            _engine_case(out, name, mesh, trees[JAX_TWIN.get(name, name)])
            if name == "gpt_ep":
                _checkpoint(out, out_dir, mesh, trees[name])
        for name, argv in CLI_ARGV.items():
            out[f"cli/{name}"] = json.dumps(cli.main(
                argv + CLI_COMMON,
                dataset_fn=_small_glue if "bert" in name else _small_lm))
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **out)


# ------------------------------------------------------------ the parent


def _np_tree(params):
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(params))


def _stacked(params):
    from distributed_tensorflow_tpu_torch.models import convert

    return convert.stacked_state_dict(
        *convert.pipeline_state_dicts(_np_tree(params)))


def _jax_case(name):
    """JAX's engine of case ``name`` on its mesh and its initial state."""
    import jax
    import optax

    from distributed_tensorflow_tpu.engines.pipeline import PipelineEngine
    from distributed_tensorflow_tpu.models.bert import bert_pipeline_stages
    from distributed_tensorflow_tpu.models.gpt import gpt_pipeline_stages
    from distributed_tensorflow_tpu.parallel import mesh as jmesh

    family, shape, axes, kw, remat = CASES[name]
    factory = gpt_pipeline_stages if family == "gpt" else \
        bert_pipeline_stages
    eng = PipelineEngine(
        microbatches=2, optimizer=optax.sgd(LR), remat=remat,
        aux_weight=AUX, router_z_weight=Z,
        stages=factory(**_stage_kw(family, kw)),
        mesh=jmesh.create_mesh(int(np.prod(shape)), shape=shape,
                               axis_names=axes))
    x, _ = _batch(family)
    return eng, eng.init_state(jax.random.key(0), x)


def _jax_steps(name, eng, state):
    """Each step's loss, overflow and stacked parameters, and the
    evaluation of the final state (for the cases in ``EVALUATED``)."""
    from distributed_tensorflow_tpu.data.loaders import load_lm_dataset

    x, y = _batch(CASES[name][0])
    xs, ys = eng.shard_batch(x, y)
    steps = []
    for _ in range(STEPS):
        state, m = eng.step(state, xs, ys)
        steps.append((float(m["loss"]), float(m["overflow"]),
                      {k: v.numpy() for k, v in
                       _stacked(state.params).items()}))
    if name not in EVALUATED:
        return steps, None
    test = load_lm_dataset(seq_len=16, vocab_size=64, n_train=32, n_test=16,
                           split="test")
    assert np.array_equal(test.x, _small_lm(0, "test").x)
    got = eng.evaluate(state, test, batch_size=8)
    return steps, (got["loss"], got["accuracy"], got["count"])


# the JAX cases a second process steps beside the parent: XLA compiles
# one program at a time in a process, and compiling dominates
CHILD = ("bert_ep", "gpt_ep_sp")


def _jax_child(names):
    """``_jax_steps`` of ``names`` from their own inits, in a process of
    its own (on the 8-device CPU mesh)."""
    from __graft_entry__ import _force_cpu_mesh

    _force_cpu_mesh(8)
    return {name: _jax_steps(name, *_jax_case(name)) for name in names}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    """The ranks start from the JAX engines' initial weights and run
    while the parent and a second process step the JAX engines."""
    with mp.get_context("spawn").Pool(1) as pool:
        child = pool.apply_async(_jax_child, (CHILD,))
        engines = {name: _jax_case(name) for name in CASES
                   if name not in JAX_TWIN}
        out = tmp_path_factory.mktemp("ppe")
        # the weights go by file: arguments past a pipe's buffer would make
        # each start wait for the child before it to read them
        with open(out / "trees.pkl", "wb") as f:
            pickle.dump({name: _np_tree(state.params)
                         for name, (_, state) in engines.items()}, f)
        ranks = mp.spawn(_rank, args=(_free_port(), str(out)),
                         nprocs=WORLD, join=False)
        try:
            jax_runs = {name: _jax_steps(name, eng, state)
                        for name, (eng, state) in engines.items()
                        if name not in CHILD}
            jax_runs.update(child.get())
        finally:
            while not ranks.join():
                pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return jax_runs, got


@pytest.mark.parametrize("name", list(CASES))
def test_engine_equals_jax_every_step(spawn_run, name):
    jax_runs, ranks = spawn_run
    steps, _ = jax_runs[JAX_TWIN.get(name, name)]
    for r in range(WORLD):
        got = ranks[r]
        for s, (loss, overflow, params) in enumerate(steps, 1):
            np.testing.assert_allclose(got[f"{name}/{s}/loss"], loss,
                                       rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} step {s} loss")
            np.testing.assert_allclose(got[f"{name}/{s}/overflow"],
                                       overflow, rtol=0, atol=1e-6,
                                       err_msg=f"rank {r} step {s} overflow")
            for k, w in params.items():
                np.testing.assert_allclose(got[f"{name}/{s}/{k}"], w,
                                           err_msg=f"rank {r} step {s} {k}",
                                           **TOL)


def test_cases_route_with_drops(spawn_run):
    """The capacity drops tokens in every case (the router terms and the
    capacity are on the tested path), and no case is drop-free."""
    jax_runs, _ = spawn_run
    for name, (steps, _) in jax_runs.items():
        assert all(0.0 < overflow < 1.0 for _, overflow, _ in steps), name


@pytest.mark.parametrize("name", EVALUATED)
def test_evaluate_equals_jax(spawn_run, name):
    """``evaluate`` after the steps routes each eval batch whole on every
    rank, as JAX's GSPMD evaluation does: its loss within 1e-5 and its
    accuracy and count equal JAX's, on every rank."""
    jax_runs, ranks = spawn_run
    loss, accuracy, count = jax_runs[name][1]
    for r in range(WORLD):
        got = ranks[r][f"{name}/eval"]
        np.testing.assert_allclose(got[0], loss, rtol=0, atol=1e-5,
                                   err_msg=f"rank {r}")
        assert got[1] == accuracy and got[2] == count == 16 * 16, (r, got)


def test_remat_is_bitwise_gpipe(spawn_run):
    """The router terms of a remat step come from the backward tick's
    recompute alone: the step is bitwise GPipe's, on every rank."""
    _, ranks = spawn_run
    for r in range(WORLD):
        keys = [k for k in ranks[r] if k.startswith("gpt_ep/")
                and not k.endswith("/eval")]
        assert len(keys) > 3 * STEPS
        for k in keys:
            assert np.array_equal(
                ranks[r][k], ranks[r][k.replace("gpt_ep", "gpt_ep_remat",
                                                1)]), (r, k)


def test_checkpoint_under_pp_ep_is_whole_and_resumes_bitwise(spawn_run):
    _, ranks = spawn_run
    shapes = json.loads(str(ranks[0]["ckpt/shapes"]))
    # JAX's (S, E, ...) expert leaves, every expert; the gate whole
    assert shapes["model/block.layers.0.moe.w1"] == [2, 4, 32, 64]
    assert shapes["model/block.layers.0.moe.w2"] == [2, 4, 64, 32]
    assert shapes["model/block.layers.0.moe.gate"] == [2, 32, 4]
    for r in range(WORLD):
        keys = [k for k in ranks[r] if k.startswith("ckpt/uninterrupted/")]
        assert len(keys) > 2
        for k in keys:
            assert np.array_equal(
                ranks[r][k], ranks[r][k.replace("uninterrupted",
                                                "restored")]), (r, k)


@pytest.mark.parametrize("name", list(CLI_ARGV))
def test_cli_runs_the_composite(spawn_run, name):
    _, ranks = spawn_run
    summary = json.loads(str(ranks[0][f"cli/{name}"]))
    assert summary["engine"] == CLI_NAMES[name]
    assert summary["n_devices"] == 8 and summary["pipeline_parallel"] == 2
    assert summary["steps"] > 0 and np.isfinite(summary["test_loss"])
    # the router-health watch: no window of 50 steps is complete yet
    assert summary["expert_overflow_warnings"] == 0
    assert "expert_overflow_window_mean" in summary
    # every rank reports the same evaluation
    assert len({json.loads(str(g[f"cli/{name}"]))["test_loss"]
                for g in ranks}) == 1


# ------------------------------------------------------------ no ranks


def _messages(jax_fn, port_fn, exc=ValueError):
    with pytest.raises(exc) as want:
        jax_fn()
    with pytest.raises(exc) as got:
        port_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


def _fake_mesh(shape, axes):
    """A mesh value for the constructors' checks, which read its axes and
    this rank's coordinates only (no process group)."""
    return meshlib.Mesh(rank=0, world_size=int(np.prod(shape)),
                        device=torch.device("cpu"), backend="gloo",
                        axis_names=axes, dims=shape)


@pytest.mark.parametrize("case,kw,schedule,must", [
    ("1f1b", MOE, "1f1b", "schedule='1f1b' does not compose with MoE"),
    ("dense_stages", {}, "gpipe", "has no MoE FFN"),
    ("no_partition", dict(moe_experts=4), "gpipe", "partition_experts=True"),
    ("indivisible", dict(moe_experts=3, partition_experts=True), "gpipe",
     "not divisible by expert axis size 2")],
    ids=["1f1b", "dense_stages", "no_partition", "indivisible"])
def test_engine_refusals_are_jax_word_for_word(case, kw, schedule, must):
    from distributed_tensorflow_tpu.engines.pipeline import (
        PipelineEngine as JPipelineEngine)
    from distributed_tensorflow_tpu.models.gpt import (
        gpt_pipeline_stages as jstages)
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    msg = _messages(
        lambda: JPipelineEngine(
            microbatches=2, schedule=schedule, stages=jstages(**GPT, **kw),
            mesh=jmesh.create_mesh(4, shape=(1, 2, 2), axis_names=EP)),
        lambda: PipelineEngine(
            microbatches=2, schedule=schedule, mesh=_fake_mesh((1, 2, 2), EP),
            stages=gpt_pipeline_stages(**GPT, **kw, device="cpu")))
    assert must in msg


@pytest.mark.parametrize("kw", [
    dict(model="bert_tiny", dataset="glue_synth", seq_parallel=2),
    dict(model="gpt", dataset="lm_synth", seq_parallel=2,
         attention_impl="flash"),
    dict(model="gpt", dataset="lm_synth", num_experts=3)],
    ids=["bert_under_pp_ep_sp", "flash_under_pp_ep_sp", "indivisible"])
def test_harness_rejections_before_the_mesh_are_jax_word_for_word(kw):
    """JAX's ``_setup_pipeline_ep`` refusals, raised before any mesh is
    made: BERT ships no sequence-parallel stages, ``flash`` is the
    single-device kernel, and the experts must split over 'expert'."""
    from distributed_tensorflow_tpu.utils import harness as jharness
    from distributed_tensorflow_tpu_torch.utils import harness

    cfg = dict(kw, n_devices=8, pipeline_parallel=2, expert_parallel=2)
    msg = _messages(lambda: jharness._setup(jharness.ExperimentConfig(**cfg)),
                    lambda: harness._setup(harness.ExperimentConfig(
                        **cfg, device="cpu")))
    assert ("ships MoE-FFN stages for gpt/gpt_tiny" in msg
            if kw["model"] == "bert_tiny" else "--attention flash" in msg
            if "attention_impl" in kw else "not divisible by expert_parallel"
            in msg)


def test_sample_after_pp_ep_is_refused_in_jax_words():
    """``--sample`` after ``-pp -ep``: JAX's ``_validate_sampling``
    refusal (the fixed-length decode is not the greedy continuation under
    capacity-limited routing), before any training."""
    from distributed_tensorflow_tpu.data.loaders import load_lm_dataset
    from distributed_tensorflow_tpu.engines.pipeline import (
        PipelineEngine as JPipelineEngine)
    from distributed_tensorflow_tpu.models.gpt import (
        gpt_pipeline_stages as jstages)
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu.utils import harness as jharness
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)
    from distributed_tensorflow_tpu_torch.utils import harness

    jds = load_lm_dataset(seq_len=16, vocab_size=64, n_train=8, n_test=8,
                          split="test")
    ds = _small_lm(0, "test")
    engines = (
        JPipelineEngine(microbatches=2, stages=jstages(**GPT, **MOE),
                        mesh=jmesh.create_mesh(4, shape=(1, 2, 2),
                                               axis_names=EP)),
        PipelineEngine(microbatches=2, mesh=_fake_mesh((1, 2, 2), EP),
                       stages=gpt_pipeline_stages(**GPT, **MOE,
                                                  device="cpu")))
    msg = _messages(
        lambda: jharness._validate_sampling(
            jharness.ExperimentConfig(model="gpt", sample_tokens=4),
            jharness._Experiment(mesh=None, n=1, train_ds=jds, test_ds=jds,
                                 engine=engines[0], global_batch=8,
                                 name="pipeline_ep[dp*pp*ep,gpipe]"), jds),
        lambda: harness._validate_sampling(
            harness.ExperimentConfig(model="gpt", sample_tokens=4),
            harness._Experiment(mesh=None, n=1, train_ds=ds, test_ds=ds,
                                engine=engines[1], global_batch=8,
                                name="pipeline_ep[dp*pp*ep,gpipe]"), ds))
    assert "MoE pipeline stages" in msg
    # the engine's own decode keeps JAX's refusal too
    with pytest.raises(ValueError, match="does not support MoE stage"):
        engines[1].generate(None, np.zeros((1, 4), np.int32), 2)


def test_pipeline_state_dicts_cut_the_experts():
    """``convert.pipeline_state_dicts`` with a pp×ep×tp engine's specs
    cuts an expert leaf by its layout after 'pipe': its experts over
    'expert' and, under the 2-D layout, its hidden width over 'model'."""
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    _, state = _jax_case("gpt_ep_tp")
    tree = _np_tree(state.params)
    whole = convert.pipeline_state_dicts(tree)
    specs = PipelineEngine(
        microbatches=2, mesh=_fake_mesh((1, 2, 2, 2), EP_TP),
        stages=gpt_pipeline_stages(**_stage_kw("gpt", CASES[
            "gpt_ep_tp"][3]), device="cpu")).param_specs
    w1, w2 = "layers.0.moe.w1", "layers.0.moe.w2"
    assert specs[f"block.{w1}"] == ("pipe", "expert", None, "model")
    assert specs[f"block.{w2}"] == ("pipe", "expert", "model", None)
    assert specs["block.layers.0.moe.gate"] == ("pipe", None, None)
    _, blocks, _ = convert.pipeline_state_dicts(tree, specs, 2, 1, 2, 0)
    assert torch.equal(blocks[1][w1], whole[1][1][w1][:2, :, 32:])
    assert torch.equal(blocks[0][w2], whole[1][0][w2][:2, 32:])
    assert torch.equal(blocks[1]["layers.0.moe.gate"],
                       whole[1][1]["layers.0.moe.gate"])
    _, blocks, _ = convert.pipeline_state_dicts(tree, specs, 2, 0, 2, 1)
    assert torch.equal(blocks[0][w1], whole[1][0][w1][2:, :, :32])
