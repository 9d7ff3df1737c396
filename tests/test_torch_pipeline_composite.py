"""The pipeline's dense composites (``PipelineEngine`` with 'model' and
'seq' axes: pp×tp, pp×sp, pp×tp×sp; the Megatron and sequence-parallel
GPT and BERT stages) against the JAX package, on gloo ranks (CPU).

One spawn of 8 ranks, run once by a module fixture.  The rank bodies live
at module level in this file, which imports no JAX at the top (a spawned
child re-imports the module of its target); the JAX references are
computed in the parent on the 8-device CPU mesh while the ranks run.  The
ranks first form a group of 8, then ranks 0-3 a group of 4.  Every engine
starts from the JAX engine's initial weights, converted and cut to each
rank's stage and 'model' slice by ``convert.pipeline_state_dicts``.  SGD
0.1, which is linear in the gradient, so a wrong scale shows; 2 steps on
one batch of 8 rows of 16 tokens, M = 2.  Inside ``shard_map`` JAX runs
its jnp attention twins, so the port's ``ring_flash`` runs its plain
block versions here (the card holds the kernels: ``chip_smoke.py`` phase
5n and ``test_torch_pipeline_composite_cuda.py``).  Tolerances:

* against JAX's ``PipelineEngine`` on the same mesh: the loss within
  1e-5, every parameter (the stacked whole leaves, on every rank) within
  atol 2e-5, rtol 1e-4, the bound of JAX's own
  ``test_bert_pipeline_tp_matches_sequential`` (f32 sums in other
  orders; JAX's GPipe adds the microbatches' gradients in reverse).  The
  cases: BERT stages pp×tp on (2, 2, 2) (data, pipe, model), GPipe and
  1F1B; GPT stages pp×tp on (1, 2, 2) with grouped K/V heads; GPT pp×sp
  on (2, 2, 2) (data, pipe, seq) with ``ring`` and learned positions,
  ``ring_flash`` and RoPE, and ``ring`` with remat (held to JAX's run
  without it: remat recomputes the same values); ``ulysses`` on (1, 2,
  2); pp×tp×sp on (1, 2, 2, 2) (data, pipe, seq, model) with ``ring``.
  The port's remat and 1F1B GPT runs on pp×tp are held to JAX's GPipe
  too;
* the port's GPipe, GPipe with remat and 1F1B are bitwise equal on each
  pp×tp mesh (one order of operations and of gradient sums);
* ``generate`` after the pp×tp×sp GPT run: the tokens bitwise JAX's
  (greedy, on the gathered whole model);
* a whole-leaf checkpoint written on pp×tp (Adam, BERT on (2, 2, 2))
  holds each block leaf as JAX's ``(S, ...)`` with every 'model' column,
  and restores so that the next step is bitwise the uninterrupted one;
* ``cli.main`` with ``-n 8 -pp 2 -tp 2 --model bert_tiny``, ``-pp 2 -sp
  2 --model gpt`` and ``-pp 2 -tp 2 -sp 2 --model gpt --sample 4``:
  JAX's summary names, finite losses, samples of the asked shape;
* the rejections: 1F1B with a 'seq' axis, BERT under pp×sp, the MLP under
  pp×tp, ``flash`` under pp×sp and ``--serve`` after ``-pp -tp``, in
  JAX's words.
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

WORLD, LR = 8, 0.1
TOL = dict(atol=2e-5, rtol=1e-4)
GPT = dict(vocab_size=64, hidden=32, heads=2, ffn=64, max_len=16)
BERT = dict(num_classes=2, vocab_size=64, hidden=32, heads=2, ffn=64,
            max_len=16)
TP, SP = ("data", "pipe", "model"), ("data", "pipe", "seq")
TP_SP = ("data", "pipe", "seq", "model")
RING = dict(attention_impl="ring", seq_axis="seq")
# name: (family, mesh shape, axes, stage kwargs, schedule, remat)
CASES = {
    "bert_tp_gpipe": ("bert", (2, 2, 2), TP, dict(partition_model=True),
                      "gpipe", False),
    "bert_tp_1f1b": ("bert", (2, 2, 2), TP, dict(partition_model=True),
                     "1f1b", False),
    "bert_tp_remat": ("bert", (2, 2, 2), TP, dict(partition_model=True),
                      "gpipe", True),
    "gpt_tp_gpipe": ("gpt", (1, 2, 2), TP, dict(partition_model=True,
                                                 heads=4, kv_heads=2),
                     "gpipe", False),
    "gpt_tp_1f1b": ("gpt", (1, 2, 2), TP, dict(partition_model=True,
                                                heads=4, kv_heads=2),
                    "1f1b", False),
    "gpt_tp_remat": ("gpt", (1, 2, 2), TP, dict(partition_model=True,
                                                 heads=4, kv_heads=2),
                     "gpipe", True),
    "gpt_sp_ring": ("gpt", (2, 2, 2), SP, RING, "gpipe", False),
    "gpt_sp_ring_flash_rope": ("gpt", (2, 2, 2), SP, dict(
        attention_impl="ring_flash", seq_axis="seq", positional="rope"),
        "gpipe", False),
    "gpt_sp_ring_remat": ("gpt", (2, 2, 2), SP, RING, "gpipe", True),
    "gpt_sp_ulysses": ("gpt", (1, 2, 2), SP, dict(attention_impl="ulysses",
                                                   seq_axis="seq"),
                       "gpipe", False),
    "gpt_tp_sp_ring": ("gpt", (1, 2, 2, 2), TP_SP,
                       dict(RING, partition_model=True), "gpipe", False),
}
# the JAX run a port case is held to, where it is not its own
JAX_TWIN = {"bert_tp_remat": "bert_tp_gpipe", "gpt_tp_1f1b": "gpt_tp_gpipe",
            "gpt_tp_remat": "gpt_tp_gpipe",
            "gpt_sp_ring_remat": "gpt_sp_ring"}
GROUP_OF_FOUR = ("gpt_tp_gpipe", "gpt_tp_1f1b", "gpt_tp_remat",
                 "gpt_sp_ulysses")
# each pp×tp mesh's port schedules, bitwise equal to one another
BITWISE = {"bert": ("bert_tp_gpipe", "bert_tp_1f1b", "bert_tp_remat"),
           "gpt": ("gpt_tp_gpipe", "gpt_tp_1f1b", "gpt_tp_remat")}
GENERATED = ("gpt_tp_sp_ring",)
STEPS, PROMPT, NEW = 2, 4, 6
CLI_COMMON = ["--microbatches", "2", "--pipeline-hidden", "32", "-b", "4",
              "--log-every", "0", "--device", "cpu", "-n", "8"]
CLI_ARGV = {
    "pp_tp": ["-pp", "2", "-tp", "2", "--model", "bert_tiny", "--dataset",
              "glue_synth"],
    "pp_sp": ["-pp", "2", "-sp", "2", "--model", "gpt", "--dataset",
              "lm_synth"],
    "pp_tp_sp": ["-pp", "2", "-tp", "2", "-sp", "2", "--model", "gpt",
                 "--dataset", "lm_synth", "--sample", "4",
                 "--sample-prompt-len", "4"],
}
CLI_NAMES = {"pp_tp": "pipeline_tp[dp*pp*tp,gpipe]",
             "pp_sp": "pipeline_sp[dp*pp*sp,ring]",
             "pp_tp_sp": "pipeline_tp_sp[dp*pp*tp*sp,ring]"}
# the rejections met after the mesh is made: run on the ranks
RANK_REJECT = {
    "mlp_under_pp_tp": dict(model="mlp", dataset="synthetic", n_devices=8,
                            pipeline_parallel=2, tensor_parallel=2),
    "serve_after_pp_tp": dict(model="gpt", dataset="lm_synth", n_devices=8,
                              pipeline_parallel=2, tensor_parallel=2,
                              microbatches=2, pipeline_hidden=32,
                              batch_size=4, serve_requests=4, log_every=0),
}


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

    family, _, _, kw, schedule, remat = CASES[name]
    factory = gpt_pipeline_stages if family == "gpt" else \
        bert_pipeline_stages
    return PipelineEngine(
        microbatches=2, mesh=mesh, schedule=schedule, remat=remat,
        stages=factory(**_stage_kw(family, kw), device="cpu"),
        optimizer=optimizer or (lambda p: torch.optim.SGD(p, lr=LR)))


def _load(eng, state, tree):
    """This rank's stage and 'model' slice of JAX's initial weights."""
    from distributed_tensorflow_tpu_torch.models import convert

    size = eng.mesh.shape
    embed, blocks, head = convert.pipeline_state_dicts(
        tree, eng.param_specs, size.get("model", 1),
        eng.mesh.axis_index("model") if "model" in size else 0)
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
        out.update({f"{name}/{s}/{k}": v.numpy().copy()
                    for k, v in eng.full_state_dict(state).items()})
    if name in GENERATED:
        out[f"{name}/generate"] = eng.generate(
            state, _batch("gpt")[0][:2, :PROMPT], NEW)


def _checkpoint(out, out_dir, mesh, tree):
    """Adam, 1 step, save; restore into a fresh state; one more step of
    each."""
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    xs = ys = None
    runs = {}
    for tag in ("uninterrupted", "restored"):
        eng = _engine("bert_tp_gpipe", mesh, adam)
        state = eng.init_state(torch.Generator().manual_seed(
            0 if tag == "uninterrupted" else 9))
        xs, ys = eng.shard_batch(*_batch("bert"))
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


def _rank(rank: int, ports, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch import cli
    from distributed_tensorflow_tpu_torch.utils import harness

    torch.set_num_threads(1)
    with open(f"{out_dir}/trees.pkl", "rb") as f:
        trees = pickle.load(f)
    out: dict = {}
    meshlib.init_process_group("cpu", WORLD, rank,
                               f"tcp://127.0.0.1:{ports[0]}")
    try:
        for name, (_, shape, axes, *_rest) in CASES.items():
            if name in GROUP_OF_FOUR:
                continue
            mesh = meshlib.create_mesh(WORLD, device="cpu", shape=shape,
                                       axis_names=axes)
            _engine_case(out, name, mesh, trees[JAX_TWIN.get(name, name)])
            if name == "bert_tp_gpipe":
                _checkpoint(out, out_dir, mesh, trees[name])
        for name, argv in CLI_ARGV.items():
            out[f"cli/{name}"] = json.dumps(cli.main(
                argv + CLI_COMMON,
                dataset_fn=_small_glue if name == "pp_tp" else _small_lm))
        for name, cfg in RANK_REJECT.items():
            try:
                harness.run(harness.ExperimentConfig(
                    **cfg, device="cpu", dataset_fn=(
                        _small_lm if cfg["model"] == "gpt" else None)))
                out[f"reject/{name}"] = "ran"
            except ValueError as e:
                out[f"reject/{name}"] = str(e)
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
                _engine_case(out, name, mesh,
                             trees[JAX_TWIN.get(name, name)])
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

    family, shape, axes, kw, schedule, remat = CASES[name]
    factory = gpt_pipeline_stages if family == "gpt" else \
        bert_pipeline_stages
    eng = PipelineEngine(
        microbatches=2, optimizer=optax.sgd(LR), schedule=schedule,
        remat=remat, stages=factory(**_stage_kw(family, kw)),
        mesh=jmesh.create_mesh(int(np.prod(shape)), shape=shape,
                               axis_names=axes))
    x, _ = _batch(family)
    return eng, eng.init_state(jax.random.key(0), x)


def _jax_steps(name, eng, state):
    """Each step's loss and stacked parameters, and the greedy tokens
    after the last step (for the cases in ``GENERATED``)."""
    x, y = _batch(CASES[name][0])
    xs, ys = eng.shard_batch(x, y)
    steps = []
    for _ in range(STEPS):
        state, m = eng.step(state, xs, ys)
        steps.append((float(m["loss"]), {k: v.numpy() for k, v in
                                         _stacked(state.params).items()}))
    gen = (eng.generate(state, _batch("gpt")[0][:2, :PROMPT], NEW)
           if name in GENERATED else None)
    return steps, gen


def _two_ports() -> tuple[int, int]:
    """Two free ports, held open together while the OS picks them, so
    that the group of 4 never meets at the port of the group of 8."""
    with socket.socket() as a, socket.socket() as b:
        a.bind(("127.0.0.1", 0))
        b.bind(("127.0.0.1", 0))
        return a.getsockname()[1], b.getsockname()[1]


@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    """The ranks start from the JAX engines' initial weights and run
    while the parent steps the JAX engines."""
    engines = {name: _jax_case(name) for name in CASES
               if name not in JAX_TWIN}
    out = tmp_path_factory.mktemp("ppc")
    # the weights go by file: arguments past a pipe's buffer would make
    # each start wait for the child before it to read them
    with open(out / "trees.pkl", "wb") as f:
        pickle.dump({name: _np_tree(state.params)
                     for name, (_, state) in engines.items()}, f)
    ranks = mp.spawn(_rank, args=(_two_ports(), str(out)), nprocs=WORLD,
                     join=False)
    try:
        jax_runs = {name: _jax_steps(name, eng, state)
                    for name, (eng, state) in engines.items()}
    finally:
        while not ranks.join():
            pass
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return jax_runs, got


def _ranks_of(name):
    return range(4 if name in GROUP_OF_FOUR else WORLD)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_equals_jax_every_step(spawn_run, name):
    jax_runs, ranks = spawn_run
    steps, _ = jax_runs[JAX_TWIN.get(name, name)]
    for r in _ranks_of(name):
        got = ranks[r]
        for s, (loss, params) in enumerate(steps, 1):
            np.testing.assert_allclose(got[f"{name}/{s}/loss"], loss,
                                       rtol=0, atol=1e-5,
                                       err_msg=f"rank {r} step {s} loss")
            for k, w in params.items():
                np.testing.assert_allclose(got[f"{name}/{s}/{k}"], w,
                                           err_msg=f"rank {r} step {s} {k}",
                                           **TOL)


@pytest.mark.parametrize("family", list(BITWISE))
def test_schedules_and_remat_are_bitwise_equal(spawn_run, family):
    _, ranks = spawn_run
    first, *others = BITWISE[family]
    for r in _ranks_of(first):
        keys = [k for k in ranks[r] if k.startswith(f"{first}/")
                and not k.endswith("/generate")]
        assert len(keys) > 2 * STEPS
        for other in others:
            for k in keys:
                assert np.array_equal(
                    ranks[r][k], ranks[r][k.replace(first, other, 1)]), (
                    r, other, k)


@pytest.mark.parametrize("name", GENERATED)
def test_generate_equals_jax(spawn_run, name):
    jax_runs, ranks = spawn_run
    want = np.asarray(jax_runs[name][1])
    assert want.shape == (2, PROMPT + NEW)
    for r in _ranks_of(name):
        np.testing.assert_array_equal(ranks[r][f"{name}/generate"], want)


def test_checkpoint_under_pp_tp_is_whole_and_resumes_bitwise(spawn_run):
    _, ranks = spawn_run
    shapes = json.loads(str(ranks[0]["ckpt/shapes"]))
    # JAX's (S, ...) block leaves, every 'model' column; whole tables
    assert shapes["model/block.layers.0.attn.query.weight"] == [2, 32, 32]
    assert shapes["model/block.layers.0.fc1.weight"] == [2, 64, 32]
    assert shapes["model/embed.embeddings.token_embed.weight"] == [64, 32]
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
    # every rank reports the same all-reduced evaluation
    assert len({json.loads(str(g[f"cli/{name}"]))["test_loss"]
                for g in ranks}) == 1
    if name == "pp_tp_sp":
        # one prompt per data shard (8 / (2·2·2) = 1), decoded whole
        samples = np.asarray(summary["samples"])
        assert samples.shape == (1, 4)
        assert ((samples >= 0) & (samples < 64)).all()


def _messages(jax_fn, port_fn, exc=ValueError):
    with pytest.raises(exc) as want:
        jax_fn()
    with pytest.raises(exc) as got:
        port_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_rejections_on_the_ranks_are_jax_word_for_word(spawn_run):
    """The MLP under pp×tp (raised once the mesh is made and the data
    loaded) and ``--serve`` after ``-pp -tp`` (raised before training,
    not as TP decode), the port's through ``harness.run`` on the ranks."""
    from distributed_tensorflow_tpu.utils import harness as jharness

    _, ranks = spawn_run
    with pytest.raises(ValueError) as want:
        jharness._setup(jharness.ExperimentConfig(
            **RANK_REJECT["mlp_under_pp_tp"]))
    assert str(ranks[0]["reject/mlp_under_pp_tp"]) == str(want.value)
    assert "ships TP-annotated stages" in str(want.value)
    serve = str(ranks[0]["reject/serve_after_pp_tp"])
    assert serve == _jax_serve_message()
    assert "pipe-stacked" in serve


def _jax_serve_message() -> str:
    """JAX's ``_validate_serving`` on an experiment holding a pipeline."""
    from distributed_tensorflow_tpu.data.loaders import load_lm_dataset
    from distributed_tensorflow_tpu.engines.pipeline import PipelineEngine
    from distributed_tensorflow_tpu.models.gpt import gpt_pipeline_stages
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu.utils import harness as jharness

    ds = load_lm_dataset(seq_len=16, vocab_size=64, n_train=8, n_test=8,
                         split="test")
    eng = PipelineEngine(
        microbatches=2, stages=gpt_pipeline_stages(
            **GPT, partition_model=True),
        mesh=jmesh.create_mesh(4, shape=(1, 2, 2), axis_names=TP))
    ex = jharness._Experiment(mesh=None, n=1, train_ds=ds, test_ds=ds,
                              engine=eng, global_batch=8,
                              name="pipeline_tp[dp*pp*tp,gpipe]")
    with pytest.raises(ValueError) as err:
        jharness._validate_serving(jharness.ExperimentConfig(
            model="gpt", serve_requests=4), ex, ds)
    return str(err.value)


# ------------------------------------------------------------ no ranks


def _fake_mesh(shape, axes):
    """A mesh value for the constructors' checks, which read its axes and
    this rank's coordinates only (no process group)."""
    return meshlib.Mesh(rank=0, world_size=int(np.prod(shape)),
                        device=torch.device("cpu"), backend="gloo",
                        axis_names=axes, dims=shape)


def test_1f1b_with_a_seq_axis_is_refused_in_jax_words():
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
            microbatches=2, schedule="1f1b", stages=jstages(**GPT, **RING),
            mesh=jmesh.create_mesh(4, shape=(1, 2, 2), axis_names=SP)),
        lambda: PipelineEngine(
            microbatches=2, schedule="1f1b", mesh=_fake_mesh((1, 2, 2), SP),
            stages=gpt_pipeline_stages(**GPT, **RING, device="cpu")))
    assert "schedule='1f1b' does not compose with a 'seq'" in msg


@pytest.mark.parametrize("kw", [
    dict(model="bert_tiny", dataset="glue_synth"),
    dict(model="gpt", dataset="lm_synth", attention_impl="flash"),
    dict(model="gpt", dataset="lm_synth", attention_impl="flash",
         tensor_parallel=2)],
    ids=["bert_under_pp_sp", "flash_under_pp_sp", "flash_under_pp_tp_sp"])
def test_harness_rejections_before_the_mesh_are_jax_word_for_word(kw):
    """JAX's ``_setup_pipeline_sp`` refusals, raised before any mesh is
    made: BERT ships no sequence-parallel stages, and ``flash`` is the
    single-device kernel."""
    from distributed_tensorflow_tpu.utils import harness as jharness
    from distributed_tensorflow_tpu_torch.utils import harness

    cfg = dict(kw, n_devices=8, pipeline_parallel=2, seq_parallel=2)
    msg = _messages(lambda: jharness._setup(jharness.ExperimentConfig(**cfg)),
                    lambda: harness._setup(harness.ExperimentConfig(
                        **cfg, device="cpu")))
    assert ("ships GPT decoder stages only" in msg
            if kw["model"] == "bert_tiny" else "--attention flash" in msg)


def test_pipeline_state_dicts_cut_each_stage_to_its_slice():
    """``convert.pipeline_state_dicts`` with a pp×tp engine's specs cuts
    a block leaf by its layout after 'pipe' and the head's columns."""
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    eng, state = _jax_case("gpt_tp_gpipe")
    tree = _np_tree(state.params)
    whole = convert.pipeline_state_dicts(tree)
    specs = PipelineEngine(
        microbatches=2, mesh=_fake_mesh((1, 2, 2), TP),
        stages=gpt_pipeline_stages(**_stage_kw("gpt", CASES[
            "gpt_tp_gpipe"][3]), device="cpu")).param_specs
    assert specs["block.layers.0.attn.query.weight"] == ("pipe", "model",
                                                         None)
    assert specs["block.layers.0.fc2.weight"] == ("pipe", None, "model")
    embed, blocks, head = convert.pipeline_state_dicts(tree, specs, 2, 1)
    q = "layers.0.attn.query.weight"
    assert torch.equal(blocks[1][q], whole[1][1][q][16:])
    assert torch.equal(blocks[0]["layers.0.fc2.weight"],
                       whole[1][0]["layers.0.fc2.weight"][:, 32:])
    assert torch.equal(embed["token_embed.weight"],
                       whole[0]["token_embed.weight"][32:])
    assert torch.equal(head["lm_head.bias"], whole[2]["lm_head.bias"][32:])
    assert torch.equal(head["ln_f.weight"], whole[2]["ln_f.weight"])
