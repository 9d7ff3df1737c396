"""The port's ``SeqParallelEngine``, ``-sp`` and the 2-D mesh against the
JAX package, on gloo ranks (CPU).

Two spawns (a spawn costs seconds), each run once by a module fixture.
The rank bodies live at module level in this file, which imports no JAX
at the top: a spawned child re-imports the module that defines its
target, and JAX references are computed in the parent.

* spawn 1, 4 ranks on a (data, seq) mesh of shape (2, 2): the ranks' mesh
  coordinates and sub-groups; then ``SeqParallelEngine`` for 2 SGD steps
  on a tiny GPT (``ring``, ``ring_flash``, ``ulysses``, rope with
  ``kv_heads`` 2 on ``ring``, ``grad_accum`` 2, remat with ``ring``) and a
  tiny BERT (``ring``, padded rows), from the JAX engine's initial weights
  (``models/convert.py``).  After each step every rank's parameters equal
  the JAX ``SeqParallelEngine``'s within ``atol=1e-5`` (f32; the same
  algorithm, sums in other orders) and single-device dense training (the
  port's ``SyncEngine`` on one process, ``atol=2e-5``: a ring schedule
  reassociates the softmax sums), and the losses agree within
  ``rtol=1e-5``.  SGD, because it is linear in the gradient: a wrong
  scale (``1/dp`` against ``1/(dp·sp)``) shows.  Dropout 0.  ``evaluate``
  counts every token of the LM and every example of BERT, and its
  accuracy and loss equal JAX's.
* spawn 2, 2 ranks: ``cli.main`` with ``-n 2 -sp 2`` on a tiny GPT
  (``--attention ring``), run in the ranks' group, from the initial
  weights of the JAX CLI's run with the same flags; the summaries agree
  (engine ``seq_parallel[ring]``, the mesh's sizes, steps) and the test
  loss is JAX's within ``rtol=2e-3``: the CLI trains with Adam, whose
  normalised update turns the rounding noise of the mathematically zero
  key-bias gradients into steps of the learning rate's size (JAX
  ``tests/test_seq_parallel.py:35``), so two summation orders of the same
  math end 6 steps apart by ~1e-3 relative (the port's own dense run and
  its ``-sp 2`` run from one seed differ by 8e-4).

Without a spawn: the (1, 1) mesh's engine against ``SyncEngine`` (the
card's sp = 1 path, on a 1-rank gloo group), and the errors of the mode.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

LR = 0.1
STEPS, BATCH, SEQ, VOCAB = 2, 8, 16, 64
PARAMS_ATOL, DENSE_ATOL, LOSS_RTOL = 1e-5, 2e-5, 1e-5
GPT = dict(hidden=32, layers=1, heads=4, ffn=64, max_len=SEQ,
           dropout_rate=0.0)
BERT = dict(num_classes=2, vocab_size=VOCAB, hidden=32, layers=1, heads=2,
            ffn=64, max_len=SEQ, dropout_rate=0.0)
CASES = {
    "gpt_ring": dict(kind="gpt", impl="ring"),
    "gpt_ring_flash": dict(kind="gpt", impl="ring_flash"),
    "gpt_ulysses": dict(kind="gpt", impl="ulysses"),
    "gpt_rope_gqa": dict(kind="gpt", impl="ring",
                         model=dict(positional="rope", kv_heads=2)),
    "gpt_accum": dict(kind="gpt", impl="ring", grad_accum=2),
    "gpt_remat": dict(kind="gpt", impl="ring", model=dict(remat=True)),
    "bert_ring": dict(kind="bert_tiny", impl="ring"),
}
EVALUATED = ("gpt_ring", "bert_ring")
CLI_ARGV = ["-m", "c", "-cs", "sync", "-n", "2", "-sp", "2", "-b", "4",
            "--model", "gpt_tiny", "--dataset", "lm_synth", "--attention",
            "ring", "--model-arg", "hidden=32", "--model-arg", "layers=1",
            "--model-arg", "heads=2", "--model-arg", "ffn=64",
            "--model-arg", "max_len=16", "--log-every", "0"]


def _model_kw(case):
    kw = dict(GPT, num_classes=VOCAB) if case["kind"] == "gpt" else dict(BERT)
    kw.update(case.get("model", {}))
    return kw


def _data(kind):
    """STEPS global batches and a test split: next-token pairs for the GPT,
    padded token rows with binary labels for BERT."""
    rng = np.random.default_rng(1)
    rows = BATCH * STEPS
    if kind == "gpt":
        tok = rng.integers(0, VOCAB, (rows + BATCH, SEQ + 1)).astype(np.int32)
        x, y = tok[:, :-1], tok[:, 1:]
    else:
        x = rng.integers(1, VOCAB, (rows + BATCH, SEQ)).astype(np.int32)
        for r in range(len(x)):
            x[r, rng.integers(2, SEQ + 1):] = 0
        y = rng.integers(0, 2, len(x)).astype(np.int32)
    return x[:rows], y[:rows], x[rows:], y[rows:]


def _batches(kind):
    x, y, _, _ = _data(kind)
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(STEPS)]


def _params(model) -> dict:
    return {k: v.detach().clone().numpy()
            for k, v in model.state_dict().items()}


def _sgd(params):
    return torch.optim.SGD(params, lr=LR)


def _port_run(case, init, mesh=None, impl=None, evaluate=False):
    """The port's steps from ``init``: SeqParallelEngine on ``mesh``, or
    single-device SyncEngine with ``impl`` (dense) without one.  Returns
    (each step's parameters, losses, the evaluation or None)."""
    from distributed_tensorflow_tpu_torch.engines import (
        SeqParallelEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.models import create_model

    model = create_model(case["kind"], attention_impl=impl or case["impl"],
                         device="cpu", **_model_kw(case))
    k = case.get("grad_accum", 1)
    if mesh is None:
        eng = SyncEngine(model, optimizer=_sgd, device="cpu", grad_accum=k)
    else:
        eng = SeqParallelEngine(model, optimizer=_sgd, mesh=mesh,
                                grad_accum=k)
    state = eng.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(init)
    per_step, losses = [], []
    for x, y in _batches(case["kind"]):
        state, m = eng.step(state, *eng.shard_batch(x, y))
        per_step.append(_params(state.model))
        losses.append(float(m["loss"]))
    if not evaluate:
        return per_step, losses, None
    _, _, tx, ty = _data(case["kind"])
    ev = eng.evaluate(state, tloaders.Dataset(x=tx, y=ty, num_classes=2),
                      batch_size=BATCH)
    return per_step, losses, ev


def _join(rank: int, world: int, port: int):
    torch.set_num_threads(1)
    meshlib.init_process_group("cpu", world, rank, f"tcp://127.0.0.1:{port}")


# ------------------------------------------------------------- spawn 1

def _engine_rank(rank: int, port: int, inits, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    _join(rank, 4, port)
    try:
        mesh = meshlib.create_mesh(4, device="cpu", shape=(2, 2),
                                   axis_names=("data", "seq"))
        # the rank's (data, seq) indices and what its sub-groups sum
        mine = torch.tensor([float(rank)])
        layout = [mesh.axis_index("data"), mesh.axis_index("seq"),
                  float(coll.all_reduce_sum(mine, mesh, axis="data")),
                  float(coll.all_reduce_sum(mine, mesh, axis="seq"))]
        out = {"layout": np.asarray(layout)}
        for name, case in CASES.items():
            per_step, losses, ev = _port_run(case, inits[name], mesh,
                                             evaluate=name in EVALUATED)
            out[f"{name}/losses"] = np.asarray(losses)
            if ev is not None:
                out[f"{name}/eval"] = np.asarray(
                    [ev["accuracy"], ev["loss"], ev["count"]])
            for s, p in enumerate(per_step, 1):
                out.update({f"{name}/{s}/{k}": v for k, v in p.items()})
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _jax_engine(case):
    """The JAX SeqParallelEngine of ``case`` on a (2, 2) mesh of the
    8-device CPU mesh, its initial state, and that state's weights as a
    port state_dict."""
    import jax
    import optax

    from distributed_tensorflow_tpu.engines import SeqParallelEngine
    from distributed_tensorflow_tpu.models import create_model
    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu_torch.models import convert

    to_port = (convert.gpt_state_dict if case["kind"] == "gpt"
               else convert.bert_state_dict)
    model = create_model(case["kind"], attention_impl=case["impl"],
                         **_model_kw(case))
    eng = SeqParallelEngine(
        model, optimizer=optax.sgd(LR),
        mesh=jmesh.create_mesh(4, shape=(2, 2), axis_names=("data", "seq")),
        grad_accum=case.get("grad_accum", 1))
    state = eng.init_state(jax.random.key(0), _batches(case["kind"])[0][0])
    return eng, state, to_port(jax.tree.map(np.asarray, state.params))


def _jax_steps(name, eng, state):
    """The JAX engine's steps: (each step's state_dict, losses, the
    evaluation of an ``EVALUATED`` case or None)."""
    import jax

    from distributed_tensorflow_tpu.data import loaders as jloaders
    from distributed_tensorflow_tpu_torch.models import convert

    kind = CASES[name]["kind"]
    to_port = (convert.gpt_state_dict if kind == "gpt"
               else convert.bert_state_dict)
    per_step, losses = [], []
    for x, y in _batches(kind):
        state, m = eng.step(state, *eng.shard_batch(x, y))
        per_step.append({k: v.numpy() for k, v in to_port(
            jax.tree.map(np.asarray, state.params)).items()})
        losses.append(float(m["loss"]))
    ev = None
    if name in EVALUATED:
        _, _, tx, ty = _data(kind)
        ev = eng.evaluate(state, jloaders.Dataset(x=tx, y=ty, num_classes=2),
                          batch_size=BATCH)
    return per_step, losses, ev


@pytest.fixture(scope="module")
def engine_run(tmp_path_factory):
    """The ranks start from the JAX engines' weights, and run while the
    parent steps the JAX engines."""
    engines = {name: _jax_engine(case) for name, case in CASES.items()}
    inits = {name: run[2] for name, run in engines.items()}
    out = tmp_path_factory.mktemp("seq")
    ranks = mp.spawn(_engine_rank, args=(meshlib.free_port(), inits,
                                         str(out)), nprocs=4, join=False)
    jax_runs = {name: (inits[name], *_jax_steps(name, eng, state))
                for name, (eng, state, _) in engines.items()}
    while not ranks.join():
        pass
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return jax_runs, ranks


def test_two_by_two_mesh_layout_and_groups(engine_run):
    """Rank r sits at (r // 2, r % 2), as JAX reshapes its devices; the
    data group is the column {s, 2 + s}, the seq group the row."""
    _, ranks = engine_run
    for r, got in enumerate(ranks):
        d, s = r // 2, r % 2
        assert got["layout"].tolist() == [d, s, 2 * s + 2, 4 * d + 1]


@pytest.mark.parametrize("name", list(CASES))
def test_engine_equals_jax_and_dense_every_step(engine_run, name):
    jax_runs, ranks = engine_run
    case = CASES[name]
    init, want, jlosses, _ = jax_runs[name]
    dense, dlosses, _ = _port_run(case, init, impl="dense")
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{name}/losses"], jlosses,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[f"{name}/losses"], dlosses,
                                   rtol=LOSS_RTOL)
        for s in range(STEPS):
            for k, w in want[s].items():
                g = got[f"{name}/{s + 1}/{k}"]
                np.testing.assert_allclose(g, w, rtol=0, atol=PARAMS_ATOL,
                                           err_msg=f"rank {r} {s + 1} {k}")
                np.testing.assert_allclose(g, dense[s][k], rtol=0,
                                           atol=DENSE_ATOL,
                                           err_msg=f"dense {s + 1} {k}")
    # the steps moved the weights (a zero gradient would pass the above)
    moved = max(np.abs(want[-1][k] - init[k].numpy()).max() for k in init)
    assert moved > 1e-3


@pytest.mark.parametrize("name", EVALUATED)
def test_evaluate_counts_every_token_or_example(engine_run, name):
    jax_runs, ranks = engine_run
    jev = jax_runs[name][3]
    _, _, tx, _ = _data(CASES[name]["kind"])
    count = tx.size if CASES[name]["kind"] == "gpt" else len(tx)
    for got in ranks:
        acc, loss, n = got[f"{name}/eval"]
        assert n == count == jev["count"]
        np.testing.assert_allclose([acc, loss],
                                   [jev["accuracy"], jev["loss"]],
                                   rtol=1e-5)


# ------------------------------------------------------------- spawn 2

def _small_lm(batch_size, type="train"):
    """A picklable ``dataset_fn``: 24 rows of 16 tokens over 64 ids."""
    del batch_size
    return tloaders.load_lm_dataset("lm_synth", split=type, seq_len=16,
                                    vocab_size=64, n_train=24, n_test=24)


def _cli_rank(rank: int, port: int, init, out_dir: str) -> None:
    from distributed_tensorflow_tpu_torch import cli
    from distributed_tensorflow_tpu_torch.engines import seq_parallel

    _join(rank, 2, port)
    try:
        base_init = seq_parallel.SeqParallelEngine.init_state

        def from_jax(self, *args, **kw):
            state = base_init(self, *args, **kw)
            state.model.load_state_dict(init)
            return state

        seq_parallel.SeqParallelEngine.init_state = from_jax
        summary = cli.main(CLI_ARGV + ["--device", "cpu"],
                           dataset_fn=_small_lm)
        with open(f"{out_dir}/cli{rank}.json", "w") as f:
            json.dump(summary, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, monkeypatch_module):
    from distributed_tensorflow_tpu import cli as jcli
    from distributed_tensorflow_tpu.data import loaders as jloaders
    from distributed_tensorflow_tpu.engines import seq_parallel as jsp
    from distributed_tensorflow_tpu_torch.models import convert

    import jax

    inits = []
    base = jsp.SeqParallelEngine.init_state

    def record(self, *args, **kw):
        state = base(self, *args, **kw)
        inits.append(convert.gpt_state_dict(
            jax.tree.map(np.asarray, state.params)))
        return state

    monkeypatch_module.setattr(jsp.SeqParallelEngine, "init_state", record)
    want = jcli.main(CLI_ARGV, dataset_fn=lambda b, type="train":
                     jloaders.load_lm_dataset(
                         "lm_synth", split=type, seq_len=16, vocab_size=64,
                         n_train=24, n_test=24))
    out = tmp_path_factory.mktemp("cli")
    mp.spawn(_cli_rank, args=(meshlib.free_port(), inits[0], str(out)),
             nprocs=2, join=True)
    got = [json.loads((out / f"cli{r}.json").read_text()) for r in range(2)]
    return got, want


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp_:
        yield mp_


def test_cli_two_ranks_seq_parallel_equals_jax_cli(cli_run):
    got, want = cli_run
    assert got[0]["engine"] == want["engine"] == "seq_parallel[ring]"
    for key in ("n_devices", "data_parallel", "seq_parallel",
                "global_batch", "steps"):
        assert got[0][key] == want[key], key
    assert (got[0]["n_devices"], got[0]["data_parallel"],
            got[0]["seq_parallel"]) == (2, 1, 2)
    np.testing.assert_allclose(got[0]["test_loss"], want["test_loss"],
                               rtol=2e-3)
    # every rank reports the same all-reduced evaluation
    assert got[0]["test_loss"] == got[1]["test_loss"]


# ------------------------------------------------------------- no spawn

@pytest.fixture
def one_rank_mesh():
    mesh = meshlib.create_mesh(1, device="cpu", shape=(1, 1),
                               axis_names=("data", "seq"))
    yield mesh
    mesh.close()


@pytest.mark.parametrize("impl,twin,bitwise", [
    ("ring_flash", "flash", True), ("ulysses_flash", "flash", True),
    ("ring", "dense", False), ("ulysses", "dense", True)])
def test_one_rank_engine_equals_sync_engine(one_rank_mesh, impl, twin,
                                            bitwise):
    """At sp = 1 (the card's path, here on a 1-rank gloo group) the engine
    is ``SyncEngine``'s step: the ring's merge multiplies by exactly 1, the
    all-to-all is a copy.  ``ring`` computes the dense softmax as a running
    merge, so it agrees within rounding."""
    from distributed_tensorflow_tpu_torch.engines import (
        SeqParallelEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.models import create_model

    results = []
    for name, cls in ((impl, SeqParallelEngine), (twin, SyncEngine)):
        model = create_model("gpt", num_classes=VOCAB, attention_impl=name,
                             device="cpu", **GPT)
        eng = cls(model, optimizer=_sgd, mesh=one_rank_mesh)
        state = eng.init_state(torch.Generator().manual_seed(0))
        losses = []
        for x, y in _batches("gpt"):
            state, m = eng.step(state, *eng.shard_batch(x, y))
            losses.append(float(m["loss"]))
        results.append((losses, _params(state.model)))
    (l1, p1), (l2, p2) = results
    if bitwise:
        assert l1 == l2
        for k in p1:
            np.testing.assert_array_equal(p1[k], p2[k], err_msg=k)
    else:
        np.testing.assert_allclose(l1, l2, rtol=1e-6)
        for k in p1:
            np.testing.assert_allclose(p1[k], p2[k], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_flash_under_seq_parallel_raises_as_jax():
    from distributed_tensorflow_tpu.utils import harness as jharness
    from distributed_tensorflow_tpu_torch import cli
    from distributed_tensorflow_tpu_torch.utils import harness

    with pytest.raises(ValueError) as ref:
        jharness._reject_flash_under_sp(jharness.ExperimentConfig(
            attention_impl="flash"))
    with pytest.raises(ValueError) as port:
        harness._setup(harness.ExperimentConfig(
            model="gpt_tiny", dataset="lm_synth", seq_parallel=2,
            n_devices=2, attention_impl="flash", device="cpu"))
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="single-device Pallas kernel"):
        cli.main(["--device", "cpu", "-n", "2", "-sp", "2", "--model",
                  "gpt_tiny", "--dataset", "lm_synth", "--attention",
                  "flash"])


def test_decode_under_seq_parallel_raises_as_jax():
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models import create_model as jcreate
    from distributed_tensorflow_tpu_torch.models import create_model

    jm = jcreate("gpt", num_classes=VOCAB, attention_impl="ring",
                 decode=True, **GPT)
    with pytest.raises(ValueError) as ref:
        jm.init(jax.random.key(0), jnp.zeros((1, 1), jnp.int32))
    with pytest.raises(ValueError) as port:
        create_model("gpt", num_classes=VOCAB, attention_impl="ring",
                     decode=True, device="cpu", **GPT)
    # JAX's message whole: its last sentence offers partition_model
    # decode, which the port has too (TP decode)
    assert str(port.value) == str(ref.value)


def test_generate_decodes_a_seq_parallel_model_densely():
    """``generate`` on a ring model is ``generate`` on its dense twin with
    the same weights, as JAX clones the model to dense attention."""
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.models.gpt import generate

    models = [create_model("gpt", num_classes=VOCAB, attention_impl=impl,
                           device="cpu", **GPT) for impl in ("ring", "dense")]
    for m in models:
        m.reset_parameters(torch.Generator().manual_seed(3))
    prompt = np.random.default_rng(2).integers(0, VOCAB, (2, 5))
    ring, dense = (generate(m, None, prompt, 6, greedy=True, device="cpu")
                   for m in models)
    assert torch.equal(ring, dense)


@pytest.mark.parametrize("field", ["tensor_parallel", "pipeline_parallel",
                                   "expert_parallel"])
def test_composites_raise_not_ported(field):
    from distributed_tensorflow_tpu.utils import harness as jharness
    from distributed_tensorflow_tpu_torch.utils import harness

    for sp in (1, 2):
        # every composite is ported: the pipeline's dense ones (pp×tp,
        # pp×sp, pp×tp×sp: tests/test_torch_pipeline_composite.py) and its
        # MoE ones (pp×ep, pp×ep×sp: tests/test_torch_pipeline_ep.py) reach
        # their mesh, which one process cannot hold: JAX's message for one
        # device
        extra = ({"tensor_parallel": 2} if field == "pipeline_parallel"
                 and sp == 1 else {"pipeline_parallel": 2}
                 if field != "pipeline_parallel" else {})
        kw = dict(model="gpt_tiny", dataset="lm_synth", seq_parallel=sp,
                  **{field: 2}, **extra)
        config = harness.ExperimentConfig(**kw, device="cpu")
        with pytest.raises(ValueError) as want:
            jharness._setup(jharness.ExperimentConfig(**kw, n_devices=1))
        with pytest.raises(ValueError) as got:
            harness._setup(dataclasses.replace(config, n_devices=1))
        assert str(got.value) == str(want.value)
        assert "n_devices 1 not divisible by pipeline_parallel×" in str(
            got.value)


def test_mesh_shapes_that_do_not_divide_raise():
    from distributed_tensorflow_tpu_torch.utils import harness

    with pytest.raises(ValueError, match="does not cover"):
        meshlib.create_mesh(1, device="cpu", shape=(2, 2),
                            axis_names=("data", "seq"))
    with pytest.raises(ValueError, match="does not match axes"):
        meshlib.create_mesh(device="cpu", shape=(1, 1), axis_names=("data",))
    with pytest.raises(ValueError,
                       match="n_devices 3 not divisible by seq_parallel 2"):
        harness._setup(harness.ExperimentConfig(
            model="gpt_tiny", dataset="lm_synth", seq_parallel=2,
            n_devices=3, device="cpu"))


def test_engine_checks_its_mesh_model_and_precision(one_rank_mesh):
    from distributed_tensorflow_tpu_torch.engines import SeqParallelEngine
    from distributed_tensorflow_tpu_torch.models import create_model

    def gpt(impl="ring"):
        return create_model("gpt", num_classes=VOCAB, attention_impl=impl,
                            device="cpu", **GPT)

    with pytest.raises(ValueError, match="explicit"):
        SeqParallelEngine(gpt())
    flat = dataclasses.replace(one_rank_mesh, axis_names=("data",),
                               dims=(1,))
    with pytest.raises(ValueError, match="mesh axes must be"):
        SeqParallelEngine(gpt(), mesh=flat)
    with pytest.raises(ValueError, match="attend within local blocks"):
        SeqParallelEngine(gpt("dense"), mesh=one_rank_mesh)
    with pytest.raises(ValueError, match="loss scaling"):
        SeqParallelEngine(gpt(), mesh=one_rank_mesh,
                          precision="fp16-f32master")
