"""Port of the reference's own training path — the image/text datasets,
``models/{mlp,cnn}.py``, ``SyncEngine`` on a mesh, the ``Trainer``'s
drain, prefetch and early stop, ``utils/{wire,supervisor,harness}.py`` and
``cli.py`` — held to the JAX package at small sizes:

* datasets byte-equal to JAX's for every name (synthetic fallbacks, a
  local ``mnist.npz``, a CIFAR batch directory, the Keras cache under
  ``~/.keras/datasets``), and ``shard``/``process_shard_of``;
* MLP and CNN logits (eval mode, B=4) from parameters carried over by
  ``convert.py`` within ``rtol=atol=1e-5`` of flax at f32, and one-step
  gradients within ``rtol=1e-4, atol=1e-6`` of ``jax.grad`` (f32 sums in
  other orders; the CNN's 3×3 convolutions and the 3136-wide Dense add the
  most terms);
* four ``SyncEngine`` steps with dropout 0 against the JAX ``SyncEngine``
  on a 1-device mesh, SGD and Adam, MLP and CNN: per-step losses within
  ``rtol=1e-5``; parameters within ``atol=1e-5`` under SGD (linear in the
  gradient, so a wrong scale shows) and ``rtol=1e-4, atol=2e-6`` under
  Adam (its per-element normalisation passes f32 noise on to updates of
  size ~lr); SGD also on a 1-rank gloo mesh, the path NCCL takes on the
  card;
* the Trainer: ``steps_per_call`` 8 bitwise equal to 1 (losses and
  parameters, dropout on), prefetch depths 1 and 2 equal, the
  target-accuracy stop and ``steps_to_accuracy`` as the JAX tests expect,
  ``DevicePrefetch``'s counters equal to JAX's;
* the CLI: the reference flag surface, the mode → engine mapping of JAX
  ``select_engine``, the summary keys of the JAX summary, unported modes
  and models raising with their ROADMAP item, and ``grad_accum`` on the
  async and gossip engines raising JAX's ``ValueError``;
* the wire bytes and the supervisor's event triple against JAX's.
"""

import dataclasses
import pickle
import socket
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from distributed_tensorflow_tpu import cli as jcli
from distributed_tensorflow_tpu.data import loaders as jloaders
from distributed_tensorflow_tpu.data.device_prefetch import (
    DevicePrefetch as JaxPrefetch)
from distributed_tensorflow_tpu.engines.allreduce import Trainer as JaxTrainer
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models.cnn import CNN as JaxCNN
from distributed_tensorflow_tpu.models.mlp import MLP as JaxMLP
from distributed_tensorflow_tpu.parallel.mesh import create_mesh as jax_mesh
from distributed_tensorflow_tpu.utils import supervisor as jsupervisor
from distributed_tensorflow_tpu.utils import wire as jwire
from distributed_tensorflow_tpu_torch import cli as tcli
from distributed_tensorflow_tpu_torch import models as tmodels
from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.data.device_prefetch import (
    DevicePrefetch)
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.models import create_model, get_model_fn
from distributed_tensorflow_tpu_torch.models.cnn import CNN
from distributed_tensorflow_tpu_torch.models.convert import (
    cnn_state_dict, mlp_state_dict)
from distributed_tensorflow_tpu_torch.models.mlp import MLP, dropout
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.utils import harness as tharness
from distributed_tensorflow_tpu_torch.utils import supervisor as tsupervisor
from distributed_tensorflow_tpu_torch.utils import wire as twire
from distributed_tensorflow_tpu_torch.utils.harness import (
    ExperimentConfig, steps_to_accuracy)

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

LOGITS = dict(rtol=1e-5, atol=1e-5)
GRADS = dict(rtol=1e-4, atol=1e-6)
METRIC = dict(rtol=1e-5, atol=0)
SGD_PARAMS = dict(rtol=0, atol=1e-5)
ADAM_PARAMS = dict(rtol=1e-4, atol=2e-6)

# narrow widths of the two models (the registry's defaults are checked
# once at full width in test_model_logits_match_flax)
NARROW = {
    "mlp": (dict(num_classes=10, hidden=32), JaxMLP, MLP, mlp_state_dict),
    "cnn": (dict(num_classes=10, features=(8, 16), dense=32), JaxCNN, CNN,
            cnn_state_dict),
}


def _images(n, shape=(12, 12, 1), seed=3, split="train"):
    x, y = jloaders.synthetic_classification(shape[:2], 10, n, seed=seed,
                                             split=split)
    return x.reshape((n, *shape)), y


def _convert(to_sd, params):
    return to_sd(jax.tree.map(np.asarray, params))


def _port_model(name, dropout_rate=0.0, **extra):
    kw, _, cls, _ = NARROW[name]
    return cls(**kw, dropout_rate=dropout_rate, device="cpu", **extra)


def _jax_model(name, dropout_rate=0.0):
    kw, cls, _, _ = NARROW[name]
    return cls(**kw, dropout_rate=dropout_rate)


@pytest.fixture
def no_data_dirs(tmp_path, monkeypatch):
    """No local dataset anywhere on the search path (both packages then
    take the synthetic arrays)."""
    monkeypatch.delenv("DTF_TPU_DATA_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _same_dataset(a, b):
    assert a.x.dtype == b.x.dtype and a.x.shape == b.x.shape
    assert a.x.tobytes() == b.x.tobytes()
    assert a.y.dtype == b.y.dtype and a.y.tobytes() == b.y.tobytes()
    assert (a.num_classes, a.name, a.synthetic) == (
        b.num_classes, b.name, b.synthetic)


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("shape,split", [((28, 28), "train"),
                                         ((32, 32, 3), "test"),
                                         ((4, 4), "test")])
def test_synthetic_classification_byte_equal(shape, split):
    a = tloaders.synthetic_classification(shape, 10, 50, seed=11,
                                          split=split)
    b = jloaders.synthetic_classification(shape, 10, 50, seed=11,
                                          split=split)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_synthetic_text_classification_byte_equal():
    for split in ("train", "test"):
        a = tloaders.synthetic_text_classification(20, seq_len=16,
                                                   vocab_size=50, seed=4,
                                                   split=split)
        b = jloaders.synthetic_text_classification(20, seq_len=16,
                                                   vocab_size=50, seed=4,
                                                   split=split)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    _same_dataset(tloaders.load_text_dataset("glue_synth", "test",
                                             n_test=8),
                  jloaders.load_text_dataset("glue_synth", "test", n_test=8))


@pytest.mark.parametrize("name", ["synthetic", "mnist", "fashion_mnist",
                                  "cifar10", "glue_synth"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_dataset_fallback_byte_equal(no_data_dirs, name, split):
    a = tloaders.load_dataset(name, split)
    b = jloaders.load_dataset(name, split)
    _same_dataset(a, b)
    assert a.synthetic
    if name != "glue_synth":
        assert len(a) == (8192 if split == "train" else 2048)
    assert tloaders.load_dataset(name, split, reshape=False).x.shape == \
        jloaders.load_dataset(name, split, reshape=False).x.shape


def _write_mnist(path, n=6):
    rng = np.random.default_rng(5)
    np.savez(path, x_train=rng.integers(0, 256, (n, 28, 28), np.uint8),
             y_train=rng.integers(0, 10, n, np.uint8),
             x_test=rng.integers(0, 256, (n // 2, 28, 28), np.uint8),
             y_test=rng.integers(0, 10, n // 2, np.uint8))


def test_local_npz_and_cifar_batches(no_data_dirs, monkeypatch):
    data = no_data_dirs / "data"
    data.mkdir()
    _write_mnist(data / "mnist.npz")
    _write_mnist(data / "fashion-mnist.npz", n=4)
    cifar = data / "cifar-10-batches-py"
    cifar.mkdir()
    rng = np.random.default_rng(6)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), np.uint8),
                         b"labels": list(rng.integers(0, 10, 3))}, f)
    monkeypatch.setenv("DTF_TPU_DATA_DIR", str(data))
    for name in ("mnist", "fashion_mnist", "cifar10"):
        for split in ("train", "test"):
            a = tloaders.load_dataset(name, split)
            _same_dataset(a, jloaders.load_dataset(name, split))
            assert not a.synthetic
    assert tloaders.load_dataset("cifar10").x.shape == (15, 32, 32, 3)
    assert tloaders.load_dataset("mnist", reshape=False).x.shape == (6, 28, 28)


def test_keras_cache_is_searched(no_data_dirs):
    """``~/.keras/datasets`` — where Keras caches ``mnist.npz`` — is on
    the search path of both packages."""
    keras = no_data_dirs / "home" / ".keras" / "datasets"
    keras.mkdir(parents=True)
    _write_mnist(keras / "mnist.npz")
    a = tloaders.load_dataset("mnist")
    _same_dataset(a, jloaders.load_dataset("mnist"))
    assert not a.synthetic and len(a) == 6
    assert tloaders._search_dirs() == jloaders._search_dirs()


def test_shard_and_process_shard():
    x, y = _images(11)
    t = tloaders.Dataset(x=x, y=y, num_classes=10, name="s")
    j = jloaders.Dataset(x=x, y=y, num_classes=10, name="s")
    for args in ((3, 1), (3, 2, True), (2, 0, True)):
        _same_dataset(t.shard(*args), j.shard(*args))
    ts, js = t.process_shard_of(2, 1), j.process_shard_of(2, 1)
    _same_dataset(ts, js)
    assert ts.process_shard == js.process_shard == (1, 2)
    tb, jb = t.with_batching(4), j.with_batching(4)
    assert (tb.batch_size, tb.buffer_size) == (jb.batch_size, jb.buffer_size)
    for g, w in zip(tb.batches(shuffle=True, seed=2),
                    jb.batches(shuffle=True, seed=2, native=False)):
        assert all(u.tobytes() == v.tobytes() for u, v in zip(g, w))
    with pytest.raises(ValueError, match="batch_size"):
        t.batches()


# --------------------------------------------------------------- models

@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_model_logits_match_flax(name):
    """The registry's full-width models at MNIST's shape (the CNN's first
    Dense reads its 3136 inputs in flax's NHWC order)."""
    x, _ = _images(4, (28, 28, 1), seed=1)
    jm = {"mlp": JaxMLP, "cnn": JaxCNN}[name]()
    params = jm.init(jax.random.key(0), jnp.asarray(x), train=False)["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               train=False))
    tm = create_model(name, device="cpu")
    assert isinstance(get_model_fn(name, device="cpu")(), type(tm))
    tm.load_state_dict(_convert({"mlp": mlp_state_dict,
                                 "cnn": cnn_state_dict}[name], params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
        got3 = tm(torch.from_numpy(x[..., 0]), train=False)   # (B, H, W)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, **LOGITS)
    np.testing.assert_allclose(got3.numpy(), want, **LOGITS)


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_one_step_gradients_match_jax(name):
    x, y = _images(6)
    _, _, _, to_sd = NARROW[name]
    jm = _jax_model(name)
    params = jm.init(jax.random.key(1), jnp.asarray(x), train=False)["params"]

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.key(0)})
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    want = _convert(to_sd, jax.grad(loss)(params))
    tm = _port_model(name)
    tm.load_state_dict(_convert(to_sd, params))
    from distributed_tensorflow_tpu_torch.engines.base import cross_entropy

    cross_entropy(tm(torch.from_numpy(x), train=True),
                  torch.from_numpy(y)).mean().backward()
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   err_msg=pname, **GRADS)


def test_dropout_rate_and_streams():
    """Dropout streams differ from flax's by construction (torch against
    JAX bits); the rate, the scale and the stream's keys are held here."""
    x = torch.ones(400, 500)
    for rate in (0.2, 0.25):
        out = dropout(x, rate, True, torch.Generator().manual_seed(0))
        dropped = float((out == 0).float().mean())
        # 200k Bernoulli draws: 5 standard deviations ≈ 0.0045
        assert abs(dropped - rate) < 5e-3, (rate, dropped)
        assert torch.allclose(out[out != 0], torch.tensor(1 / (1 - rate)))
    assert dropout(x, 0.2, False, None) is x
    eng = SyncEngine(_port_model("mlp", dropout_rate=0.2), device="cpu")
    state = eng.init_state(torch.Generator().manual_seed(0), _images(1)[0])

    def mask(step):
        state.step = step
        return dropout(x, 0.2, True, eng.step_generator(state))

    assert torch.equal(mask(3), mask(3))
    assert not torch.equal(mask(3), mask(4))


# --------------------------------------------------------------- engine

@pytest.mark.parametrize("name,opt,mesh", [
    ("mlp", "sgd", None), ("cnn", "sgd", None), ("mlp", "adam", None),
    ("cnn", "adam", None), ("cnn", "sgd", "gloo")])
def test_sync_engine_trajectory_matches_jax(name, opt, mesh):
    x, y = _images(32)
    _, _, _, to_sd = NARROW[name]
    jtx, tx = {"sgd": (optax.sgd(0.1),
                       lambda p: torch.optim.SGD(p, lr=0.1)),
               "adam": (optax.adam(1e-3),
                        lambda p: torch.optim.Adam(p, lr=1e-3))}[opt]
    jeng = JaxSync(_jax_model(name), optimizer=jtx, mesh=jax_mesh(1))
    jstate = jeng.init_state(jax.random.key(0), x[:1])
    tmesh_ = tmesh.create_mesh(1, device="cpu") if mesh else None
    try:
        teng = SyncEngine(_port_model(name), optimizer=tx, mesh=tmesh_,
                          device=None if mesh else "cpu")
        tstate = teng.init_state(torch.Generator().manual_seed(0), x[:1])
        tstate.model.load_state_dict(_convert(to_sd, jstate.params))
        for i in range(4):
            bx, by = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
            jstate, jm = jeng.step(jstate, *jeng.shard_batch(bx, by))
            tstate, tm = teng.step(tstate, *teng.shard_batch(bx, by))
            for key in ("loss", "accuracy"):
                np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                           err_msg=f"step {i} {key}",
                                           **METRIC)
    finally:
        if tmesh_ is not None:
            tmesh_.close()
    assert tstate.step == int(jstate.step) == 4
    want = _convert(to_sd, jstate.params)
    tol = SGD_PARAMS if opt == "sgd" else ADAM_PARAMS
    for pname, w in want.items():
        np.testing.assert_allclose(tstate.model.state_dict()[pname].numpy(),
                                   w.numpy(), err_msg=pname, **tol)


def test_mesh_close_restores_the_excepthook():
    """``init_process_group`` wraps ``sys.excepthook`` with a "[rank0]: "
    prefix; a mesh that made its group puts the old hook back on close, so
    meshes made one after another in a process stack no prefixes."""
    before = sys.excepthook
    for _ in range(2):
        m = tmesh.create_mesh(1, device="cpu")
        assert m.owns_group and sys.excepthook is not before
        m.close()
        assert sys.excepthook is before


def test_lazy_model_needs_a_sample():
    eng = SyncEngine(_port_model("cnn"), device="cpu")
    with pytest.raises(ValueError, match="sample_x"):
        eng.init_state(torch.Generator().manual_seed(0))


# -------------------------------------------------------------- trainer

def _fit(name, **kw):
    x, y = _images(48, seed=9)
    ds = tloaders.Dataset(x=x, y=y, num_classes=10, name="small")
    lines = []
    trainer = Trainer(_port_model(name, dropout_rate=0.25), seed=2,
                      device="cpu")
    result = trainer.fit(ds, epochs=2, batch_size=8, log_every=1,
                         log_fn=lines.append, **kw)
    return result, lines, trainer.state.model.state_dict()


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_steps_per_call_8_bitwise_equals_1(name):
    r1, lines1, p1 = _fit(name, steps_per_call=1)
    r8, lines8, p8 = _fit(name, steps_per_call=8)
    assert lines8 == lines1 and len(lines1) == 12
    assert (r1["chunk_sizes"], r8["chunk_sizes"]) == ([1], [6])
    assert r8["final_loss"] == r1["final_loss"]
    for key, v in p1.items():
        assert torch.equal(p8[key], v), key


def test_prefetch_depths_give_one_trajectory():
    r1, lines1, p1 = _fit("mlp", prefetch=1)
    r2, lines2, p2 = _fit("mlp", prefetch=2)
    assert lines1 == lines2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert (r1["prefetch_depth"], r2["prefetch_depth"]) == (1, 2)
    # depth 1 leaves nothing staged behind any hand-off; depth 2 finds each
    # epoch's end while a batch is still staged
    assert r1["prefetch_starvation"] == 12 and r2["prefetch_starvation"] == 0


def test_target_accuracy_stop_keys_match_jax():
    x, y = _images(64, seed=4)
    tx_, ty_ = _images(16, seed=4, split="test")
    jtrain = jloaders.Dataset(x=x, y=y, num_classes=10)
    jtest = jloaders.Dataset(x=tx_, y=ty_, num_classes=10)
    ttrain = tloaders.Dataset(x=x, y=y, num_classes=10)
    ttest = tloaders.Dataset(x=tx_, y=ty_, num_classes=10)
    kw = dict(epochs=3, batch_size=8, log_every=0, target_accuracy=0.99,
              eval_every=4)
    jr = JaxTrainer(_jax_model("mlp"), mesh=jax_mesh(1), seed=0).fit(
        jtrain, eval_ds=jtest, **kw)
    tr = Trainer(_port_model("mlp"), seed=0, device="cpu").fit(
        ttrain, eval_ds=ttest, **kw)
    assert set(tr) <= set(jr), set(tr) - set(jr)
    for r in (tr, jr):
        assert r["steps_per_call"] == 1
        assert r["steps_per_call_clamp"]["reason"] == "target_accuracy"
        assert isinstance(r["reached_target"], bool)
        if r["reached_target"]:
            assert r["eval_accuracy"] >= 0.99 and r["eval_resolution"] <= 4
        else:
            assert r["steps"] == 24 and r["eval_resolution"] is None


def test_steps_to_accuracy_step_granularity():
    cfg = ExperimentConfig(engine="sync", model="mlp", dataset="synthetic",
                           batch_size=16, learning_rate=5e-3, device="cpu")
    r = steps_to_accuracy(cfg, target=0.9, max_steps=300, eval_every=8)
    assert r["reached"], r
    assert r["steps"] % 8 == 0 and r["steps"] < 300
    assert r["step_resolution"] <= 8
    assert r["synthetic"] is True
    r = steps_to_accuracy(cfg, target=1.01, max_steps=7, eval_every=50)
    assert not r["reached"] and r["steps"] == 7
    assert r["accuracy"] > 0.0  # the cap-step eval ran


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_counters_match_jax(depth):
    def run(cls):
        pf = cls(iter(range(7)), lambda b: (b * 10,), depth=depth)
        seen = [(pf.queue_depth, pf.starvation)]
        got = [pf.take(3), [next(pf)], pf.take(5), pf.take(2)]
        seen.append((pf.queue_depth, pf.starvation, pf.consumed))
        pf.close()
        return got, seen, pf.depth

    assert run(DevicePrefetch) == run(JaxPrefetch)
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetch([], lambda b: b, depth=0)


# ------------------------------------------------------------------ CLI

def test_str2bool_parity():
    for v in ("yes", "true", "t", "y", "1", "no", "false", "f", "n", "0"):
        assert tcli.str2bool(v) is jcli.str2bool(v)
    with pytest.raises(Exception):
        tcli.str2bool("maybe")
    assert tcli.parse_model_args(["a=1", "b=0.5", "c=true", "d=x"]) == \
        jcli.parse_model_args(["a=1", "b=0.5", "c=true", "d=x"])


@pytest.mark.parametrize("argv", [
    ["-m", "c", "-cs", "sync"], ["-m", "centralized", "-cs", "async"],
    ["-m", "d", "-ds", "keras"], ["-m", "d", "-ds", "graph"],
    ["-m", "decentralized", "-ds", "custom"], ["-m", "tpu_pod"], ["-m", "t"],
    ["-m", "d", "-ds", "sync"], ["-m", "d", "-ds", "fsdp"]])
def test_mode_dispatch_matches_jax(argv):
    assert tcli.select_engine(tcli.build_parser().parse_args(argv)) == \
        jcli.select_engine(jcli.build_parser().parse_args(argv))


def test_reference_flag_surface_accepted():
    argv = ["-m", "c", "-cs", "sync", "-ds", "keras", "-n", "4", "-b", "32",
            "-ti", "0", "-ca", "y", "--model", "cnn", "--dataset", "mnist",
            "-e", "2", "--lr", "0.01", "--grad-accum", "2", "--seed", "3",
            "--log-every", "5", "--steps-per-call", "4", "--prefetch", "1",
            "--result-path", "r.jsonl", "--supervisor", "h:1",
            "--model-arg", "hidden=8", "--num-processes", "2"]
    t, j = tcli.build_parser().parse_args(argv), \
        jcli.build_parser().parse_args(argv)
    for key, value in vars(t).items():
        if key != "device":
            assert getattr(j, key) == value, key
    assert t.device == "cuda"
    with pytest.raises(SystemExit):
        tcli.main(["-tt", "worker", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcli.main(["--model-arg", "novalue", "--device", "cpu"])


@pytest.mark.parametrize("argv,exc,match", [
    # fsdp and the pipeline are ported since; JAX rejects them together
    (["-m", "d", "-ds", "fsdp", "-pp", "2"], ValueError,
     "fsdp × pipeline is rejected by design"),
    # MoE, -ep and every composite are ported; the pipeline's MoE stages
    # are the sequence families' (JAX harness.py:1338-1344)
    (["--model", "moe", "-ep", "2", "-pp", "2"], ValueError,
     r"pipeline_parallel×expert_parallel ships MoE-FFN stages for "
     r"\S*gpt\S* \(got --model moe\)"),
    (["--model", "bert_tiny", "--dataset", "glue_synth", "--model-arg",
      "attention_impl=ulysses"], ValueError, "pass -sp > 1"),
    (["--model", "bert_tiny", "--dataset", "glue_synth", "--model-arg",
      "moe_experts=2", "-ep", "2", "-sp", "2", "-pp", "2"],
     ValueError, r"pipeline_parallel×expert_parallel×seq_parallel ships "
     r"MoE-FFN stages for \S*gpt\S* \(got --model bert_tiny\)"),
    # the local engines decouple the optimizer cadence themselves (JAX
    # harness.py:712-716)
    (["-m", "c", "-cs", "async", "--grad-accum", "2"], ValueError,
     "grad_accum is implemented by the sync/allreduce/fsdp engines"),
    (["-m", "d", "-ds", "custom", "--grad-accum", "2"], ValueError,
     "grad_accum is implemented by the sync/allreduce/fsdp engines")])
def test_unported_modes_raise(argv, exc, match):
    with pytest.raises(exc, match=match):
        tcli.main(argv + ["--device", "cpu", "--log-every", "0"])


def test_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["-m", "c", "-cs", "sync", "-n", "1"])
    with pytest.raises(ValueError, match="only 0 available"):
        tmesh.check_device_count(2, "cuda")


def _jax_small(batch_size, type="train"):
    n, split = (128, "train") if type == "train" else (32, "test")
    x, y = jloaders.synthetic_classification((28, 28), 10, n, seed=7,
                                             split=split)
    return jloaders.Dataset(x=x[..., None], y=y, num_classes=10,
                            name="small", synthetic=True)


def _port_small(batch_size, type="train"):
    j = _jax_small(batch_size, type)
    return tloaders.Dataset(x=j.x, y=j.y, num_classes=10, name="small",
                            synthetic=True)


SUMMARY_KEYS = {"engine", "model", "dataset", "synthetic_data", "n_devices",
                "data_parallel", "global_batch", "epochs", "steps",
                "steps_per_call", "prefetch_depth", "elapsed_s",
                "examples_per_sec", "examples_per_sec_per_device",
                "test_accuracy", "test_loss"}


def test_cli_summary_keys_match_jax(tmp_path, capsys):
    argv = ["-m", "c", "-cs", "sync", "-n", "1", "-b", "16", "--model",
            "mlp", "--log-every", "0"]
    want = jcli.main(argv + ["--result-path", str(tmp_path / "j.jsonl")],
                     dataset_fn=_jax_small)
    got = tcli.main(argv + ["--device", "cpu", "--result-path",
                            str(tmp_path / "t.jsonl")],
                    dataset_fn=_port_small)
    assert SUMMARY_KEYS <= set(got) <= set(want), set(got) - set(want)
    assert set(got["run_report"]) <= set(want["run_report"])
    for key in ("engine", "model", "dataset", "synthetic_data", "n_devices",
                "data_parallel", "global_batch", "epochs", "steps",
                "steps_per_call", "prefetch_depth"):
        assert got[key] == want[key], key
    events = [line.split('"event": "')[1].split('"')[0] for line in
              (tmp_path / "t.jsonl").read_text().splitlines()]
    assert events == ["start", "done", "results", "run_report", "summary"]


def test_run_turns_tf32_off_and_restores_it(monkeypatch, capsys):
    """The harness computes the f32 models in full f32: TF32 is off for
    matmuls and convolutions while a run sets up and trains, and the
    caller's flags come back after it."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []

    def data(batch_size, type="train"):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return _port_small(batch_size, type)

    tcli.main(["-m", "c", "-cs", "sync", "-n", "1", "-b", "16", "--model",
               "mlp", "--log-every", "0", "--device", "cpu"], dataset_fn=data)
    assert seen == [(False, False)] * 2
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, True)


@pytest.mark.parametrize("entry", ["run", "steps_to_accuracy"])
def test_run_holds_cudnn_deterministic_and_restores_it(monkeypatch, entry):
    """One seed gives one run on the card: cuDNN takes deterministic
    algorithms and its autotuner is off while a run sets up and trains,
    and the caller's flags come back after it (also on the way out of a
    run that raises)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    seen = []

    def data(batch_size, type="train"):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark))
        return _port_small(batch_size, type)

    config = tharness.ExperimentConfig(
        engine="sync", model="mlp", n_devices=1, batch_size=16,
        log_every=0, device="cpu", dataset_fn=data)
    if entry == "run":
        tharness.run(config)
    else:
        tharness.steps_to_accuracy(config, target=2.0, max_steps=2,
                                   eval_every=1)
    assert seen and set(seen) == {(True, False)}
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == (False, True)

    def broken(batch_size, type="train"):
        raise RuntimeError("no data")

    with pytest.raises(RuntimeError, match="no data"):
        tharness.run(dataclasses.replace(config, dataset_fn=broken))
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == (False, True)


def test_plugin_model_fn_warns_that_a_non_f32_dtype_is_ignored():
    """As the JAX harness: a plug-in ``model_fn`` owns its dtype, so a
    non-f32 ``dtype`` is ignored with a warning (and f32 warns nothing)."""
    def model_fn():
        return tmodels.create_model("mlp", num_classes=10, device="cpu")

    for dtype in ("bfloat16", "float16"):
        config = tharness.ExperimentConfig(model_fn=model_fn, dtype=dtype)
        with pytest.warns(UserWarning) as caught:
            model = tharness._resolve_model(config, 10, "cpu")
        assert [str(w.message) for w in caught] == [
            f"--dtype {dtype} is ignored for plug-in model_fn models; the "
            f"model_fn owns its dtype"]
        assert next(model.parameters()).dtype == torch.float32
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tharness._resolve_model(
            tharness.ExperimentConfig(model_fn=model_fn), 10, "cpu")


# ------------------------------------------------------- wire/supervisor

@pytest.mark.parametrize("obj", ["start", ["done", 1.25],
                                 {"results": [0.97, None]}])
def test_wire_bytes_match_jax(obj):
    a, b = socket.socketpair()
    try:
        twire.send_msg(a, obj)
        assert jwire.recv_msg(b) == obj
        jwire.send_msg(b, obj)
        assert twire.recv_msg(a) == obj
        twire.send_msg(a, obj, use_pickle=True)
        assert jwire.recv_msg(b, allow_pickle=True) == obj
        a.settimeout(5.0)   # the JAX sender takes its Python path too
        jwire.send_msg(a, obj)
        raw = b.recv(1 << 16)
        c, d = socket.socketpair()
        twire.send_msg(c, obj)
        assert d.recv(1 << 16) == raw
        c.close()
        assert twire.recv_msg(d) is None     # orderly close
        d.close()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("listener_cls", [tsupervisor.SupervisorListener,
                                          jsupervisor.SupervisorListener])
def test_supervisor_event_triple(tmp_path, listener_cls):
    listener = listener_cls()
    sink = tsupervisor.ResultSink(tmp_path / "e.jsonl",
                                  supervisor_address=f"127.0.0.1:"
                                                     f"{listener.port}")
    sink.start()
    sink.done(1.5)
    sink.results(0.97, loss=0.1)
    sink.close()
    listener._thread.join(timeout=5)
    listener.close()
    assert listener.messages == ["start", ["done", 1.5], ["results", 0.97]]
    assert [e["event"] for e in sink.events] == ["start", "done", "results"]
    assert sink.events[2]["loss"] == 0.1
    assert len((tmp_path / "e.jsonl").read_text().splitlines()) == 3
