"""Port of the GPT training path — ``data/``, ``engines/base.py``,
``engines/sync.py``, ``engines/allreduce.py`` — held to the JAX package at
a small size (vocab 64, hidden 32, 2 layers, 4 heads, kv_heads 2, ffn 64,
L 32, f32, dropout 0, flash attention):

* the LM datasets and batches are byte-equal to the JAX package's;
* four ``SyncEngine`` steps from the same converted parameters, Adam 1e-3,
  against the JAX ``SyncEngine`` on a 1-device CPU mesh (whose flash path
  inside ``shard_map`` is the kernels' jnp twin): per-step loss and accuracy
  within ``rtol=1e-5``, final parameters within ``rtol=1e-4, atol=2e-6``
  (f32 gradients agree to ~1e-6 relative; Adam's per-element normalisation
  ``m / (sqrt(v) + 1e-8)`` passes that on to updates of size ~lr).  The
  attention key biases are the exception: their gradient is zero in exact
  arithmetic (a per-row shift of the scores leaves the softmax unchanged),
  so Adam turns each side's f32 rounding noise into steps of ±lr with
  unrelated signs; they are held only to ``|b| <= steps * lr``;
* ``grad_accum=2`` against K = 1 on the same batch;
* ``Trainer.fit`` for two epochs and ``Trainer.evaluate`` against the JAX
  Trainer's;
* options not ported raise ``NotImplementedError`` naming their ROADMAP
  item, the ported checkpoint, watchdog, ``should_stop`` and data-state
  options run, and the port (its checkpoint, failure and elastic modules
  included) imports no JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.data import loaders as jloaders
from distributed_tensorflow_tpu.data import pipeline as jpipeline
from distributed_tensorflow_tpu.engines.allreduce import Trainer as JaxTrainer
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu.parallel.mesh import create_mesh
from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.data import pipeline as tpipeline
from distributed_tensorflow_tpu_torch.engines import (
    AsyncLocalEngine, FSDPEngine, GossipEngine, SyncEngine, Trainer,
    create_engine)
from distributed_tensorflow_tpu_torch.engines.base import (
    cross_entropy, token_weights)
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.models.convert import gpt_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0, attention_impl="flash")
METRIC = dict(rtol=1e-5, atol=0)
PARAMS = dict(rtol=1e-4, atol=2e-6)
REPO = Path(__file__).resolve().parent.parent


def _lm(n, split="train", seed=3):
    return jloaders.synthetic_lm(n, seq_len=32, vocab_size=64, seed=seed,
                                 split=split)


def _jax_engine():
    return JaxSync(JaxGPT(**SMALL), mesh=create_mesh(1))


def _port_engine(**kw):
    return SyncEngine(GPTLM(**SMALL, device="cpu"), device="cpu", **kw)


def _load_jax_params(state, jax_state):
    """Overwrite the port state's parameters with the JAX state's (in place,
    so the optimizer keeps tracking the same tensors)."""
    state.model.load_state_dict(gpt_state_dict(
        jax.tree.map(np.asarray, jax_state.params)))


def _assert_params_close(model, jax_params, steps, lr=1e-3, **tol):
    want = gpt_state_dict(jax.tree.map(np.asarray, jax_params))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith("attn.key.bias"):      # zero gradient: see above
            for b in (got[name], w):
                assert float(b.abs().max()) <= steps * lr * (1 + 1e-3), name
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   err_msg=name, **tol)


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("split", ["train", "test"])
def test_lm_datasets_are_byte_equal(split):
    a = tloaders.synthetic_lm(40, seq_len=16, vocab_size=50, seed=7,
                              split=split)
    b = jloaders.synthetic_lm(40, seq_len=16, vocab_size=50, seed=7,
                              split=split)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    ta = tloaders.load_lm_dataset("lm_synth", split=split, seq_len=16,
                                  n_train=24, n_test=12)
    ja = jloaders.load_lm_dataset("lm_synth", split=split, seq_len=16,
                                  n_train=24, n_test=12)
    assert ta.x.tobytes() == ja.x.tobytes()
    assert ta.y.tobytes() == ja.y.tobytes()
    assert (ta.num_classes, ta.name, ta.synthetic, len(ta)) == (
        ja.num_classes, ja.name, ja.synthetic, len(ja))
    td, jd = tloaders.load_dataset("lm", split), jloaders.load_dataset(
        "lm", split)
    assert td.x.tobytes() == jd.x.tobytes() and td.num_classes == 128


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=5, epoch=2, drop_remainder=False),
    dict(shuffle=True, seed=5, epoch=0, drop_remainder=True),
    dict(shuffle=False, start_batch=1),
])
def test_batches_are_byte_equal(kw):
    x, y = _lm(22)
    got = list(tpipeline.iter_batches(x, y, 8, **kw))
    want = list(jpipeline.iter_batches(x, y, 8, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ds_t = tloaders.Dataset(x=x, y=y, num_classes=64)
    ds_j = jloaders.Dataset(x=x, y=y, num_classes=64)
    for g, w in zip(ds_t.batches(8, **kw), ds_j.batches(8, **kw)):
        assert all(a.tobytes() == b.tobytes() for a, b in zip(g, w))
    assert tpipeline.steps_per_epoch(22, 8) == jpipeline.steps_per_epoch(
        22, 8) == 3


# ---------------------------------------------------------------- engine

def test_loss_helpers_match_optax():
    import optax

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 5)).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    w = token_weights(torch.tensor([1.0, 0.0]), torch.from_numpy(labels))
    assert w.shape == (2, 5) and float(w.sum()) == 5.0


def test_sync_engine_four_steps_match_jax():
    x, y = _lm(32)
    jeng = _jax_engine()
    jstate = jeng.init_state(jax.random.key(0), x[:1])
    teng = _port_engine()
    tstate = teng.init_state(torch.Generator().manual_seed(0))
    _load_jax_params(tstate, jstate)
    for i in range(4):
        bx, by = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        jstate, jm = jeng.step(jstate, *jeng.shard_batch(bx, by))
        tstate, tm = teng.step(tstate, *teng.shard_batch(bx, by))
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **METRIC)
    assert tstate.step == int(jstate.step) == 4
    _assert_params_close(tstate.model, jstate.params, 4, **PARAMS)


def test_grad_accum_matches_single_batch_step():
    """The accumulated gradient (left in ``.grad`` by the step) equals the
    full batch's: the mean of two equal halves' means."""
    x, y = _lm(8, seed=4)
    metrics, grads = [], []
    for k in (1, 2):
        eng = _port_engine(grad_accum=k)
        state = eng.init_state(torch.Generator().manual_seed(1))
        state, m = eng.step(state, *eng.shard_batch(x, y))
        metrics.append({kk: float(v) for kk, v in m.items()})
        grads.append({n: p.grad.clone()
                      for n, p in state.model.named_parameters()})
    np.testing.assert_allclose(metrics[1]["loss"], metrics[0]["loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(metrics[1]["accuracy"],
                               metrics[0]["accuracy"], rtol=1e-6)
    for name, g in grads[0].items():
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        eng.step(state, *eng.shard_batch(x[:7], y[:7]))
    with pytest.raises(ValueError, match="grad_accum"):
        _port_engine(grad_accum=0)


def test_trainer_fit_and_evaluate_match_jax():
    x, y = _lm(32)
    tx_, ty_ = _lm(13, split="test")
    j_train = jloaders.Dataset(x=x, y=y, num_classes=64, name="lm_synth")
    j_test = jloaders.Dataset(x=tx_, y=ty_, num_classes=64, name="lm_synth")
    t_train = tloaders.Dataset(x=x, y=y, num_classes=64, name="lm_synth")
    t_test = tloaders.Dataset(x=tx_, y=ty_, num_classes=64, name="lm_synth")

    jt = JaxTrainer(None, engine=_jax_engine(), seed=0)
    jt.state = jt.engine.init_state(jax.random.key(0), x[:1])
    tt = Trainer(None, engine=_port_engine(), seed=0)
    tt.state = tt.engine.init_state(torch.Generator().manual_seed(0))
    _load_jax_params(tt.state, jt.state)

    logs = {"jax": [], "port": []}
    jr = jt.fit(j_train, epochs=2, batch_size=8, log_every=2,
                log_fn=logs["jax"].append)
    tr = tt.fit(t_train, epochs=2, batch_size=8, log_every=2,
                log_fn=logs["port"].append)
    assert tr["steps"] == jr["steps"] == 8
    assert tr["examples"] == jr["examples"] == 64
    assert tr["steps_per_call"] == jr["steps_per_call"] == 8
    assert tr["prefetch_depth"] == jr["prefetch_depth"] == 2
    assert tr["chunk_sizes"] == jr["chunk_sizes"] == [4]
    assert tr["start_step"] == 0
    assert set(tr) <= set(jr), set(tr) - set(jr)
    assert {"elapsed", "steps", "epochs", "examples", "examples_per_sec",
            "step_time", "start_step", "final_loss",
            "final_accuracy"} <= set(tr)
    assert set(tr["step_time"]) == set(jr["step_time"])
    assert len(tt.history) == 1 and tt.history[0] is tr
    assert len(logs["port"]) == len(logs["jax"]) == 4
    for a, b in zip(logs["port"], logs["jax"]):
        assert a.split()[1] == b.split()[1]            # step number
        np.testing.assert_allclose(float(a.split()[3]), float(b.split()[3]),
                                   atol=1e-4)           # 4-decimal loss
    for key in ("final_loss", "final_accuracy"):
        np.testing.assert_allclose(tr[key], jr[key], **METRIC)

    je = jt.evaluate(j_test, batch_size=5)               # 13 rows: padded
    te = tt.evaluate(t_test, batch_size=5)
    assert set(te) == set(je) and te["count"] == je["count"] == 13 * 32
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(te[key], je[key], **METRIC)


def test_trainer_initializes_state_from_seed():
    x, y = _lm(16, seed=6)
    ds = tloaders.Dataset(x=x, y=y, num_classes=64)
    runs = []
    for _ in range(2):
        tr = Trainer(GPTLM(**SMALL, device="cpu"), seed=3, device="cpu")
        r = tr.fit(ds, epochs=1, batch_size=8, log_every=0, max_steps=1)
        runs.append((r["steps"], r["final_loss"]))
        assert tr.state.step == 1
    assert runs[0] == runs[1] and runs[0][0] == 1


# ---------------------------------------------------------- not ported

def test_unported_options_raise(tmp_path):
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    from distributed_tensorflow_tpu_torch.utils.failure import Watchdog

    model = GPTLM(**SMALL, device="cpu")
    # ported since: the gradient codecs and bucketing, in every engine
    for kw, name, bucket_mb in ((dict(grad_compression="bf16"), "bf16", 0),
                                (dict(grad_bucket_mb=4.0), "none", 4.0),
                                (dict(grad_compression="int8"), "int8", 0)):
        for cls in (SyncEngine, AsyncLocalEngine, GossipEngine):
            codec = cls(model, device="cpu", **kw).grad_codec
            assert codec.name == name, (cls, kw)
            assert getattr(codec, "bucket_mb", 0) == bucket_mb, (cls, kw)
    # ported since: fsdp
    for name, cls in (("async", AsyncLocalEngine), ("gossip", GossipEngine),
                      ("fsdp", FSDPEngine)):
        assert type(create_engine(name, model, device="cpu")) is cls
    with pytest.raises(KeyError):
        create_engine("nope", model, device="cpu")
    assert isinstance(create_engine("allreduce", model, device="cpu"),
                      SyncEngine)
    x, y = _lm(8)
    ds = tloaders.Dataset(x=x, y=y, num_classes=64)
    trainer = Trainer(model, device="cpu")
    # ported since: the roofline and the health policy (JAX's value check)
    from distributed_tensorflow_tpu_torch.observability import Roofline

    other = Trainer(GPTLM(**SMALL, device="cpu"), device="cpu")
    r = other.fit(ds, batch_size=8, log_every=0, max_steps=1,
                  roofline=Roofline(None), on_anomaly="halt")
    assert r["train_mfu"] is None and r["roofline_peak_table_revision"]
    with pytest.raises(ValueError, match="on_anomaly must be 'warn' or "
                       "'halt', got 'stop'"):
        other.fit(ds, batch_size=8, on_anomaly="stop")
    # ported since: the telemetry sinks and the straggler detector
    from distributed_tensorflow_tpu_torch.elastic import StragglerDetector
    from distributed_tensorflow_tpu_torch.observability import (
        Timeline, Tracer)
    from distributed_tensorflow_tpu_torch.utils.metrics import MetricsLogger

    r = Trainer(GPTLM(**SMALL, device="cpu"), device="cpu").fit(
                    ds, batch_size=8, log_every=0, max_steps=1,
                    metrics_logger=MetricsLogger(), tracer=Tracer(),
                    straggler_detector=StragglerDetector(),
                    timeline=Timeline(interval_s=0.0))
    assert r["steps"] == 1 and r["stragglers"]["observed"] == 1
    # ported since: the checkpoint manager and its cadence, the watchdog,
    # should_stop and the data state
    with Watchdog(timeout=30.0) as wd:
        for kw, key, want in (
                (dict(checkpoint_manager=CheckpointManager(tmp_path)),
                 "checkpoint_async", False),
                (dict(checkpoint_manager=CheckpointManager(tmp_path),
                      checkpoint_every=1), "checkpoint_async", False),
                (dict(watchdog=wd), "watchdog_stalls", 0),
                (dict(should_stop=lambda s: "stop"), "preempted", "stop")):
            assert trainer.fit(ds, batch_size=8, log_every=0,
                               max_steps=1, **kw)[key] == want
    # a data state that does not match: the stream restarts, and the steps
    # trained before count as replayed
    r = trainer.fit(ds, batch_size=8, log_every=0, max_steps=1,
                    data_state={}, log_fn=lambda line: None)
    assert r["resume_replay_steps"] == r["start_step"] == 4
    for kw in (dict(prefetch=0), dict(steps_per_call=0),
               dict(target_accuracy=0.5)):
        with pytest.raises(ValueError):
            trainer.fit(ds, batch_size=8, **kw)
    with pytest.raises(NotImplementedError, match="native"):
        ds.batches(8, native=True)
    # the MoE classifier and its expert layouts are ported; the 2-D one
    # needs the expert cut first, as in JAX
    assert create_model("moe", partition_experts=True,
                        device="cpu").moe[0].partition_experts
    with pytest.raises(ValueError, match="requires partition_experts"):
        create_model("moe", partition_model=True, device="cpu")
    with pytest.raises(KeyError):
        tloaders.load_dataset("nope")


def test_training_path_imports_no_jax():
    code = (
        "import sys\n"
        "import distributed_tensorflow_tpu_torch.engines\n"
        "import distributed_tensorflow_tpu_torch.data\n"
        "import distributed_tensorflow_tpu_torch.data.device_prefetch\n"
        "import distributed_tensorflow_tpu_torch.models\n"
        "import distributed_tensorflow_tpu_torch.models.convert\n"
        "import distributed_tensorflow_tpu_torch.ops.flash_attention\n"
        "import distributed_tensorflow_tpu_torch.parallel.mesh\n"
        "import distributed_tensorflow_tpu_torch.parallel.collectives\n"
        "import distributed_tensorflow_tpu_torch.parallel.compression\n"
        "import distributed_tensorflow_tpu_torch.parallel.overlap\n"
        "import distributed_tensorflow_tpu_torch.utils.metrics\n"
        "import distributed_tensorflow_tpu_torch.utils.wire\n"
        "import distributed_tensorflow_tpu_torch.utils.supervisor\n"
        "import distributed_tensorflow_tpu_torch.utils.harness\n"
        "import distributed_tensorflow_tpu_torch.utils.checkpoint\n"
        "import distributed_tensorflow_tpu_torch.utils.failure\n"
        "import distributed_tensorflow_tpu_torch.elastic\n"
        "import distributed_tensorflow_tpu_torch.elastic.reshard\n"
        "import distributed_tensorflow_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'distributed_tensorflow_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
