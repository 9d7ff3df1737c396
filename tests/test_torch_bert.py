"""Port of ``models/bert.py`` (BASELINE config 5, BERT-tiny on
``glue_synth``) held to the JAX package through
``models/convert.py``'s ``bert_state_dict``:

* logits against flax in ``dense`` and in ``flash`` (flax's flash path runs
  the Pallas kernels in interpret mode, outside ``shard_map``), at a
  reduced size and at BERT-tiny's full width (hidden 128, 2 layers, 2
  heads, FFN 512, max_len 512) with L = 128, on padded rows and a row that
  is all padding: ``rtol=1e-5, atol=2e-5`` (f32; the two frameworks sum
  in other orders);
* a row with no valid key gets the mean of V over its 128 keys from both
  flash kernels (the JAX kernel pads no keys at L = 128), not 0;
* gradients of the mean cross-entropy against ``jax.grad`` with dropout 0:
  ``rtol=1e-4, atol=1e-6`` (the flash backward's tolerance of
  ``tests/test_flash_attention.py``, carried through two layers).  The
  attention key biases have a zero gradient in exact arithmetic (a
  per-row shift of the scores leaves the softmax unchanged), so both sides
  hold f32 noise there, held to ``atol=1e-6``;
* four ``SyncEngine`` steps from the same converted parameters on
  ``glue_synth`` rows, Adam 1e-3, against the JAX ``SyncEngine`` on a
  1-device CPU mesh: losses within ``rtol=1e-5`` (as
  ``tests/test_torch_train.py``), the key biases held to
  ``|b| <= steps * lr`` (Adam turns their noise into ±lr steps);
* the options not ported raise naming their ROADMAP item, and
  ``cli.main --device cpu`` runs config 5 and prints its JSON summary.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.data import loaders as jloaders
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models.bert import (
    BertTinyClassifier as JaxBert)
from distributed_tensorflow_tpu.parallel.mesh import create_mesh
from distributed_tensorflow_tpu_torch import cli as tcli
from distributed_tensorflow_tpu_torch.engines import SyncEngine
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.models.bert import BertTinyClassifier
from distributed_tensorflow_tpu_torch.models.convert import bert_state_dict
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("distributed_tensorflow_tpu.ops.flash_attention")

SMALL = dict(num_classes=2, vocab_size=100, hidden=32, layers=2, heads=2,
             ffn=64, max_len=32, dropout_rate=0.0)
FULL = dict(num_classes=2, vocab_size=1024)      # the published defaults
TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _padded_ids(rng, b, l, vocab):
    """Token ids with padded tails of random length, a full row 0 and an
    all-padding last row."""
    ids = rng.integers(1, vocab, (b, l)).astype(np.int32)
    for r in range(1, b - 1):
        ids[r, rng.integers(1, l):] = 0
    ids[-1] = 0
    return ids


def _pair(impl, **kw):
    """A flax BERT and its port at the same parameters."""
    jm = JaxBert(attention_impl=impl, **kw)
    params = jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32),
                     train=False)["params"]
    tm = BertTinyClassifier(attention_impl=impl, device="cpu", **kw)
    tm.load_state_dict(bert_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_flax_on_padded_rows(impl, size):
    kw, l, b = (SMALL, 16, 4) if size == "small" else (FULL, 128, 3)
    jm, params, tm = _pair(impl, **kw)
    ids = _padded_ids(np.random.default_rng(1), b, l, kw["vocab_size"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               train=False))
    got = tm(torch.from_numpy(ids)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (b, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_row_with_no_valid_key_gets_the_mean_of_v_at_bert_shape():
    """BERT's shape (head dim 64, L = 128): the JAX kernel's block is
    min(1024, 128) = 128, so it pads no key, and a row whose keys are all
    masked gets the mean of V over its 128 keys, in both frameworks."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, 128), np.float32)
    mask[1] = 0.0
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), kv_mask=jnp.asarray(mask)))
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              kv_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    mean_v = np.broadcast_to(v[1].mean(0, keepdims=True), got[1].shape)
    np.testing.assert_allclose(got[1], mean_v, **TOL)
    np.testing.assert_allclose(want[1], mean_v, **TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_loss_gradients_match_flax(impl):
    import optax

    jm, params, tm = _pair(impl, **SMALL)
    rng = np.random.default_rng(5)
    ids = _padded_ids(rng, 4, 16, 100)
    labels = rng.integers(0, 2, (4,)).astype(np.int32)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    want = bert_state_dict(jax.tree.map(np.asarray, grads))
    loss = torch.nn.functional.cross_entropy(
        tm(torch.from_numpy(ids), train=True),
        torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_sync_engine_steps_match_jax():
    """Flash on the port; the JAX engine's flash path inside ``shard_map``
    is the kernels' jnp twin."""
    kw = dict(SMALL, vocab_size=1024, max_len=128)
    x, y = jloaders.synthetic_text_classification(32, seq_len=32, seed=3)
    jeng = JaxSync(JaxBert(attention_impl="flash", **kw),
                   mesh=create_mesh(1))
    jstate = jeng.init_state(jax.random.key(0), x[:1])
    teng = SyncEngine(BertTinyClassifier(attention_impl="flash",
                                         device="cpu", **kw), device="cpu")
    tstate = teng.init_state(torch.Generator().manual_seed(0))
    tstate.model.load_state_dict(bert_state_dict(
        jax.tree.map(np.asarray, jstate.params)))
    for i in range(4):
        bx, by = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        jstate, jm = jeng.step(jstate, *jeng.shard_batch(bx, by))
        tstate, tm = teng.step(tstate, *teng.shard_batch(bx, by))
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
    want = bert_state_dict(jax.tree.map(np.asarray, jstate.params))
    for name, p in tstate.model.state_dict().items():
        if name.endswith("attn.key.bias"):
            for b in (p, want[name]):
                assert float(b.abs().max()) <= 4 * 1e-3 * (1 + 1e-3), name
        else:
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=2e-6, err_msg=name)


def test_embedding_and_options_checks():
    tm = BertTinyClassifier(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len=32"):
        tm(torch.ones((1, 33), dtype=torch.int64))
    # ported since: the tensor-parallel layout (a MoE layer's experts stay
    # whole, as in JAX, unless partition_experts), and its composite with
    # sequence parallelism, which needs the mesh CompositeEngine binds
    for kw in (dict(moe_experts=2, partition_model=True),
               dict(partition_model=True)):
        assert BertTinyClassifier(**SMALL, **kw,
                                  device="cpu").partition_model
    with pytest.raises(ValueError, match="no mesh bound"):
        BertTinyClassifier(**SMALL, partition_model=True,
                           attention_impl="ring", device="cpu")(
            torch.ones((1, 4), dtype=torch.int64))
    # the sequence-parallel attentions are ported: they need the mesh
    # SeqParallelEngine binds
    for impl in ("ring", "ring_flash", "ulysses", "ulysses_flash"):
        with pytest.raises(ValueError, match="no mesh bound"):
            BertTinyClassifier(**SMALL, attention_impl=impl, device="cpu")(
                torch.ones((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="unknown attention_impl"):
        BertTinyClassifier(**SMALL, attention_impl="sparse", device="cpu")
    with pytest.raises(ValueError, match="remat \\+ MoE layers"):
        BertTinyClassifier(**SMALL, remat=True, moe_experts=2, device="cpu")
    for name in ("bert_tiny", "bert"):
        m = create_model(name, device="cpu")
        assert type(m) is BertTinyClassifier
        assert (m.hidden, m.layers, m.heads, m.ffn, m.max_len,
                m.vocab_size) == (128, 2, 2, 512, 512, 8192)


def test_cli_runs_config_5_on_the_cpu(capsys):
    summary = tcli.main(["-m", "c", "-cs", "sync", "-n", "1", "-b", "32",
                         "--model", "bert_tiny", "--dataset", "glue_synth",
                         "--attention", "flash", "--device", "cpu",
                         "--log-every", "0"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == summary
    assert (summary["model"], summary["dataset"], summary["steps"],
            summary["global_batch"]) == ("bert_tiny", "glue_synth", 128, 32)
    assert summary["test_accuracy"] >= 0.95, summary
