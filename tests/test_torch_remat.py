"""Remat (activation checkpointing, ``models.layers.remat``) in the GPT and
BERT ports, and the harness/CLI flags that reach it (``--remat``,
``--attention``), held to the JAX package:

* the ``state_dict`` is the same, keys and values, with remat on and off
  (flax pins the blocks' names, so one ``convert`` serves both);
* with dropout 0.1 and the same generator seed, the loss and every
  gradient are bitwise equal with remat on and off on the CPU in f32, in
  one forward/backward and over ``SyncEngine`` steps (the recompute draws
  the masks its forward drew: ``remat`` saves the generator's state
  before the block and sets it again for the recompute), and the
  generator ends where it ends without remat; with no generator passed,
  the default generator's draws are restored alike;
* each block runs once more in the backward pass (twice per step) and
  once under ``torch.no_grad``;
* the port with remat against flax with ``remat=True``, dropout 0: loss
  ``rtol=1e-6``, gradients ``rtol=1e-4, atol=1e-6`` (the tolerance of
  ``tests/test_torch_gpt.py``'s gradients, carried through two layers);
* ``--remat`` with a model that has no transformer blocks, and remat with
  MoE, raise the JAX package's messages; ``--attention`` resolves each
  model's ``attention_impl`` as the JAX harness does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models import create_model as jax_create
from distributed_tensorflow_tpu.utils import harness as jharness
from distributed_tensorflow_tpu_torch import cli as tcli
from distributed_tensorflow_tpu_torch.engines import SyncEngine
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.models.convert import (
    bert_state_dict, gpt_state_dict)
from distributed_tensorflow_tpu_torch.utils import harness as tharness

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

GPT = dict(num_classes=64, hidden=32, layers=2, heads=4, ffn=64, max_len=32)
BERT = dict(num_classes=2, vocab_size=100, hidden=32, layers=2, heads=2,
            ffn=64, max_len=32)
NAMES = {"gpt": "gpt", "bert": "bert_tiny"}
CONVERT = {"gpt": gpt_state_dict, "bert": bert_state_dict}
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _model(kind, remat, impl="dense", dropout_rate=0.1, seed=0):
    kw = GPT if kind == "gpt" else BERT
    m = create_model(NAMES[kind], device="cpu", remat=remat,
                     attention_impl=impl, dropout_rate=dropout_rate, **kw)
    return m.reset_parameters(torch.Generator().manual_seed(seed))


def _batch(kind, seed=0, b=4, l=16):
    rng = np.random.default_rng(seed)
    if kind == "gpt":
        ids = rng.integers(0, 64, (b, l))
        return torch.from_numpy(ids), torch.from_numpy(
            rng.integers(0, 64, (b, l)))
    ids = rng.integers(1, 100, (b, l))
    ids[1, 9:] = 0                       # a padded tail
    return torch.from_numpy(ids), torch.from_numpy(rng.integers(0, 2, (b,)))


def _loss(model, x, y, gen):
    logits = model(x, train=True, generator=gen)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1))


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_state_dict_is_the_same_with_and_without_remat(kind):
    plain, rem = _model(kind, False), _model(kind, True)
    a, b = plain.state_dict(), rem.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_loss_and_gradients_bitwise_equal_with_dropout(kind, impl):
    x, y = _batch(kind)
    out = {}
    for remat in (False, True):
        model = _model(kind, remat, impl)
        gen = torch.Generator().manual_seed(7)
        loss = _loss(model, x, y, gen)
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()},
                      torch.rand(4, generator=gen))
    assert torch.equal(out[False][0], out[True][0])
    for name, g in out[False][1].items():
        assert torch.equal(g, out[True][1][name]), name
    # the recompute put the stream back: it is where it is without remat
    assert torch.equal(out[False][2], out[True][2])


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_sync_engine_steps_bitwise_equal_with_remat(kind):
    x, y = _batch(kind, seed=1, b=8)
    runs = {}
    for remat in (False, True):
        eng = SyncEngine(_model(kind, remat), device="cpu")
        state = eng.init_state(torch.Generator().manual_seed(3))
        losses = []
        for i in range(3):
            state, m = eng.step(state, x[i % 2::2], y[i % 2::2])
            losses.append(m["loss"])
        runs[remat] = (torch.stack(losses), state.model.state_dict())
    assert torch.equal(runs[False][0], runs[True][0])
    for name, p in runs[False][1].items():
        assert torch.equal(p, runs[True][1][name]), name


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_each_block_runs_again_in_the_backward_pass(kind):
    x, y = _batch(kind)
    for remat, want in ((False, 1), (True, 2)):
        model = _model(kind, remat)
        calls = []
        for block in model.blocks:
            block.register_forward_pre_hook(lambda *_: calls.append(1))
        _loss(model, x, y, torch.Generator().manual_seed(0)).backward()
        assert len(calls) == want * len(model.blocks), (remat, len(calls))
        calls.clear()
        with torch.no_grad():
            model(x, train=False)
        assert len(calls) == len(model.blocks)


def test_remat_without_a_generator_restores_the_default_one():
    """``generator=None``: dropout draws from the default generator, which
    ``torch.utils.checkpoint`` restores for the recompute itself."""
    x, y = _batch("bert")
    out = {}
    for remat in (False, True):
        model = _model("bert", remat)
        torch.manual_seed(11)
        loss = _loss(model, x, y, None)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in model.parameters()],
                      torch.rand(4))
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                 out[True][1]))
    assert torch.equal(out[False][2], out[True][2])


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_remat_matches_flax_remat(kind):
    import optax

    kw = dict(GPT if kind == "gpt" else BERT, dropout_rate=0.0)
    num_classes = kw.pop("num_classes")
    jm = jax_create(NAMES[kind], num_classes=num_classes, remat=True, **kw)
    x, y = _batch(kind, seed=2)
    ids, labels = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    params = jm.init(jax.random.key(0), ids, train=False)["params"]

    def loss_fn(p):
        logits = jm.apply({"params": p}, ids, train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean()

    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    want = CONVERT[kind](jax.tree.map(np.asarray, grads))
    model = _model(kind, True, dropout_rate=0.0)
    model.load_state_dict(CONVERT[kind](jax.tree.map(np.asarray, params)))
    loss = _loss(model, x, y, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_remat_with_moe_raises_the_jax_message(kind):
    kw = dict(GPT if kind == "gpt" else BERT)
    num_classes = kw.pop("num_classes")
    jm = jax_create(NAMES[kind], num_classes=num_classes, remat=True,
                    moe_experts=2, **kw)
    with pytest.raises(ValueError) as want:
        jm.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32), train=False)
    with pytest.raises(ValueError) as got:
        create_model(NAMES[kind], num_classes=num_classes, remat=True,
                     moe_experts=2, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_harness_rejects_remat_without_transformer_blocks(model):
    with pytest.raises(ValueError) as want:
        jharness._resolve_model(jharness.ExperimentConfig(
            model=model, remat=True), 10)
    with pytest.raises(ValueError) as got:
        tharness._resolve_model(tharness.ExperimentConfig(
            model=model, remat=True), 10, "cpu")
    assert str(got.value) == str(want.value)
    assert "--remat checkpoints transformer blocks" in str(got.value)


@pytest.mark.parametrize("attention", ["ring", "ring_flash", "ulysses",
                                       "ulysses_flash", "flash"])
def test_attention_flag_resolves_as_in_jax(attention):
    sizes = {"gpt": dict(hidden=32, layers=1, heads=2, ffn=64, max_len=16),
             "bert_tiny": dict(hidden=32, layers=1, heads=2, ffn=64,
                               max_len=16)}
    for model, size in sizes.items():
        cfg = dict(model=model, attention_impl=attention, remat=True,
                   model_args=size)
        want = jharness._resolve_model(jharness.ExperimentConfig(**cfg), 64)
        got = tharness._resolve_model(tharness.ExperimentConfig(**cfg), 64,
                                      "cpu")
        assert got.attention_impl == want.attention_impl, (model, attention)
        assert got.remat is want.remat is True
    mlp = tharness._resolve_model(tharness.ExperimentConfig(
        model="mlp", attention_impl=attention), 10, "cpu")
    assert not hasattr(mlp, "attention_impl")


def test_cli_flags_reach_the_config():
    args = tcli.build_parser().parse_args([])
    assert (args.attention, args.remat) == ("ring", False)
    args = tcli.build_parser().parse_args(["--attention", "flash",
                                           "--remat"])
    assert (args.attention, args.remat) == ("flash", True)
    cfg = tharness.ExperimentConfig(model="gpt", remat=True,
                                    model_args=dict(remat=True))
    with pytest.raises(ValueError, match="set by the harness"):
        tharness._resolve_model(cfg, 64, "cpu")
    cfg = dataclasses.replace(cfg, model_args=dict(GPT, num_classes=None))
    with pytest.raises(ValueError, match="set by the harness"):
        tharness._resolve_model(cfg, 64, "cpu")
