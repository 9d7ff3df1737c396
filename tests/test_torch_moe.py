"""The port's Mixture-of-Experts layer, the MoE blocks of the GPT and BERT,
``MoEClassifier`` and the router-health monitor, held to the JAX package
on the CPU at a small size (d 16, 4 experts, expert hidden 32; 64 tokens):

* ``MoELayer`` from the converted parameters against the JAX layer applied
  with ``mutable=["intermediates"]``, top-1 and top-2, in one group and in
  groups of 16, at a capacity factor of 1.25 and of 0.5 (tokens overflow:
  positions at or past the capacity, whose one-hots are rows of zeros):
  outputs, ``aux_loss``, ``z_loss`` and ``overflow`` within ``1e-6``
  (f32), and the gradients of x, ``gate``, ``w1`` and ``w2`` under ``Σ
  y·r + 0.01·aux + 1e-3·z`` within ``1e-5``.  At bf16 compute the outputs
  are held within ``BF16_TOL``: the four einsums round to bf16 on both
  sides, in other orders;
* ``_moe_group_size`` equal to JAX's over token counts (2000, the case of
  its docstring, among them);
* ``MoEClassifier`` (top-2, two layers), the flash GPT with
  ``moe_experts`` (top-2, the flash on the CPU's plain versions) and BERT
  with ``moe_experts`` (one block each): the forward within ``1e-5``,
  then 2 SGD steps of the port's ``SyncEngine`` against JAX
  ``SyncEngine`` on a 1-device mesh, which drops the router
  losses (its apply has no ``mutable``), as the port's does: losses within
  ``rtol=1e-5``, parameters within ``atol=1e-5``;
* the dense-attention MoE GPT's logits, and ``generate``'s greedy stream
  equal to JAX ``generate``'s (one-token prefill steps, 2 tokens routed
  per step);
* the ``_OverflowMonitor`` episodes of JAX
  ``tests/test_expert_parallel.py:270-300``;
* ``ExpertParallelEngine`` on a (1, 1) gloo mesh against ``SyncEngine``
  (the card's ep = 1 path), and the mode's errors with JAX's messages.

The many-rank engine is held to JAX on four gloo ranks in
``tests/test_torch_expert_parallel.py``.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from distributed_tensorflow_tpu.engines.expert_parallel import (
    ExpertParallelEngine as JaxEP, _OverflowMonitor as JaxMonitor)
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models import create_model as jcreate
from distributed_tensorflow_tpu.models import moe as jmoe
from distributed_tensorflow_tpu.models.gpt import generate as jgenerate
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.utils import harness as jharness
from distributed_tensorflow_tpu_torch import cli as tcli
from distributed_tensorflow_tpu_torch.engines import (
    ExpertParallelEngine, SyncEngine)
from distributed_tensorflow_tpu_torch.engines.expert_parallel import (
    _OverflowMonitor, router_losses)
from distributed_tensorflow_tpu_torch.models import convert, create_model
from distributed_tensorflow_tpu_torch.models import moe as tmoe
from distributed_tensorflow_tpu_torch.models.gpt import generate
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.utils import harness

T, D, E, H = 64, 16, 4, 32
OUT_TOL = dict(rtol=0, atol=1e-6)
GRAD_TOL = dict(rtol=0, atol=1e-5)
# bf16: each einsum's output rounds to bf16 (relative 2^-8) on both sides,
# with f32 accumulation in other orders; four of them in a row
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LR = 0.1
STEP_TOL = dict(rtol=0, atol=1e-5)
LAYER_CASES = {
    "top1": (1, 1.25, None), "top2": (2, 1.25, None),
    "top1_overflow": (1, 0.5, None), "top2_grouped_overflow": (2, 0.5, 16),
    "top1_grouped": (1, 1.25, 16),
}
MOE = dict(num_experts=E, embed_dim=D, expert_hidden=H, dropout_rate=0.0)
# one block each: a second block would route the same way again and
# double the JAX side's compile
GPT = dict(vocab_size=64, hidden=D, layers=1, heads=2, ffn=H, max_len=32,
           dropout_rate=0.0, moe_experts=E)
BERT = dict(num_classes=2, vocab_size=64, hidden=D, layers=1, heads=2,
            ffn=H, max_len=32, dropout_rate=0.0, moe_experts=E)


def _np(t):
    return t.detach().float().numpy()


def _layer_pair(k, cf, dtype=torch.float32, seed=0):
    x = np.random.default_rng(seed).standard_normal((T, D)).astype(
        np.float32)
    jl = jmoe.MoELayer(num_experts=E, hidden=H, capacity_factor=cf,
                       router_top_k=k,
                       dtype=jnp.bfloat16 if dtype is torch.bfloat16
                       else jnp.float32)
    params = jl.init(jax.random.key(seed), jnp.asarray(x))["params"]
    tl = tmoe.MoELayer(D, E, H, cf, k, dtype=dtype, device="cpu")
    with torch.no_grad():
        for name in ("gate", "w1", "w2"):
            getattr(tl, name).copy_(torch.tensor(np.asarray(params[name])))
    return x, jl, params, tl


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_matches_jax_outputs_router_values_and_gradients(name):
    k, cf, gs = LAYER_CASES[name]
    x, jl, params, tl = _layer_pair(k, cf)
    jl = jl.clone(group_size=gs)
    r = np.random.default_rng(1).standard_normal((T, D)).astype(np.float32)

    def jloss(params, x):
        y, col = jl.apply({"params": params}, x, mutable=["intermediates"])
        it = col["intermediates"]
        aux, z = it["aux_loss"][0], it["z_loss"][0]
        return jnp.sum(y * r) + 0.01 * aux + 1e-3 * z, (y, it)

    (_, (jy, it)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = tl(tx, group_size=gs)
    (torch.sum(ty * torch.tensor(r)) + 0.01 * tl.aux_loss
     + 1e-3 * tl.z_loss).backward()
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **OUT_TOL)
    for key in ("aux_loss", "z_loss", "overflow"):
        np.testing.assert_allclose(float(getattr(tl, key).detach()),
                                   float(it[key][0]), **OUT_TOL, err_msg=key)
    assert not tl.overflow.requires_grad
    if "overflow" in name:
        assert float(tl.overflow) > 0.1
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), **GRAD_TOL)
    for key in ("gate", "w1", "w2"):
        np.testing.assert_allclose(_np(getattr(tl, key).grad),
                                   np.asarray(jg[key]), **GRAD_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("k", [1, 2])
def test_layer_bf16_compute_matches_jax(k):
    x, jl, params, tl = _layer_pair(k, 1.25, torch.bfloat16)
    jy, it = jl.apply({"params": params}, jnp.asarray(x),
                      mutable=["intermediates"])
    ty = tl(torch.tensor(x))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32),
                               **BF16_TOL)
    # the router runs in f32 on both sides
    np.testing.assert_allclose(float(tl.aux_loss.detach()),
                               float(it["intermediates"]["aux_loss"][0]),
                               rtol=1e-6)


def test_group_size_matches_jax():
    for tokens in (1, 64, 1024, 1025, 2000, 2048, 4096, 8192, 3 * 512,
                   768, 1280, 65536, 6 * 1024 + 256):
        assert tmoe._moe_group_size(tokens) == jmoe._moe_group_size(
            tokens), tokens
    assert tmoe._moe_group_size(2000) is None
    assert tmoe._moe_group_size(8192) == 1024


def test_capacity_formula_and_initializer():
    layer = tmoe.MoELayer(512, 8, 2048, 1.25, 1, device="cpu")
    assert layer.capacity(1024) == 160
    assert layer.capacity(1) == 1
    assert tmoe.MoELayer(8, 4, 8, 1.0, 2, device="cpu").capacity(6) == 3
    # flax lecun_normal: fan-in of a stacked (E, a, b) kernel is E·a
    layer.reset_parameters(torch.Generator().manual_seed(0))
    for p, fan_in in ((layer.gate, 512), (layer.w1, 8 * 512),
                      (layer.w2, 8 * 2048)):
        assert abs(float(p.detach().std()) * fan_in ** 0.5 - 1.0) < 0.02


# ---------------------------------------------------- models and SyncEngine

def _images(rows=16, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, 8, 8)).astype(np.float32),
            rng.integers(0, 10, rows).astype(np.int32))


def _tokens(kind, rows=4, seed=2):
    rng = np.random.default_rng(seed)
    if kind == "gpt":
        tok = rng.integers(0, 64, (rows, 33)).astype(np.int32)
        return tok[:, :-1], tok[:, 1:]
    x = rng.integers(1, 64, (rows, 32)).astype(np.int32)
    x[0, 20:] = 0
    return x, rng.integers(0, 2, rows).astype(np.int32)


MODEL_CASES = {
    "moe_top2_depth2": ("moe", dict(MOE, num_classes=10, router_top_k=2,
                                    depth=2, capacity_factor=1.0)),
    "gpt_flash_top2": ("gpt", dict(GPT, attention_impl="flash",
                                   moe_top_k=2)),
    "bert": ("bert_tiny", dict(BERT)),
}


def _data(kind):
    return _images() if kind == "moe" else _tokens(
        "gpt" if kind == "gpt" else "bert")


def _convert(kind):
    return {"moe": convert.moe_state_dict, "gpt": convert.gpt_state_dict,
            "bert_tiny": convert.bert_state_dict}[kind]


def _jax_kw(kind, kw):
    kw = dict(kw)
    if kind == "gpt":
        kw["num_classes"] = kw.pop("vocab_size")
    return kw


def _port_kw(kind, kw):
    kw = dict(kw)
    if kind == "gpt":
        kw["num_classes"] = kw.pop("vocab_size")
    return kw


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_forward_and_two_sync_steps_match_jax(name):
    kind, kw = MODEL_CASES[name]
    x, y = _data(kind)
    jeng = JaxSync(jcreate(kind, **_jax_kw(kind, kw)),
                   optimizer=optax.sgd(LR), mesh=jmesh.create_mesh(1))
    # jitted: flax's eager init and apply take seconds op by op
    jstate = jax.jit(lambda key: jeng.init_state(key, x[:1]))(
        jax.random.key(0))
    init = _convert(kind)(jax.tree.map(np.asarray, jstate.params))
    jlogits = jax.jit(jeng.model.apply)({"params": jstate.params},
                                        jnp.asarray(x))
    model = create_model(kind, device="cpu", **_port_kw(kind, kw))
    eng = SyncEngine(model, device="cpu",
                     optimizer=lambda p: torch.optim.SGD(p, lr=LR))
    state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
    state.model.load_state_dict(init)
    with torch.no_grad():
        logits = state.model(torch.tensor(x))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), rtol=0,
                               atol=1e-5)
    for _ in range(2):
        jstate, jm = jeng.step(jstate, *jeng.shard_batch(x, y))
        state, m = eng.step(state, *eng.shard_batch(x, y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    want = _convert(kind)(jax.tree.map(np.asarray, jstate.params))
    for key, w in want.items():
        np.testing.assert_allclose(_np(state.model.state_dict()[key]),
                                   w.numpy(), **STEP_TOL, err_msg=key)
    moved = max(float((w - init[key]).abs().max()) for key, w in want.items()
                if ".moe." in key or key.startswith("moe."))
    assert moved > 1e-4     # the experts and gates trained


def test_dense_moe_gpt_forward_and_generate_equal_jax():
    """The dense-attention MoE GPT's logits, and ``generate``'s greedy
    stream (one-token prefill steps, as JAX's scan)."""
    jm = jcreate("gpt", **_jax_kw("gpt", dict(GPT, attention_impl="dense")))
    x, _ = _tokens("gpt")
    params = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))["params"]
    tm = create_model("gpt", device="cpu",
                      **_port_kw("gpt", dict(GPT, attention_impl="dense")))
    tm.load_state_dict(convert.gpt_state_dict(jax.tree.map(np.asarray,
                                                           params)))
    with torch.no_grad():
        logits = tm(torch.tensor(x))
    np.testing.assert_allclose(
        _np(logits), np.asarray(jax.jit(jm.apply)({"params": params}, x)),
        rtol=0, atol=1e-5)
    prompt = np.random.default_rng(5).integers(0, 64, (2, 5))
    want = jgenerate(jm, params, jnp.asarray(prompt), 8, greedy=True)
    got = generate(tm, None, prompt, 8, greedy=True, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()


def test_router_losses_sum_layers_and_sync_engine_drops_them():
    model = create_model("moe", num_classes=10, device="cpu",
                         **dict(MOE, depth=2))
    x, y = _images()
    eng = SyncEngine(model, device="cpu")
    state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
    state, m = eng.step(state, *eng.shard_batch(x, y))
    assert set(m) == {"loss", "accuracy"}
    model(torch.tensor(x))
    aux, z, overflow = router_losses(model)
    layers = list(model.moe)
    assert float(aux) == pytest.approx(sum(float(l.aux_loss) for l in layers))
    assert float(z) == pytest.approx(sum(float(l.z_loss) for l in layers))
    assert float(overflow) == pytest.approx(
        sum(float(l.overflow) for l in layers) / 2)
    assert aux.requires_grad and not overflow.requires_grad
    zero = router_losses(torch.nn.Linear(2, 2))
    assert [float(v) for v in zero] == [0.0, 0.0, 0.0]


def test_moe_gpt_trains_through_the_cli():
    from distributed_tensorflow_tpu_torch.data import loaders as tloaders

    def small_lm(batch_size, type="train"):
        return tloaders.load_lm_dataset("lm_synth", split=type, seq_len=16,
                                        vocab_size=64, n_train=32, n_test=16)

    summary = tcli.main(
        ["--device", "cpu", "-b", "4", "--model", "gpt", "--dataset",
         "lm_synth", "--model-arg", "hidden=16", "--model-arg", "layers=1",
         "--model-arg", "heads=2", "--model-arg", "ffn=32", "--model-arg",
         "max_len=16", "--model-arg", "moe_experts=4", "--model-arg",
         "moe_top_k=2", "--log-every", "0"], dataset_fn=small_lm)
    assert summary["engine"] == "sync" and summary["steps"] == 8
    assert np.isfinite(summary["test_loss"])


# ------------------------------------------------------- overflow monitor

def _episodes(cls):
    """JAX tests/test_expert_parallel.py:270-300 on ``cls``: one warning
    per sustained-high episode, re-armed by a recovered window."""
    mon = cls(threshold=0.25, window=5)
    with pytest.warns(UserWarning, match="capacity_factor"):
        for _ in range(5):
            mon.observe(0.9)
    assert mon.warning_count == 1
    assert mon.last_window_mean == pytest.approx(0.9)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(5):
            mon.observe(0.8)
        assert mon.warning_count == 1
        for _ in range(5):
            mon.observe(torch.tensor(0.0))
    with pytest.warns(UserWarning):
        for _ in range(5):
            mon.observe(0.8)
    assert mon.warning_count == 2
    return mon.report()


def test_overflow_monitor_episodes_match_jax():
    assert _episodes(_OverflowMonitor) == _episodes(JaxMonitor)


# ------------------------------------------------- one rank, and errors

@pytest.fixture
def ep_mesh():
    mesh = meshlib.create_mesh(1, device="cpu", shape=(1, 1),
                               axis_names=("data", "expert"))
    yield mesh
    mesh.close()


@pytest.mark.parametrize("k", [1, 2])
def test_one_rank_engine_equals_sync_engine(ep_mesh, k):
    """At ep = 1 (the card's path, here on a 1-rank gloo group) the
    all-to-all is a copy and one rank's routing is global routing: with
    the router terms weighted 0 the task losses and parameters are
    SyncEngine's within f32 rounding (the router sums in another order);
    with them the total loss is task + weighted terms."""
    x, y = _images()
    runs = []
    for cls, kw in ((ExpertParallelEngine, dict(aux_weight=0.0)),
                    (SyncEngine, {}),
                    (ExpertParallelEngine, dict(aux_weight=0.01,
                                                router_z_weight=1e-3))):
        model = create_model("moe", num_classes=10, device="cpu",
                             **dict(MOE, router_top_k=k, capacity_factor=1.0))
        eng = cls(model, mesh=ep_mesh, **kw,
                  optimizer=lambda p: torch.optim.SGD(p, lr=LR))
        state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
        metrics = []
        for _ in range(3):
            state, m = eng.step(state, *eng.shard_batch(x, y))
            metrics.append({key: float(v) for key, v in m.items()})
        runs.append((metrics, {n: _np(p) for n, p in
                               state.model.state_dict().items()}))
    (ep, ep_p), (sync, sync_p), (full, _) = runs
    np.testing.assert_allclose([m["loss"] for m in ep],
                               [m["loss"] for m in sync], rtol=1e-6)
    for key in sync_p:
        np.testing.assert_allclose(ep_p[key], sync_p[key], rtol=0,
                                   atol=1e-6, err_msg=key)
    assert full[0]["loss"] == pytest.approx(ep[0]["loss"], rel=1e-6)
    for m in full:
        assert 0.0 <= m["overflow"] <= 1.0
        assert m["total_loss"] > m["loss"]


def test_errors_match_jax(ep_mesh):
    # router_top_k outside {1, 2}
    with pytest.raises(ValueError) as want:
        jmoe.MoELayer(router_top_k=3).init(jax.random.key(0),
                                           jnp.ones((4, 8)))
    with pytest.raises(ValueError) as got:
        create_model("moe", router_top_k=3, device="cpu")
    assert str(got.value) == str(want.value)
    # a mesh without the expert axis
    with pytest.raises(ValueError) as want:
        JaxEP(jcreate("moe", num_classes=10),
              mesh=jmesh.create_mesh(1))
    flat = dataclasses.replace(ep_mesh, axis_names=("data",), dims=(1,))
    for mesh in (flat, None):
        with pytest.raises(ValueError) as got:
            ExpertParallelEngine(create_model("moe", device="cpu"),
                                 mesh=mesh)
        assert str(got.value) == str(want.value)
    # fp16-f32master: the router terms thread no loss scale
    with pytest.raises(ValueError) as want:
        JaxEP(jcreate("moe", num_classes=10, partition_experts=True),
              mesh=jmesh.create_mesh(1, shape=(1, 1),
                                     axis_names=("data", "expert")),
              precision="fp16-f32master")
    with pytest.raises(ValueError) as got:
        ExpertParallelEngine(create_model("moe", device="cpu"),
                             mesh=ep_mesh, precision="fp16-f32master")
    assert str(got.value) == str(want.value)
    # the z-loss weight without -ep; num_experts that do not split
    for kw in (dict(router_z_weight=1e-3),
               dict(expert_parallel=2, n_devices=2, num_experts=3)):
        cfg = dict(model="moe", dataset="synthetic", **kw)
        with pytest.raises(ValueError) as want:
            jharness._setup(jharness.ExperimentConfig(**cfg))
        with pytest.raises(ValueError) as got:
            harness._setup(harness.ExperimentConfig(**cfg, device="cpu"))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not divisible by expert_parallel"):
        tcli.main(["--device", "cpu", "-n", "2", "-ep", "2", "--model",
                   "moe", "--num-experts", "3"])


# ep×tp and ep×sp are ported since (tests/test_torch_composite.py); their
# composites with the pipeline still raise
@pytest.mark.parametrize("flags", [["-tp", "2", "-pp", "2"],
                                   ["-sp", "2", "-pp", "2"]])
def test_expert_parallel_composites_still_raise(flags):
    with pytest.raises(NotImplementedError,
                       match="remaining engines: pipeline composites"):
        tcli.main(["--device", "cpu", "-n", "8", "-ep", "2", *flags,
                   "--model", "moe"])


def test_gradient_codec_under_expert_parallel_runs_a_step(ep_mesh):
    """The int8 codec (ported since) takes a step on the (1, 1) mesh: the
    roundtrip after the reduces changes the update, the parameters stay
    finite, and every rank's replica equals its peers' (one rank here:
    the gathered full state dict is the rank's own)."""
    x, y = _images()
    eng = ExpertParallelEngine(create_model("moe", device="cpu"),
                               mesh=ep_mesh, grad_compression="int8")
    state = eng.init_state(torch.Generator().manual_seed(0), x)
    before = {k: v.clone() for k, v in eng.full_state_dict(state).items()}
    state, m = eng.step(state, *eng.shard_batch(x, y))
    after = eng.full_state_dict(state)
    assert eng.grad_codec.name == "int8" and state.step == 1
    assert np.isfinite(float(m["loss"]))
    assert all(torch.isfinite(v).all() for v in after.values())
    assert any(not torch.equal(before[k], after[k]) for k in after)
    gathered = [None] * ep_mesh.world_size
    torch.distributed.all_gather_object(
        gathered, {k: v.numpy() for k, v in after.items()})
    assert all(np.array_equal(g[k], after[k].numpy())
               for g in gathered for k in after)
