"""Mixed precision in the port (``parallel/precision.py`` and its wiring
through the engines, the Trainer, the harness and the CLI) held to the
JAX package on the CPU, at small sizes:

* ``make_policy`` resolves and refuses as JAX's does;
* ``MasterWeights`` keeps ``params == cast(master)`` bitwise after every
  step, and its fp16 loss scaler follows JAX ``master_weights`` on the
  same injected gradient sequence (an inf at step 3, then finite steps
  across a growth boundary): scale, ``good_steps``, ``skipped`` and the
  skip flag equal; a skipped step leaves master, Adam's moments and
  count bitwise as they were; the master within 1 ulp of JAX's after
  each step, the JAX master set to the port's before the next (the two
  frameworks round Adam's update differently, so the sum master + update
  may round to neighbouring floats, once per step);
* ``precision="f32"`` is a strict no-op: no wrapper, and the trajectory
  (dropout on) is bitwise the one of an engine built without the
  argument, at k = 1 and k = 8;
* the MLP and the CNN under ``bf16-f32master`` and ``bf16`` train like
  the JAX ``SyncEngine`` from the same f32 weights (entered through
  ``adopt_f32_state`` on both sides), and their parameter and optimizer
  bytes follow the JAX layout;
* a non-finite batch under ``fp16-f32master`` through ``Trainer.fit``
  gives the JAX Trainer's ``loss_scale`` section and does not end the
  fit;
* ``AsyncLocalEngine`` under ``bf16-f32master`` on 2 gloo ranks equals
  the JAX engine's rows, params and master, after every step: after a
  sync step the params rows agree and the master rows do not;
* the flash route on float16 inputs against the Pallas kernels
  (interpret mode): forward and the three gradients;
* the harness's precision/dtype resolution and the CLI flag.

The spawned ranks re-import this module, JAX included (a second or two).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
import optax

from distributed_tensorflow_tpu.data import loaders as jloaders
from distributed_tensorflow_tpu.engines.allreduce import Trainer as JaxTrainer
from distributed_tensorflow_tpu.engines.async_local import (
    AsyncLocalEngine as JaxAsync)
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models.cnn import CNN as JaxCNN
from distributed_tensorflow_tpu.models.mlp import MLP as JaxMLP
from distributed_tensorflow_tpu.parallel import precision as jpl
from distributed_tensorflow_tpu.parallel.mesh import create_mesh as jax_mesh
from distributed_tensorflow_tpu_torch import cli as tcli
from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.engines import (
    AsyncLocalEngine, Engine, GossipEngine, SyncEngine, Trainer)
from distributed_tensorflow_tpu_torch.models.cnn import CNN
from distributed_tensorflow_tpu_torch.models.convert import (
    cnn_state_dict, mlp_state_dict)
from distributed_tensorflow_tpu_torch.models.mlp import MLP
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import precision as tpl
from distributed_tensorflow_tpu_torch.utils import harness

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

jfa = importlib.import_module("distributed_tensorflow_tpu.ops.flash_attention")

DT = {"bf16": torch.bfloat16, "bf16-f32master": torch.bfloat16,
      "fp16-f32master": torch.float16}
NARROW = {
    "mlp": (dict(num_classes=10, hidden=32), JaxMLP, MLP, mlp_state_dict),
    "cnn": (dict(num_classes=10, features=(8, 16), dense=32), JaxCNN, CNN,
            cnn_state_dict),
}


def _images(n, seed=3):
    x, y = jloaders.synthetic_classification((12, 12), 10, n, seed=seed,
                                             split="train")
    return x.reshape((n, 12, 12, 1)), y


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ------------------------------------------------------------------ policy

def test_make_policy_resolution_matches_jax():
    for name in tpl.POLICIES:
        t, j = tpl.make_policy(name), jpl.make_policy(name)
        assert (t.name, t.active, t.loss_scaling) == (
            j.name, j.active, j.loss_scaling)
        assert (t.master_dtype is None) == (j.master_dtype is None)
        assert str(t.param_dtype).split(".")[-1] == str(
            jnp.dtype(j.param_dtype))
        assert t.grad_reduce_dtype == t.param_dtype
        assert (t.init_scale, t.growth_factor, t.backoff_factor,
                t.growth_interval) == (j.init_scale, j.growth_factor,
                                       j.backoff_factor, j.growth_interval)
    assert tpl.make_policy(None).name == tpl.make_policy("float32").name
    m = tpl.make_policy("bf16-f32master")
    assert tpl.make_policy(m) is m
    assert tpl.SCALE_KEYS == jpl.SCALE_KEYS
    for bad in ("bf8", "fp16"):
        with pytest.raises(ValueError, match="known: f32, bf16, "
                                             "bf16-f32master, fp16-f32master"):
            tpl.make_policy(bad)


def test_engines_resolve_every_policy_and_reject_fp16_where_jax_does():
    """sync/allreduce take every policy; async and gossip take the bf16
    ones and refuse fp16-f32master with the JAX ValueError."""
    for name in tpl.POLICIES:
        eng = SyncEngine(MLP(device="cpu"), device="cpu", precision=name)
        assert eng.precision.name == name
    for cls in (AsyncLocalEngine, GossipEngine, Engine):
        for name in ("f32", "bf16", "bf16-f32master"):
            assert cls(MLP(device="cpu"), device="cpu",
                       precision=name).precision.name == name
        with pytest.raises(ValueError, match="loss scaling") as got:
            cls(MLP(device="cpu"), device="cpu", precision="fp16-f32master")
        with pytest.raises(ValueError) as want:
            JaxAsync(JaxMLP(), mesh=jax_mesh(1),
                     precision="fp16-f32master")
        assert str(got.value).replace(cls.__name__, "X") == str(
            want.value).replace("AsyncLocalEngine", "X")


def _two_params(dtype):
    return [torch.nn.Parameter(torch.tensor([1.0, -0.5, 0.25], dtype=dtype)),
            torch.nn.Parameter(torch.tensor([[2.0, 3.0]], dtype=dtype))]


def test_master_weights_params_are_the_downcast_master_every_step():
    """bf16-f32master around Adam: after each of five steps the stored
    params equal ``cast(master)`` bitwise, and the master moves as JAX's
    (within 1 ulp; see the module docstring)."""
    policy = tpl.make_policy("bf16-f32master")
    params = _two_params(torch.bfloat16)
    opt = policy.wrap_optimizer(lambda p: torch.optim.Adam(p, lr=1e-3))(
        params)
    assert isinstance(opt, tpl.MasterWeights)
    jtx = jpl.make_policy("bf16-f32master").wrap_optimizer(optax.adam(1e-3))
    jp = {"a": jnp.asarray(params[0].float().detach().numpy(), jnp.bfloat16),
          "b": jnp.asarray(params[1].float().detach().numpy(), jnp.bfloat16)}
    jst = jtx.init(jp)
    rng = np.random.default_rng(0)
    for _ in range(5):
        g = [rng.normal(size=p.shape).astype(np.float32) * 0.1
             for p in params]
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi).to(torch.bfloat16)
        opt.step()
        for p, off in zip(params, (0, 3)):
            np.testing.assert_array_equal(
                p.detach().float().numpy().reshape(-1),
                opt.master[off:off + p.numel()].to(torch.bfloat16)
                .float().numpy())
        jg = {"a": jnp.asarray(g[0], jnp.bfloat16),
              "b": jnp.asarray(g[1], jnp.bfloat16)}
        u, jst = jtx.update(jg, jst, jp)
        jp = optax.apply_updates(jp, u)
        jm = jpl._find_master(jst)[0].master
        np.testing.assert_array_max_ulp(
            opt.master.numpy(),
            np.concatenate([np.asarray(jm["a"]).reshape(-1),
                            np.asarray(jm["b"]).reshape(-1)]), maxulp=1)
        jst, jp = _resync(jst, opt, jnp.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in params)


def _resync(jst, opt, dtype):
    """JAX's master (and its downcast params) set to the port's."""
    m = opt.master.numpy().copy()     # jnp.asarray may alias numpy memory
    master = {"a": jnp.asarray(m[:3]), "b": jnp.asarray(m[3:].reshape(1, 2))}
    return (jst._replace(master=master),
            jax.tree.map(lambda a: a.astype(dtype), master))


def _inner(opt):
    st = opt.inner.state[opt.master]
    return {k: v.clone() for k, v in st.items()}


def test_fp16_scaler_sequence_matches_jax_master_weights():
    """The same fp16 (scaled) gradients into both wrappers around Adam:
    finite, finite, inf at step 3, then five finite steps across a growth
    boundary (growth_interval 2, as JAX's test lowers it)."""
    kw = dict(name="fp16-f32master", loss_scaling=True, init_scale=8.0,
              growth_interval=2)
    policy = tpl.PrecisionPolicy(param_dtype=torch.float16,
                                 compute_dtype=torch.float16,
                                 master_dtype=torch.float32, **kw)
    jpolicy = jpl.PrecisionPolicy(param_dtype=jnp.float16,
                                  compute_dtype=jnp.float16,
                                  master_dtype=jnp.float32, **kw)
    params = _two_params(torch.float16)
    opt = policy.wrap_optimizer(lambda p: torch.optim.Adam(p, lr=1e-3))(
        params)
    jtx = jpolicy.wrap_optimizer(optax.adam(1e-3))
    jp = {"a": jnp.asarray([1.0, -0.5, 0.25], jnp.float16),
          "b": jnp.asarray([[2.0, 3.0]], jnp.float16)}
    jst = jtx.init(jp)
    rng = np.random.default_rng(1)
    for step in range(1, 9):
        g = [(rng.normal(size=p.shape) * 8).astype(np.float16)
             for p in params]
        if step == 3:
            g[1][0, 1] = np.inf
        before = (opt.master.clone(), _inner(opt) if step > 1 else None,
                  [p.detach().clone() for p in params])
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        u, jst = jtx.update({"a": jnp.asarray(g[0]), "b": jnp.asarray(g[1])},
                            jst, jp)
        jp = optax.apply_updates(jp, u)
        jm = jpl._find_master(jst)[0]
        assert float(opt.loss_scale) == float(jm.loss_scale), step
        assert int(opt.good_steps) == int(jm.good_steps), step
        assert int(opt.skipped) == int(jm.skipped), step
        assert bool(opt.last_skipped) == bool(jm.last_skipped) == (step == 3)
        np.testing.assert_array_max_ulp(
            opt.master.numpy(),
            np.concatenate([np.asarray(jm.master["a"]).reshape(-1),
                            np.asarray(jm.master["b"]).reshape(-1)]),
            maxulp=1)
        jst, jp = _resync(jst, opt, jnp.float16)
        if step == 3:
            assert torch.equal(opt.master, before[0])
            after = _inner(opt)
            assert after.keys() == before[1].keys()
            for k, v in before[1].items():
                assert torch.equal(after[k], v), k
            for p, was in zip(params, before[2]):
                assert torch.equal(p.detach(), was)
        for p, off in zip(params, (0, 3)):
            assert torch.equal(p.detach().reshape(-1),
                               opt.master[off:off + p.numel()].half())
    # 8 grew to 16 at step 2, backed off to 8 at step 3, grew at 5 and 7
    assert float(opt.loss_scale) == 32.0 and int(opt.skipped) == 1


def test_first_step_skip_leaves_fresh_adam_state():
    """A skip at the very first step (Adam's state is born in it) leaves
    the fresh state: count and moments 0, master unchanged."""
    policy = tpl.make_policy("fp16-f32master")
    params = _two_params(torch.float16)
    opt = policy.wrap_optimizer(lambda p: torch.optim.Adam(p, lr=1e-3))(
        params)
    master = opt.master.clone()
    for p in params:
        p.grad = torch.full_like(p, float("nan"))
    opt.step()
    assert torch.equal(opt.master, master)
    assert all(not bool(v.any()) for v in _inner(opt).values())
    assert float(opt.loss_scale) == 2.0 ** 14 and bool(opt.last_skipped)


def test_strip_master_and_the_checkpoint_half_not_ported(tmp_path):
    """``strip_master`` gives the inner optimizer (the f32-era one); the
    checkpoint half, ported since: ``f32_template`` wraps a master-policy
    state (and refuses another), and ``restore_into_policy`` restores a
    checkpoint of the same policy and adopts an f32 one."""
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    params = _two_params(torch.bfloat16)
    opt = tpl.make_policy("bf16-f32master").wrap_optimizer(
        lambda p: torch.optim.SGD(p, lr=0.1))(params)
    assert tpl.strip_master(opt) is opt.inner
    sgd = torch.optim.SGD(_two_params(torch.float32), lr=0.1)
    assert tpl.strip_master(sgd) is sgd

    def state(precision, seed=0):
        eng = SyncEngine(create_model("mlp", num_classes=4, hidden=8,
                                      device="cpu"), device="cpu",
                         precision=precision)
        return eng, eng.init_state(torch.Generator().manual_seed(seed),
                                   np.zeros((1, 6), np.float32))

    eng32, st32 = state("f32")
    with pytest.raises(ValueError, match="master-policy"):
        tpl.f32_template(st32)
    engm, stm = state("bf16-f32master", seed=1)
    assert tpl.f32_template(stm).state is stm
    for i, st in enumerate((stm, st32)):
        CheckpointManager(tmp_path / str(i)).save(st)
    _, template = state("bf16-f32master", seed=2)
    same = tpl.restore_into_policy(CheckpointManager(tmp_path / "0"),
                                   template, engm.precision)
    assert torch.equal(same.optimizer.master, stm.optimizer.master)
    _, template = state("bf16-f32master", seed=2)
    adopted = tpl.restore_into_policy(CheckpointManager(tmp_path / "1"),
                                      template, engm.precision)
    want = torch.cat([p.detach().reshape(-1)
                      for p in st32.model.parameters()])
    assert torch.equal(adopted.optimizer.master, want)


# ---------------------------------------------------------- engine: f32

def _fit_mlp(k, **eng_kw):
    x, y = _images(64, seed=9)
    ds = tloaders.Dataset(x=x, y=y, num_classes=10, name="small")
    eng = SyncEngine(MLP(num_classes=10, hidden=32, dropout_rate=0.25,
                         device="cpu"), device="cpu", **eng_kw)
    trainer = Trainer(None, engine=eng, seed=2)
    lines = []
    result = trainer.fit(ds, epochs=1, batch_size=8, log_every=1,
                         log_fn=lines.append, steps_per_call=k)
    return trainer, lines, result


def test_f32_policy_is_a_bitwise_noop_at_k1_and_k8():
    for k in (1, 8):
        base, base_lines, _ = _fit_mlp(k)
        f32, f32_lines, result = _fit_mlp(k, precision="f32")
        assert type(f32.state.optimizer) is torch.optim.Adam
        assert f32_lines == base_lines and len(base_lines) == 8
        for (name, a), b in zip(base.state.model.named_parameters(),
                                f32.state.model.parameters()):
            assert a.dtype == torch.float32 and torch.equal(a, b), name
        assert result["precision"] == "f32" and "loss_scale" not in result


def test_engine_dropout_streams_by_step_and_rank():
    """The engines' dropout stream on the CPU: reseeded from (seed, step,
    rank) every step, so a mask depends on its step and rank and on
    nothing drawn before; each keeps the rate.  (On the card the rank's
    stream is seeded once and runs on, which a CUDA graph can replay:
    ``tests/test_torch_precision_cuda.py``.)"""
    from distributed_tensorflow_tpu_torch.models.layers import dropout

    eng = SyncEngine(MLP(num_classes=10, hidden=32, dropout_rate=0.2,
                         device="cpu"), device="cpu")
    state = eng.init_state(torch.Generator().manual_seed(0), _images(1)[0])
    assert state.generator.device.type == "cpu"
    x = torch.ones(400, 500)

    def mask(step, rank):
        state.step, eng.rank = step, rank
        return dropout(x, 0.2, True, eng.step_generator(state))

    masks = [mask(3, 0), mask(3, 1), mask(4, 0)]
    mask(9, 1)                       # draws between leave step 3 alone
    assert torch.equal(mask(3, 0), masks[0])
    for i, a in enumerate(masks):
        # 200k Bernoulli draws: 5 standard deviations ≈ 0.0045
        assert abs(float((a == 0).float().mean()) - 0.2) < 5e-3
        for b in masks[i + 1:]:
            assert not torch.equal(a, b)


# -------------------------------------------------- engine: bf16 vs JAX

def _jax_state(jeng, x, name):
    """The JAX engine's state under its policy, entered from the f32
    parameters of an f32 init (JAX's own adoption path)."""
    kw, jcls, _, _ = NARROW[name]
    params32 = jcls(**kw, dropout_rate=0.0).init(
        jax.random.key(0), jnp.asarray(x[:1]), train=False)["params"]
    jstate = jeng.init_state(jax.random.key(0), x[:1])
    if not jeng.precision.active:
        return jstate.replace(params=params32), params32
    if jeng.precision.master_dtype is None:
        return jstate.replace(params=jeng.precision.cast_params(
            params32)), params32
    restored = jpl.f32_template(jstate).replace(params=params32)
    return jpl.adopt_f32_state(jstate, restored, jeng.precision), params32


# bf16 compute in both frameworks, summed in other orders and rounded to
# bf16 at every layer (relative 2^-8 per rounding): the mean loss of a
# batch agrees to ~1%.  Parameters after 4 Adam steps of lr 1e-3 from the
# same weights: 99% of the elements within 2 bf16 roundings of their value
# plus lr; every element within 2 bf16 roundings plus 2·lr a step, the
# most two Adam updates of opposite sign can part them where a tiny
# gradient's sign differs between the frameworks (ROADMAP Queue 3, "Adam
# on zero gradients")
BF16_LOSS = dict(rtol=2e-2, atol=0)
BF16_PARAMS = dict(rtol=2 ** -7, atol=1e-3)
BF16_PARAMS_ALL = dict(rtol=2 ** -7, atol=4 * 2 * 1e-3)


@pytest.mark.parametrize("name", ["mlp", "cnn"])
@pytest.mark.parametrize("policy", ["bf16-f32master", "bf16"])
def test_sync_engine_under_bf16_policies_matches_jax(name, policy):
    x, y = _images(32)
    kw, jcls, tcls, to_sd = NARROW[name]
    jeng = JaxSync(jcls(**kw, dropout_rate=0.0, dtype=jnp.bfloat16),
                   mesh=jax_mesh(1), precision=policy)
    jstate, params32 = _jax_state(jeng, x, name)
    teng = SyncEngine(tcls(**kw, dropout_rate=0.0, dtype=torch.bfloat16,
                           device="cpu"), device="cpu", precision=policy)
    tstate = teng.init_state(torch.Generator().manual_seed(0), x[:1])
    tpl.adopt_f32_state(tstate, to_sd(_np(params32)), teng.precision)
    for i in range(4):
        bx, by = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        jstate, jm = jeng.step(jstate, *jeng.shard_batch(bx, by))
        tstate, tm = teng.step(tstate, *teng.shard_batch(bx, by))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   err_msg=f"step {i}", **BF16_LOSS)
    want = to_sd(_np(jstate.params))
    close = total = 0
    for pname, p in tstate.model.named_parameters():
        assert p.dtype == torch.bfloat16, pname
        got, w = p.detach().float().numpy(), want[pname].numpy()
        np.testing.assert_allclose(got, w, err_msg=pname, **BF16_PARAMS_ALL)
        close += int(np.isclose(got, w, **BF16_PARAMS).sum())
        total += got.size
    assert close >= 0.99 * total, (close, total)
    if policy == "bf16-f32master":
        opt = tstate.optimizer
        assert torch.equal(opt.flat, opt.master.to(torch.bfloat16))
    # bytes: params exactly half of f32's; the optimizer as JAX's layout
    # (x1.5 with the master, x0.5 pure bf16), up to the per-tensor Adam
    # step counts torch keeps where optax keeps one count
    j32 = JaxSync(jcls(**kw), mesh=jax_mesh(1))
    j32state = j32.init_state(jax.random.key(0), x[:1])
    t32 = SyncEngine(tcls(**kw, device="cpu"), device="cpu")
    t32state = t32.init_state(torch.Generator().manual_seed(0), x[:1])
    t32state, _ = t32.step(t32state, *t32.shard_batch(x[:8], y[:8]))
    assert 2 * teng.param_bytes_per_device(tstate) == \
        t32.param_bytes_per_device(t32state) == \
        j32.param_bytes_per_device(j32state)
    assert teng.param_bytes_per_device(tstate) == \
        jeng.param_bytes_per_device(jstate)
    want_ratio = (jeng.opt_state_bytes_per_device(jstate)
                  / j32.opt_state_bytes_per_device(j32state))
    got_ratio = (teng.opt_state_bytes_per_device(tstate)
                 / t32.opt_state_bytes_per_device(t32state))
    assert abs(got_ratio - want_ratio) < 2e-3 * want_ratio, (got_ratio,
                                                             want_ratio)
    assert abs(want_ratio - (1.5 if "master" in policy else 0.5)) < 1e-2


# ------------------------------------ the reduce and grad_accum under a policy

@pytest.mark.parametrize("policy", ["bf16-f32master", "fp16-f32master"])
def test_sync_reduce_and_grad_accum_under_16_bit_policies(policy):
    """On a 1-rank gloo group the step reduces its 16-bit gradients in one
    all-reduce of the gradients' dtype and the f32 metrics in a second,
    and gives the no-mesh step's bits; ``grad_accum=2`` (the scaled loss
    of each microbatch accumulated in 16 bits) stays within two 16-bit
    roundings of a gradient times the few Adam steps of lr 1e-3 of the
    single-batch step."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll

    x, y = _images(32)
    kw, _, tcls, _ = NARROW["mlp"]
    dt = DT[policy]

    def run(mesh=None, **eng_kw):
        eng = SyncEngine(tcls(**kw, dropout_rate=0.0, dtype=dt,
                              device="cpu"), mesh=mesh,
                         device=None if mesh else "cpu", precision=policy,
                         **eng_kw)
        state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
        losses = []
        for i in range(4):
            state, m = eng.step(state, *eng.shard_batch(
                x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]))
            losses.append(float(m["loss"]))
        return losses, state.optimizer.master.clone()

    want_losses, want = run()
    mesh = tmesh.create_mesh(1, device="cpu")
    try:
        before = coll.all_reduce_.launches
        got_losses, got = run(mesh)
        assert coll.all_reduce_.launches - before == 2 * 4
    finally:
        mesh.close()
    assert got_losses == want_losses and torch.equal(got, want)
    accum_losses, accum = run(grad_accum=2)
    np.testing.assert_allclose(accum_losses, want_losses, rtol=2e-2)
    np.testing.assert_allclose(accum.numpy(), want.numpy(), rtol=0,
                               atol=4 * 2 * 1e-3)


# ------------------------------------------------ fp16 skip in the Trainer

def test_fp16_skip_through_trainer_matches_jax_loss_scale_section():
    """One batch with a NaN feature lands at step 3 of 8: both Trainers
    skip it, back the scale off, and finish all 8 steps; the port's
    section is the same at steps_per_call 1 and 8."""
    x, y = _images(64, seed=5)
    ds = tloaders.Dataset(x=x, y=y, num_classes=10, name="small")
    third = next(b for i, b in enumerate(
        ds.batches(8, shuffle=True, seed=0, epoch=0, drop_remainder=True))
        if i == 2)[0]
    row = int(np.flatnonzero((x == third[0]).all(axis=(1, 2, 3)))[0])
    x = x.copy()
    x[row, 3, 4, 0] = np.nan
    kw, jcls, tcls, _ = NARROW["mlp"]
    jtr = JaxTrainer(None, engine=JaxSync(
        jcls(**kw, dropout_rate=0.0, dtype=jnp.float16), mesh=jax_mesh(1),
        precision="fp16-f32master"), seed=0)
    want = jtr.fit(jloaders.Dataset(x=x, y=y, num_classes=10),
                   epochs=1, batch_size=8, log_every=0)
    assert want["loss_scale"]["skipped_step_list"] == [3], want["loss_scale"]
    for k in (1, 8):
        ttr = Trainer(None, engine=SyncEngine(
            tcls(**kw, dropout_rate=0.0, dtype=torch.float16, device="cpu"),
            device="cpu", precision="fp16-f32master"), seed=0)
        got = ttr.fit(tloaders.Dataset(x=x, y=y, num_classes=10), epochs=1,
                      batch_size=8, log_every=1, log_fn=lambda _: None,
                      steps_per_call=k)
        assert got["steps"] == want["steps"] == 8
        assert got["loss_scale"] == want["loss_scale"], k
        assert got["precision"] == want["precision"] == "fp16-f32master"
        assert got["param_bytes_per_device"] == \
            want["param_bytes_per_device"]


# --------------------------------------- async under a master policy, 2 ranks

ASYNC_WORLD, ASYNC_STEPS, SYNC_EVERY, ASYNC_LR = 2, 4, 2, 0.1


def _async_data():
    rng = np.random.default_rng(0)
    x = rng.random((4 * 16, 6, 5, 1), dtype=np.float32)
    y = rng.integers(0, 4, 4 * 16).astype(np.int32)
    return x, y


def _async_rank(rank: int, port: int, state_dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    tmesh.init_process_group("cpu", ASYNC_WORLD, rank,
                             f"tcp://127.0.0.1:{port}")
    try:
        mesh = tmesh.create_mesh(ASYNC_WORLD, device="cpu")
        eng = AsyncLocalEngine(
            MLP(num_classes=4, hidden=32, dropout_rate=0.0,
                dtype=torch.bfloat16, device="cpu"), mesh=mesh,
            optimizer=lambda p: torch.optim.SGD(p, lr=ASYNC_LR),
            sync_every=SYNC_EVERY, precision="bf16-f32master")
        x, y = _async_data()
        state = eng.init_state(torch.Generator().manual_seed(0), x)
        tpl.adopt_f32_state(state, state_dict, eng.precision)
        out = {}
        for i in range(ASYNC_STEPS):
            state, _ = eng.step(state, *eng.shard_batch(
                x[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)]))
            out[f"{i + 1}/params"] = state.optimizer.flat.float().numpy()
            out[f"{i + 1}/master"] = state.optimizer.master.numpy().copy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _flat(sd, order):
    return np.concatenate([sd[k].numpy().reshape(-1) for k in order])


@pytest.fixture(scope="module")
def async_master_run(tmp_path_factory):
    x, y = _async_data()
    jeng = JaxAsync(JaxMLP(num_classes=4, hidden=32, dropout_rate=0.0,
                           dtype=jnp.bfloat16),
                    optimizer=optax.sgd(ASYNC_LR), mesh=jax_mesh(ASYNC_WORLD),
                    sync_every=SYNC_EVERY, precision="bf16-f32master")
    state = jeng.init_state(jax.random.key(0), x)
    jm = jpl._find_master(state.opt_state)[0].master
    init = mlp_state_dict(_np(jax.tree.map(lambda a: a[0], jm)))
    order = [n for n, _ in MLP(num_classes=4, hidden=32, device="cpu")
             .named_parameters()]
    want = []
    for i in range(ASYNC_STEPS):
        state, _ = jeng.step(state, *jeng.shard_batch(
            x[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)]))
        master = jpl._find_master(state.opt_state)[0].master
        want.append([
            {"params": _flat(mlp_state_dict(_np(jax.tree.map(
                lambda a: a[r], state.params))), order),
             "master": _flat(mlp_state_dict(_np(jax.tree.map(
                 lambda a: a[r], master))), order)}
            for r in range(ASYNC_WORLD)])
    out = tmp_path_factory.mktemp("async_master")
    mp.spawn(_async_rank, args=(tmesh.free_port(), init, str(out)),
             nprocs=ASYNC_WORLD, join=True)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(ASYNC_WORLD)]
    return want, ranks


# SGD of lr 0.1 on bf16 gradients (of order 1 and less) that the two
# frameworks may round to neighbouring bf16 values: the f32 masters part
# by lr times one bf16 rounding (2^-8) of a gradient per step, 4e-4 a
# step; the bf16 params by that and one bf16 rounding of their own
ASYNC_MASTER = dict(rtol=0, atol=ASYNC_STEPS * 4e-4)
ASYNC_PARAMS = dict(rtol=2 ** -7, atol=ASYNC_STEPS * 4e-4)


def test_async_master_policy_ranks_equal_jax_rows(async_master_run):
    want, ranks = async_master_run
    for s in range(1, ASYNC_STEPS + 1):
        for r, got in enumerate(ranks):
            for key, tol in (("params", ASYNC_PARAMS),
                             ("master", ASYNC_MASTER)):
                np.testing.assert_allclose(
                    got[f"{s}/{key}"], want[s - 1][r][key],
                    err_msg=f"rank {r} step {s} {key}", **tol)
        a, b = ranks
        ja, jb = want[s - 1]
        if s % SYNC_EVERY == 0:
            # the mean reaches the bf16 params, never the f32 master
            np.testing.assert_array_equal(a[f"{s}/params"], b[f"{s}/params"])
            np.testing.assert_array_equal(ja["params"], jb["params"])
        assert np.abs(a[f"{s}/master"] - b[f"{s}/master"]).max() > 1e-3
        assert np.abs(ja["master"] - jb["master"]).max() > 1e-3
        if s % SYNC_EVERY:
            # between syncs each rank's params are its downcast master
            for got in ranks:
                np.testing.assert_array_equal(
                    got[f"{s}/params"],
                    torch.from_numpy(got[f"{s}/master"]).to(torch.bfloat16)
                    .float().numpy())


# -------------------------------------------------------- flash on float16

@pytest.mark.parametrize("policy", ["fp16-f32master", "bf16-f32master"])
def test_gpt_flash_under_16_bit_policies_matches_flax(policy):
    """A 2-layer narrow GPT with flash attention, parameters stored and
    computed in the policy's 16-bit type on both sides (the flax model's
    flash path is the Pallas kernel in interpret mode): the loss and each
    parameter's gradient.  16-bit rounding at every layer, summed in other
    orders: loss within 1% (bf16) / 0.2% (fp16), each gradient within a
    relative Frobenius error of 5% (bf16) / 1% (fp16) of its norm."""
    import optax as _optax

    from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
    from distributed_tensorflow_tpu_torch.models.convert import (
        gpt_state_dict)
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    small = dict(vocab_size=64, hidden=64, layers=2, heads=4, ffn=128,
                 max_len=32, dropout_rate=0.0, attention_impl="flash")
    jdt = jnp.float16 if policy.startswith("fp16") else jnp.bfloat16
    tdt = DT[policy]
    jm = JaxGPT(**small, dtype=jdt)
    params32 = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                       train=False)["params"]
    params = jpl.make_policy(policy).cast_params(params32)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 64, (2, 32)).astype(np.int32)
    labels = rng.integers(0, 64, (2, 32)).astype(np.int32)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids), train=True)
        return _optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(labels)).mean()

    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    want = gpt_state_dict(_np(grads))
    tm = GPTLM(**small, dtype=tdt, device="cpu")
    tm.load_state_dict(gpt_state_dict(_np(params32)))
    tpl.make_policy(policy).cast_params(tm)
    logits = tm(torch.from_numpy(ids), train=True)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(labels).long().reshape(-1))
    loss.backward()
    fp16 = tdt == torch.float16
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=2e-3 if fp16 else 1e-2)
    for name, p in tm.named_parameters():
        assert p.dtype == tdt and p.grad.dtype == tdt, name
        if name.endswith("attn.key.bias"):
            continue    # zero in exact arithmetic: rounding noise on both
        g, w = p.grad.float(), want[name]
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= (1e-2 if fp16 else 5e-2), (name, rel)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_float16_matches_pallas_kernels(causal):
    """float16 q/k/v through the port's flash route (the plain versions
    on the CPU) against the Pallas kernels in interpret mode: forward and
    dQ/dK/dV of a weighted sum.  Both compute in f32 and round the outputs
    to float16 (relative 2^-11), so they agree within two fp16 roundings
    of the outputs' scale."""
    rng = np.random.default_rng(4)
    b, l, h, d = 2, 96, 2, 64
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float16)
               for _ in range(3))
    w = rng.normal(size=(b, l, h, d)).astype(np.float32)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, block_q=32,
                                  block_k=32, interpret=True)
        return (out.astype(jnp.float32) * w).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == torch.float16
    (out.float() * torch.from_numpy(w)).sum().backward()
    for name, got, want in (("out", out, jout), ("dq", tq.grad, jgrads[0]),
                            ("dk", tk.grad, jgrads[1]),
                            ("dv", tv.grad, jgrads[2])):
        assert got.dtype == torch.float16, name
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=2 ** -10, atol=2 ** -10 * scale,
                                   err_msg=name)


def test_flash_route_takes_float16_to_tensor_cores():
    for d in (16, 64, 128):
        assert tfa._route(torch.float16, d) == "tc"
    for d in (8, 72, 256):
        assert tfa._route(torch.float16, d) == "simt"
    assert tfa._DTYPES[torch.float16] == 2
    before = tfa.flash_attention.fwd_f16_launches
    q = torch.zeros(1, 16, 1, 64, dtype=torch.float16)
    tfa.flash_attention(q, q, q)
    assert tfa.flash_attention.fwd_f16_launches == before   # CPU: no launch


# ------------------------------------------------------- harness and CLI

def test_harness_precision_resolves_the_model_dtype():
    cfg = harness.ExperimentConfig(precision="bf16-f32master")
    assert harness._resolve_precision(cfg).dtype == "bfloat16"
    cfg = harness.ExperimentConfig(precision="fp16-f32master",
                                   dtype="float16")
    assert harness._resolve_precision(cfg).dtype == "float16"
    with pytest.raises(ValueError, match="conflicts"):
        harness._resolve_precision(harness.ExperimentConfig(
            precision="bf16", dtype="float16"))
    cfg = harness.ExperimentConfig(dtype="bfloat16")
    assert harness._resolve_precision(cfg) is cfg
    with pytest.raises(ValueError, match="known:"):
        harness._resolve_precision(harness.ExperimentConfig(precision="x"))


def test_cli_precision_runs_and_reports(capsys):
    def data(batch_size, type="train"):
        n = 64 if type == "train" else 16
        x, y = _images(n, seed=11 if type == "train" else 12)
        return tloaders.Dataset(x=x, y=y, num_classes=10, name="small",
                                synthetic=True)

    parser = tcli.build_parser()
    assert parser.parse_args(["--precision", "fp16-f32master"]).precision \
        == "fp16-f32master"
    with pytest.raises(SystemExit):
        parser.parse_args(["--precision", "bf8"])
    summary = tcli.main(["-m", "c", "-cs", "sync", "-n", "1", "-b", "16",
                         "--model", "mlp", "--log-every", "0", "--device",
                         "cpu", "--precision", "fp16-f32master"],
                        dataset_fn=data)
    rr = summary["run_report"]
    assert summary["precision"] == rr["precision"] == "fp16-f32master"
    assert rr["loss_scale"]["skipped_steps"] == 0
    assert rr["loss_scale"]["final_scale"] == 2.0 ** 15
    # the default MLP (hidden 512) on 12x12 inputs, in float16
    assert rr["param_bytes_per_device"] == 2 * (144 * 512 + 512 + 5120 + 10)
    assert np.isfinite(summary["test_loss"])
