"""The health layer (``observability/health.py``) and its wiring through
the engines, the Trainer, the checkpoint and the CLI, held to the JAX
package on the CPU at small sizes:

* ``global_norm`` and ``nonfinite_leaf_count`` on the same arrays;
* the capture around a torch Adam against JAX's
  ``wrap_optimizer(optax.adam)`` over 3 steps on the same parameters and
  gradients: the norms and the ratio within rtol 1e-5 (f32; optax and
  torch round Adam's update differently, port ``engines/base.py``), the
  non-finite count exact; the injection poisons exactly its step;
* ``ema_spike`` and ``detect_anomalies`` on the same inputs;
* a ``SyncEngine`` with health against JAX's with health, step by step on
  the same MLP weights and batches (an MLP: every parameter gets a
  gradient, where a GPT's attention key bias gets none and Adam turns its
  rounding noise into ±lr steps whose signs differ between the two
  frameworks);
* a GPT-tiny fit with health on and off gives bitwise the same losses,
  and the health streams are bitwise at k = 8 and k = 1;
* the policy: ``'halt'`` at the injected step with its record logged,
  ``'warn'`` fatal under the nan-guard default, ``'warn'`` with
  ``nan_guard=False`` completing with JAX's ``health`` keys;
* under ``fp16-f32master`` ``grad_norm`` is JAX's (divided by the
  entering loss scale), and a step the scaler skipped does not halt;
* ``enable_health`` after ``init_state`` raises JAX's message; the
  capture's count rides the checkpoint, and a resume across a health
  toggle raises JAX's message;
* the three CLI flags parse as JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from distributed_tensorflow_tpu.data import loaders as jloaders
from distributed_tensorflow_tpu.engines.allreduce import Trainer as JaxTrainer
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu.models.mlp import MLP as JaxMLP
from distributed_tensorflow_tpu.observability import health as jhl
from distributed_tensorflow_tpu.parallel import precision as jpl
from distributed_tensorflow_tpu.parallel.mesh import create_mesh
from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.models.convert import mlp_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.models.mlp import MLP
from distributed_tensorflow_tpu_torch.observability import health as hl
from distributed_tensorflow_tpu_torch.parallel import precision as tpl
from distributed_tensorflow_tpu_torch.utils.failure import AnomalyDetected

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0, attention_impl="flash")
# f32 norms summed in other orders, and Adam's update rounded differently
# by optax and torch: relative 1e-5
STATS = dict(rtol=1e-5, atol=0)
NORM_KEYS = ("grad_norm", "param_norm", "update_norm", "update_ratio")


def _arrays(seed=0, shapes=((16, 12), (12,), (4, 4, 5)), scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


# the port's update is new − old in f32, JAX's the emitted u: they differ
# by one rounding of p + u, relative eps·|p|/|u| — parameters at an init's
# scale (0.1) under Adam at lr 1e-2 keep that under 1e-6
PARAM_SCALE = 0.1


# ----------------------------------------------------------- the helpers

@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_norm_and_nonfinite_count_match_jax(poison):
    arrays = _arrays(1)
    if poison is not None:
        arrays[1][2] = float(poison)
    want_n = float(jhl.global_norm([jnp.asarray(a) for a in arrays]))
    got_n = float(hl.global_norm([torch.from_numpy(a) for a in arrays]))
    if poison is None:
        np.testing.assert_allclose(got_n, want_n, **STATS)
    else:
        assert not math.isfinite(got_n) and not math.isfinite(want_n)
    ints = [np.arange(3, dtype=np.int32)]
    want_c = int(jhl.nonfinite_leaf_count(
        [jnp.asarray(a) for a in arrays + ints]))
    got_c = int(hl.nonfinite_leaf_count(
        [torch.from_numpy(a) for a in arrays + ints]))
    assert got_c == want_c == (0 if poison is None else 1)
    # bf16 leaves accumulate in f32 on both sides
    bf = [a.astype(jnp.bfloat16) for a in arrays]
    np.testing.assert_allclose(
        float(hl.global_norm([torch.from_numpy(np.asarray(b, np.float32))
                              .bfloat16() for b in bf])),
        float(jhl.global_norm([jnp.asarray(b) for b in bf])), **STATS)


def _jax_adam_run(params, grads_seq, cfg):
    tx = jhl.wrap_optimizer(optax.adam(1e-2), cfg)
    p = [jnp.asarray(a) for a in params]
    state = tx.init(p)
    out = []
    for grads in grads_seq:
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, p)
        p = optax.apply_updates(p, upd)
        out.append({k: float(v) for k, v in jhl.from_opt_state(
            state).items()})
    return out


def _port_adam_run(params, grads_seq, cfg):
    ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = torch.optim.Adam(ps, lr=1e-2)
    hl.wrap_optimizer(opt, cfg, ps)
    out = []
    for grads in grads_seq:
        for p, g in zip(ps, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        out.append({k: float(v) for k, v in hl.from_opt_state(opt).items()})
    return out, opt


def test_wrapped_adam_stats_match_jax_wrap_optimizer():
    params = _arrays(2, scale=PARAM_SCALE)
    grads_seq = [_arrays(10 + i) for i in range(3)]
    cfg = hl.HealthConfig()
    want = _jax_adam_run(params, grads_seq, jhl.HealthConfig())
    got, opt = _port_adam_run(params, grads_seq, cfg)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in NORM_KEYS:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"{k} step {i}",
                                       **STATS)
        assert g["nonfinite_count"] == w["nonfinite_count"] == 0
    assert int(opt.health_capture.count) == 3
    # the capture leaves the optimizer what it was
    assert isinstance(opt, torch.optim.Adam)


def test_injection_poisons_exactly_its_step():
    params = _arrays(3, scale=PARAM_SCALE)
    grads_seq = [_arrays(20 + i) for i in range(3)]
    want = _jax_adam_run(params, grads_seq,
                         jhl.HealthConfig(inject_nan_at=2))
    got, _ = _port_adam_run(params, grads_seq, hl.HealthConfig(
        inject_nan_at=2))
    for k in NORM_KEYS:
        np.testing.assert_allclose(got[0][k], want[0][k], **STATS)
    for g, w in zip(got[1:], want[1:]):
        assert math.isinf(g["grad_norm"]) == math.isinf(w["grad_norm"])
        assert not math.isfinite(g["update_norm"])
        assert g["nonfinite_count"] == w["nonfinite_count"] == 3
    # a finite scale: only step 2's gradients scaled
    want = _jax_adam_run(params, grads_seq, jhl.HealthConfig(
        inject_nan_at=2, inject_scale=4.0))
    got, _ = _port_adam_run(params, grads_seq, hl.HealthConfig(
        inject_nan_at=2, inject_scale=4.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], **STATS)
    base, _ = _port_adam_run(params, grads_seq, hl.HealthConfig())
    np.testing.assert_allclose(got[1]["grad_norm"],
                               4 * base[1]["grad_norm"], **STATS)
    assert got[0]["grad_norm"] == base[0]["grad_norm"]


def test_ema_spike_matches_jax():
    cfg, jcfg = hl.HealthConfig(), jhl.HealthConfig()
    ema, jema = hl.ema_init(), jhl.ema_init()
    for i, loss in enumerate([2.0, 1.9, 1.7, 30.0, 1.5]):
        spike = hl.ema_update_(torch.tensor(loss), ema, cfg)
        jspike, jema = jhl.ema_spike(jnp.float32(loss), jema, jcfg)
        if i == 0:
            assert float(spike) == float(jspike) == 1.0
        np.testing.assert_allclose(float(spike), float(jspike), **STATS)
        np.testing.assert_allclose(float(ema[0]), float(jema[0]), **STATS)
        assert int(ema[1]) == int(jema[1]) == i + 1


ANOMALY_CASES = [
    {"loss": 2.0, "grad_norm": 1.0, "update_ratio": 0.01,
     "nonfinite_count": 0, "loss_spike": 1.0},
    {"loss": float("nan"), "grad_norm": float("inf"),
     "update_ratio": float("nan"), "nonfinite_count": 3,
     "loss_spike": float("nan")},
    {"loss": 2.0, "grad_norm": 50.0, "update_ratio": 3.0,
     "nonfinite_count": 0, "loss_spike": 12.0},
    {"loss": 2.0, "ls_skipped": 1},
    {},
]


@pytest.mark.parametrize("case", range(len(ANOMALY_CASES)))
@pytest.mark.parametrize("ceiling", [None, 10.0])
def test_detect_anomalies_matches_jax(case, ceiling):
    floats = ANOMALY_CASES[case]
    got = hl.detect_anomalies(floats, hl.HealthConfig(
        max_grad_norm=ceiling))
    want = jhl.detect_anomalies(floats, jhl.HealthConfig(
        max_grad_norm=ceiling))
    assert repr(got) == repr(want)


# ------------------------------------------------------------ the engines

def _mlp_data(n=32, seed=3):
    x, y = jloaders.synthetic_classification((6, 5), 10, n, seed=seed,
                                             split="train")
    return x.reshape((n, 30)), y


def _mlp_pair(precision="f32"):
    """The JAX and the port sync engines with health on, over the same
    f32 MLP weights (JAX's init; a master policy adopts them)."""
    x, _ = _mlp_data()
    dtype = {"f32": (jnp.float32, torch.float32),
             "fp16-f32master": (jnp.float16, torch.float16)}[precision]
    jeng = JaxSync(JaxMLP(num_classes=10, hidden=32, dropout_rate=0.0,
                          dtype=dtype[0]), mesh=create_mesh(1),
                   precision=precision)
    jeng.enable_health()
    params32 = JaxMLP(num_classes=10, hidden=32, dropout_rate=0.0).init(
        jax.random.key(0), jnp.asarray(x[:1]), train=False)["params"]
    jstate = jeng.init_state(jax.random.key(0), x[:1])
    if precision == "f32":
        jstate = jstate.replace(params=params32)
    else:
        restored = jpl.f32_template(jstate).replace(params=params32)
        jstate = jpl.adopt_f32_state(jstate, restored, jeng.precision)
    teng = SyncEngine(MLP(num_classes=10, hidden=32, dropout_rate=0.0,
                          dtype=dtype[1], device="cpu"), device="cpu",
                      precision=precision)
    teng.enable_health()
    tstate = teng.init_state(torch.Generator().manual_seed(0), x[:1])
    sd = mlp_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     params32))
    if precision == "f32":
        tstate.model.load_state_dict(sd)
    else:
        tpl.adopt_f32_state(tstate, sd, teng.precision)
    return jeng, jstate, teng, tstate


def test_sync_engine_health_matches_jax_step_by_step():
    jeng, jstate, teng, tstate = _mlp_pair()
    x, y = _mlp_data()
    for i in range(4):
        bx, by = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        jstate, jm = jeng.step(jstate, *jeng.shard_batch(bx, by))
        tstate, tm = teng.step(tstate, *teng.shard_batch(bx, by))
        assert set(tm) == set(jm)
        for k in NORM_KEYS + ("loss_spike",):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       err_msg=f"{k} step {i}", **STATS)
        assert int(tm["nonfinite_count"]) == int(jm["nonfinite_count"]) == 0
        if i == 0:
            assert float(tm["loss_spike"]) == 1.0


def test_fp16_grad_norm_is_unscaled_as_jax():
    """``grad_norm`` divided by the scale each step entered with (2^15,
    the init scale): the fp16 forward of the two frameworks rounds
    differently, so within relative 2e-3."""
    jeng, jstate, teng, tstate = _mlp_pair("fp16-f32master")
    x, y = _mlp_data()
    for i in range(3):
        bx, by = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        jstate, jm = jeng.step(jstate, *jeng.shard_batch(bx, by))
        tstate, tm = teng.step(tstate, *teng.shard_batch(bx, by))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-3,
                                   err_msg=f"step {i}")
        assert float(tm["grad_norm"]) < 100.0     # unscaled
        assert float(tm["loss_scale"]) == float(jm["loss_scale"])


def _lm_ds(n=64, seed=3):
    x, y = jloaders.synthetic_lm(n, seq_len=32, vocab_size=64, seed=seed,
                                 split="train")
    return x, y


class _Records:
    """A metrics logger keeping every record in memory."""

    def __init__(self):
        self.records: list = []

    def should_log(self, step):
        return True

    def log(self, step, **metrics):
        self.records.append((step, metrics))

    def flush(self):
        pass


def _gpt_fit(health=None, k=8, **kw):
    x, y = _lm_ds()
    eng = SyncEngine(GPTLM(**SMALL, device="cpu"), device="cpu")
    if health is not None:
        eng.enable_health(health)
    rec = _Records()
    trainer = Trainer(None, engine=eng, seed=0)
    kw.setdefault("log_fn", lambda _: None)
    result = trainer.fit(tloaders.Dataset(x=x, y=y, num_classes=64),
                         batch_size=8, log_every=0, steps_per_call=k,
                         metrics_logger=rec, **kw)
    return result, rec.records


def test_gpt_health_leaves_losses_bitwise_and_streams_k_invariant():
    _, off = _gpt_fit()
    r8, on8 = _gpt_fit(hl.HealthConfig())
    _, on1 = _gpt_fit(hl.HealthConfig(), k=1)
    assert [m["loss"] for _, m in off] == [m["loss"] for _, m in on8]
    assert len(on8) == len(on1) == 8
    for (s8, m8), (s1, m1) in zip(on8, on1):
        assert s8 == s1 and set(hl.HEALTH_KEYS) <= set(m8)
        assert {k: m8[k] for k in hl.HEALTH_KEYS} == \
            {k: m1[k] for k in hl.HEALTH_KEYS}, s8
    assert r8["health"]["anomalies"] == 0
    assert r8["health"]["max_grad_norm"] == max(m["grad_norm"]
                                                for _, m in on8)


def test_policy_halts_warns_and_observes_at_the_injected_step():
    cfg = hl.HealthConfig(inject_nan_at=5)
    with pytest.raises(AnomalyDetected, match="at step 5: .*halted by "
                       "on_anomaly='halt'"):
        _gpt_fit(cfg, on_anomaly="halt")
    # the record of step 5 reached the logger before the raise
    rec = _Records()
    x, y = _lm_ds()
    eng = SyncEngine(GPTLM(**SMALL, device="cpu"), device="cpu")
    eng.enable_health(cfg)
    with pytest.raises(AnomalyDetected):
        Trainer(None, engine=eng, seed=0).fit(
            tloaders.Dataset(x=x, y=y, num_classes=64), batch_size=8,
            log_every=0, metrics_logger=rec, on_anomaly="halt")
    assert rec.records[-1][0] == 5
    assert rec.records[-1][1]["nonfinite_count"] > 0
    with pytest.raises(AnomalyDetected, match="training diverged at step 5"
                       ".*fatal under the nan-guard default"):
        _gpt_fit(cfg)
    lines: list = []
    r, records = _gpt_fit(cfg, nan_guard=False, log_fn=lines.append)
    assert r["steps"] == 8
    assert r["health"]["first_anomaly_step"] == 5
    assert r["health"]["anomaly_steps"] == [5, 6, 7, 8]
    assert r["health"]["anomalies"] >= 1
    assert sum("ANOMALY" in ln for ln in lines) == 1
    # JAX's Trainer gives the same section keys and anomaly steps
    x, y = _lm_ds()
    jeng = JaxSync(JaxGPT(**SMALL), mesh=create_mesh(1))
    jeng.enable_health(jhl.HealthConfig(inject_nan_at=5))
    want = JaxTrainer(None, engine=jeng, seed=0).fit(
        jloaders.Dataset(x=x, y=y, num_classes=64), batch_size=8,
        log_every=0, nan_guard=False, log_fn=lambda _: None)
    assert set(r["health"]) == set(want["health"])
    for key in ("on_anomaly", "anomaly_steps", "first_anomaly_step"):
        assert r["health"][key] == want["health"][key], key


def test_fp16_skipped_step_does_not_halt():
    """The injection makes step 3's gradients infinite under
    ``fp16-f32master``: the scaler skips the step (its loss is finite),
    and the health policy records the anomalies but, as JAX's, does not
    halt on a skipped step; both Trainers report the same skip and
    anomaly steps."""
    x, y = _mlp_data(64, seed=5)
    eng = SyncEngine(MLP(num_classes=10, hidden=32, dropout_rate=0.0,
                         dtype=torch.float16, device="cpu"), device="cpu",
                     precision="fp16-f32master")
    eng.enable_health(hl.HealthConfig(inject_nan_at=3))
    r = Trainer(None, engine=eng, seed=0).fit(
        tloaders.Dataset(x=x, y=y, num_classes=10), batch_size=8,
        log_every=0, on_anomaly="halt")
    jeng = JaxSync(JaxMLP(num_classes=10, hidden=32, dropout_rate=0.0,
                          dtype=jnp.float16), mesh=create_mesh(1),
                   precision="fp16-f32master")
    jeng.enable_health(jhl.HealthConfig(inject_nan_at=3))
    want = JaxTrainer(None, engine=jeng, seed=0).fit(
        jloaders.Dataset(x=x, y=y, num_classes=10), batch_size=8,
        log_every=0, on_anomaly="halt")
    assert r["steps"] == want["steps"] == 8
    assert r["loss_scale"]["skipped_step_list"] == \
        want["loss_scale"]["skipped_step_list"] == [3]
    for key in ("anomaly_steps", "first_anomaly_step", "anomalies"):
        assert r["health"][key] == want["health"][key], key
    assert r["health"]["first_anomaly_step"] == 3


# ------------------------------------------------------- order and resume

def test_enable_health_after_init_state_raises_jax_message():
    eng = SyncEngine(GPTLM(**SMALL, device="cpu"), device="cpu")
    eng.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match=r"enable_health\(\) must run "
                       "before the engine builds its step program"):
        eng.enable_health()
    # a state built before it has no capture: JAX's message at first read
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(ValueError, match="no health capture state"):
        hl.from_opt_state(opt)
    # once on, a second call returns the config
    eng = SyncEngine(GPTLM(**SMALL, device="cpu"), device="cpu")
    cfg = eng.enable_health()
    assert eng.enable_health() is cfg


def test_health_count_rides_the_checkpoint_and_a_toggle_refuses(tmp_path):
    from distributed_tensorflow_tpu_torch.utils import harness

    x, y = _mlp_data()

    def engine(health):
        eng = SyncEngine(MLP(num_classes=10, hidden=16, dropout_rate=0.0,
                             device="cpu"), device="cpu")
        if health:
            eng.enable_health()
        return eng, eng.init_state(torch.Generator().manual_seed(0), x[:1])

    eng, state = engine(True)
    for i in range(3):
        state, _ = eng.step(state, *eng.shard_batch(x[8 * i:8 * i + 8],
                                                    y[8 * i:8 * i + 8]))
    saved = eng.checkpoint_state(state)
    assert int(saved["health/count"]) == 3
    eng2, state2 = engine(True)
    eng2.load_checkpoint_state(state2, saved)
    assert int(state2.optimizer.health_capture.count) == 3
    eng3, state3 = engine(False)
    with pytest.raises(ValueError, match="unexpected .*health/count"):
        eng3.load_checkpoint_state(state3, saved)

    def config(**kw):
        return harness.ExperimentConfig(
            engine="sync", model="mlp", dataset="synthetic",
            dataset_fn=lambda batch, type: tloaders.Dataset(  # noqa: A006
                *_mlp_data(64 if type == "train" else 16), num_classes=10),
            model_args={"hidden": 16}, n_devices=1, batch_size=8, epochs=1,
            log_every=0, eval_batch=16, device="cpu", steps_per_call=4,
            checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4, **kw)

    first = harness.run(config(health="on"))
    assert first["run_report"]["health"]["anomalies"] == 0
    assert harness.run(config(health="on", resume=True))["steps"] == 8
    with pytest.raises(ValueError, match="--health off.*different --health "
                       "setting"):
        harness.run(config(resume=True))


def test_cli_health_flags_parse_as_jax():
    from distributed_tensorflow_tpu.cli import build_parser as jax_parser

    from distributed_tensorflow_tpu_torch.cli import build_parser

    dests = ("health", "on_anomaly", "no_nan_guard")
    for argv in ([], ["--health", "on", "--on-anomaly", "halt",
                      "--no-nan-guard"]):
        a, b = build_parser().parse_args(argv), jax_parser().parse_args(argv)
        assert [getattr(a, d) for d in dests] == [getattr(b, d)
                                                  for d in dests], argv
    for bad in (["--health", "maybe"], ["--on-anomaly", "stop"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(bad)
