"""Port of the harness's LM path (``utils/harness.py``, ``utils/optim.py``,
``cli.py``, ``observability/{slo,report}.py``): the optimizer recipe,
``--positional``/``--kv-heads``, ``--sample`` and the ``--serve`` window,
held to the JAX package at small sizes on the CPU:

* ``make_lr_schedule`` against optax for constant, cosine and linear ×
  warmup {0, 3} × horizon {1, 10} at counts 0 … horizon + 2: within 2 f32
  ulps, plus ``lr · 2^-24`` for cosine: the port evaluates cos in torch,
  XLA in its own code, and one rounding of a cosine near -1 (about 2^-24)
  is carried through ``½ (1 + cos)``, where it is several ulps of the
  small result;
* ``_decay_mask`` against JAX's on ``gpt_tiny``, ``bert_tiny``, ``cnn``,
  ``resnet20`` and ``mlp`` through ``models/convert.py``'s names, equal;
* five ``ScheduledAdamW`` steps on converted GPT parameters, fed the same
  gradients, against ``optax.chain(clip_by_global_norm, adamw(mask))``
  with the clip firing and ``wd = 0.1``, at f32 and under
  ``bf16-f32master`` (the flat master's mask): ``rtol=1e-5, atol=1e-7``
  (Adam's division and square root round in another order in each
  framework);
* a skipped ``fp16-f32master`` step leaves the schedule's count and every
  inner tensor bitwise as they were;
* ``_sample_from_state`` and ``_serve_from_state`` on converted parameters
  against JAX's, greedy at f32: samples and token streams bitwise, the
  serve section's key set JAX's (monolithic with a prefix pool, a shared
  prefix, chunked prefill and a ``self`` draft; paged with a prefix pool
  and a shared prefix);
* every ``ValueError`` of ``_validate_sampling``/``_validate_serving``
  raised as JAX raises it; each fleet flag of item 10b raising
  ``NotImplementedError`` naming its ROADMAP item;
* ``SLOMonitor`` against JAX's on seeded observations with sheds;
* the CLI: the new flags reach the config as the JAX CLI's do, and one
  ``cli.main --device cpu`` run of a small ``gpt_tiny`` with the recipe,
  ``--sample`` and a paged ``--serve`` window.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from distributed_tensorflow_tpu import cli as jcli
from distributed_tensorflow_tpu import models as jmodels
from distributed_tensorflow_tpu import serving as jserving
from distributed_tensorflow_tpu.observability.slo import SLOMonitor as JaxSLO
from distributed_tensorflow_tpu.observability.trace import (
    NULL_TRACER as JAX_NULL_TRACER)
from distributed_tensorflow_tpu.parallel.mesh import create_mesh as jax_mesh
from distributed_tensorflow_tpu.utils import harness as jharness
from distributed_tensorflow_tpu_torch import cli as tcli
from distributed_tensorflow_tpu_torch import models as tmodels
from distributed_tensorflow_tpu_torch import serving as tserving
from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.observability import SLOMonitor
from distributed_tensorflow_tpu_torch.parallel import precision as tprecision
from distributed_tensorflow_tpu_torch.utils import harness as tharness
from distributed_tensorflow_tpu_torch.utils.optim import ScheduledAdamW

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

F32_ULP = 2.0 ** -23
STEP_TOL = dict(rtol=1e-5, atol=1e-7)
SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0)


# ------------------------------------------------------------- schedules

@pytest.mark.parametrize("horizon", [1, 10])
@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
def test_lr_schedule_matches_optax(schedule, warmup, horizon):
    lr = 1e-3
    jcfg = jharness.ExperimentConfig(learning_rate=lr, lr_schedule=schedule,
                                     warmup_steps=warmup)
    tcfg = tharness.ExperimentConfig(learning_rate=lr, lr_schedule=schedule,
                                     warmup_steps=warmup)
    want_fn = jharness.make_lr_schedule(jcfg, horizon)
    got_fn = tharness.make_lr_schedule(tcfg, horizon)
    if schedule == "constant" and warmup == 0:
        assert want_fn is None and got_fn is None
        return
    counts = np.arange(horizon + 3, dtype=np.int32)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(counts)), np.float32)
    got = got_fn(torch.tensor(counts, dtype=torch.float32))
    assert got.dtype == torch.float32
    atol = lr * 2.0 ** -24 if schedule == "cosine" else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=2 * F32_ULP,
                               atol=atol)


def test_unknown_schedule_raises_as_jax():
    for lib in (jharness, tharness):
        with pytest.raises(ValueError, match="unknown lr_schedule 'step'"):
            lib.make_lr_schedule(lib.ExperimentConfig(lr_schedule="step"),
                                 10)


# ------------------------------------------------------------ decay mask

def _mask_case(name):
    """(flax param shapes, port model with its widths inferred,
    converter)."""
    if name == "gpt_tiny":
        x = np.zeros((1, 8), np.int32)
        kw, conv = dict(num_classes=64), convert.gpt_state_dict
    elif name == "bert_tiny":
        x = np.zeros((1, 16), np.int32)
        kw, conv = dict(num_classes=2, vocab_size=64), convert.bert_state_dict
    elif name == "resnet20":
        x = np.zeros((1, 32, 32, 3), np.float32)
        kw, conv = dict(num_classes=10), convert.resnet_state_dict
    else:
        x = np.zeros((1, 28, 28, 1), np.float32)
        kw = dict(num_classes=10)
        conv = (convert.cnn_state_dict if name == "cnn"
                else convert.mlp_state_dict)
    jm = jmodels.create_model(name, **kw)
    params = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x), train=False),
                            jax.random.key(0))["params"]
    tm = tmodels.create_model(name, device="cpu", **kw)
    with torch.no_grad():
        tm(torch.as_tensor(x), train=False)   # lazy widths (MLP, CNN)
    return params, tm, conv


@pytest.mark.parametrize("name", ["gpt_tiny", "bert_tiny", "cnn", "resnet20",
                                  "mlp"])
def test_decay_mask_matches_jax(name):
    params, tm, conv = _mask_case(name)
    # each leaf's flag spread over its shape, so that the converter lays
    # it out as it lays out the parameter
    want = conv(jax.tree.map(lambda keep, p: np.full(p.shape, keep),
                             jharness._decay_mask(params), params))
    got = tharness._decay_mask(tm)
    assert set(got) == set(want)
    assert all(bool(v.all()) or not bool(v.any()) for v in want.values())
    assert {k: bool(v.all()) for k, v in want.items()} == got
    assert any(got.values()) and not all(got.values())


# -------------------------------------------------------- optimizer steps

def _gpt_pair(weight_scale=1.0, **over):
    kw = dict(SMALL, **over)
    jm = jmodels.create_model("gpt", num_classes=kw.pop("vocab_size"), **kw)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * weight_scale
        if path[-1].key in ("kernel", "embedding") else x, params)
    tm = tmodels.create_model("gpt", num_classes=jm.vocab_size, device="cpu",
                              **kw)
    tm.load_state_dict(convert.gpt_state_dict(jax.tree.map(np.asarray,
                                                           params)))
    return jm, params, tm


def _lm_data(rows=16, seq=16, split="train"):
    return tloaders.load_lm_dataset("lm_synth", split=split, seq_len=seq,
                                    vocab_size=64, n_train=rows, n_test=rows)


RECIPE = dict(learning_rate=1e-2, lr_schedule="cosine", warmup_steps=2,
              weight_decay=0.1, clip_norm=0.05, epochs=1)


@pytest.mark.parametrize("precision", ["f32", "bf16-f32master"])
def test_recipe_steps_match_optax(precision):
    """Five steps on the same fixed gradients: the port's recipe optimizer
    against JAX's optax chain (the clip fires at every step: the
    gradients' norm is ~1, the clip 0.05)."""
    _, params, tm = _gpt_pair()
    data = _lm_data(rows=40)          # horizon 40 // 8 = 5 steps
    tx = jharness._make_optimizer(
        jharness.ExperimentConfig(**RECIPE), data, 8)
    factory = tharness._make_optimizer(
        tharness.ExperimentConfig(**RECIPE), data, 8, tm)
    policy = tprecision.make_policy(precision)
    if policy.active:
        # both sides start from the bf16 storage of the weights: the
        # master is its f32 copy
        params = jax.tree.map(
            lambda p: np.asarray(jnp.asarray(p, jnp.bfloat16), np.float32),
            params)
        tm.load_state_dict(convert.gpt_state_dict(params))
        policy.cast_params(tm)
    opt = policy.wrap_optimizer(factory)(list(tm.parameters()))
    inner = tprecision.strip_master(opt)
    assert isinstance(inner, ScheduledAdamW)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(0)
    named = dict(tm.named_parameters())
    for _ in range(5):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32) * 0.02, params)
        if policy.active:   # the master sees the widened 16-bit gradients
            g = jax.tree.map(lambda a: np.asarray(
                jnp.asarray(a, jnp.bfloat16), np.float32), g)
        tg = convert.gpt_state_dict(g)
        assert float(optax.global_norm(g)) > 10 * RECIPE["clip_norm"]
        updates, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, p in named.items():
            p.grad = tg[name].to(p.dtype)
        opt.step()
    want = convert.gpt_state_dict(jax.tree.map(np.asarray, jp))
    if policy.active:
        master, off = opt.master, 0
        for name, p in named.items():
            got = master[off:off + p.numel()].view_as(p)
            np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                       **STEP_TOL, err_msg=name)
            assert torch.equal(p, got.to(p.dtype)), name
            off += p.numel()
    else:
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), **STEP_TOL,
                                       err_msg=name)
    # the decayed kernels moved away from the undecayed update: the mask
    # reaches the flat master's slices
    assert int(inner.state[inner.param_groups[0]["params"][0]]["step"]) == 5


def test_fp16_skip_keeps_schedule_count():
    """A non-finite fp16 step leaves master, count and moments bitwise as
    they were, so the schedule does not advance over a skip."""
    _, _, tm = _gpt_pair()
    data = _lm_data(rows=40)
    factory = tharness._make_optimizer(
        tharness.ExperimentConfig(**RECIPE), data, 8, tm)
    policy = tprecision.make_policy("fp16-f32master")
    policy.cast_params(tm)
    opt = policy.wrap_optimizer(factory)(list(tm.parameters()))
    rng = np.random.default_rng(1)

    def step(bad):
        for p in tm.parameters():
            g = rng.standard_normal(p.shape) * 0.02 * float(opt.loss_scale)
            if bad:
                g.flat[0] = np.inf
            p.grad = torch.tensor(g, dtype=p.dtype)
        opt.step()

    step(False)
    inner = opt.inner
    before = [t.clone() for t in [opt.master, *opt._inner_state()]]
    lr = inner.current_lr().clone()
    step(True)
    assert bool(opt.last_skipped)
    after = [opt.master, *opt._inner_state()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert torch.equal(inner.current_lr(), lr)
    assert int(inner.state[opt.master]["step"]) == 1


def test_no_recipe_keeps_stock_adam():
    """With none of the recipe's flags the engine builds its stock Adam,
    as before the recipe was ported; the recipe's flags build
    ScheduledAdamW, and steps_to_accuracy's horizon is max_steps."""
    data = _lm_data()
    tm = tmodels.create_model("gpt_tiny", num_classes=64, device="cpu")
    assert tharness._make_optimizer(tharness.ExperimentConfig(), data, 8,
                                    tm) is None
    cfg = tharness.ExperimentConfig(model="gpt_tiny", device="cpu",
                                    dataset_fn=_small_lm_fn, batch_size=8)
    ex = tharness._setup(cfg)
    try:
        opt = ex.engine.make_optimizer(list(ex.engine.model.parameters()))
        assert type(opt) is torch.optim.Adam
    finally:
        ex.mesh.close()
    ex = tharness._setup(dataclasses.replace(cfg, weight_decay=0.1))
    try:
        opt = ex.engine.make_optimizer(list(ex.engine.model.parameters()))
        assert isinstance(opt, ScheduledAdamW)
    finally:
        ex.mesh.close()
    seen = []

    def spy(config):
        seen.append(config.schedule_horizon_steps)
        raise RuntimeError("stop")

    orig = tharness._setup
    tharness._setup = spy
    try:
        with pytest.raises(RuntimeError, match="stop"):
            tharness.steps_to_accuracy(cfg, target=0.5, max_steps=77)
    finally:
        tharness._setup = orig
    assert seen == [77]


# ------------------------------------------------------- sample and serve

def _small_lm_fn(batch_size, type="train"):
    return _lm_data(rows=24, seq=16, split=type)


def _jax_ex(jm):
    return types.SimpleNamespace(mesh=jax_mesh(1),
                                 engine=types.SimpleNamespace(model=jm))


def _port_ex(tm, n=1):
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    engine = types.SimpleNamespace(model=tm, eval_params=lambda s: tm,
                                   device=torch.device("cpu"))
    # the run's mesh: the 'data' axis of one rank (no process group: the
    # table reads its layout only)
    mesh = Mesh(rank=0, world_size=1, device=torch.device("cpu"),
                backend="gloo")
    return types.SimpleNamespace(n=n, engine=engine, mesh=mesh)


@pytest.fixture(scope="module")
def lm_pair():
    jm, params, tm = _gpt_pair(weight_scale=3.0)
    test = tloaders.load_lm_dataset("lm_synth", split="test", seq_len=16,
                                    vocab_size=64, n_test=8)
    return jm, params, tm, test


def test_sample_from_state_equals_jax(lm_pair):
    jm, params, tm, test = lm_pair
    jcfg = jharness.ExperimentConfig(model="gpt", sample_tokens=10,
                                     sample_prompt_len=6)
    tcfg = tharness.ExperimentConfig(model="gpt", sample_tokens=10,
                                     sample_prompt_len=6)
    want = jharness._sample_from_state(
        jcfg, _jax_ex(jm), types.SimpleNamespace(params=params), test)
    got = tharness._sample_from_state(tcfg, _port_ex(tm), None, test)
    assert got == want
    assert len(set(got["samples"][0])) > 2


SERVE_CASES = {
    "monolithic-pool-shared-chunk-self": dict(
        serve_slots=3, serve_max_new=6, serve_prompt_len=5,
        serve_prefix_cache=8, serve_prefix_block=4, serve_shared_prefix=8,
        serve_prefill_chunk=4, serve_draft_config="self", serve_draft_k=2),
    "paged-pool-shared": dict(
        serve_slots=3, serve_max_new=6, serve_prompt_len=5,
        serve_prefix_cache=8, serve_prefix_block=4, serve_shared_prefix=8,
        serve_kv_layout="paged"),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_from_state_equals_jax(lm_pair, monkeypatch, case):
    """Seven requests (more than the slots) served from the same weights:
    greedy streams bitwise JAX's, and the serve section's keys JAX's."""
    jm, params, tm, test = lm_pair
    kw = dict(model="gpt", serve_requests=7, **SERVE_CASES[case])
    runs = {}

    def keep(lib, name):
        class Kept(lib.ContinuousBatcher):
            def run(self, requests, *a, **k):
                runs[name] = summary = super().run(requests, *a, **k)
                return summary
        monkeypatch.setattr(lib, "ContinuousBatcher", Kept)

    keep(jserving, "jax")
    keep(tserving, "port")
    want = jharness._serve_from_state(
        jharness.ExperimentConfig(**kw), _jax_ex(jm),
        types.SimpleNamespace(params=params), test, JAX_NULL_TRACER, 1)
    got = tharness._serve_from_state(tharness.ExperimentConfig(**kw),
                                     _port_ex(tm), None, test)
    assert set(got) == set(want)
    streams = [[r.tokens for r in runs[k]["results"]]
               for k in ("jax", "port")]
    assert streams[1] == streams[0]
    assert len({t for s in streams[1] for t in s}) > 3
    for key in ("completed", "prefill_tokens", "decode_tokens",
                "tokens_generated", "serve_kv_layout", "serve_accept_rate"):
        assert got[key] == want[key], key
    assert got["prefix_cache"]["hits"] == want["prefix_cache"]["hits"] > 0
    assert got["slo"]["requests"] == 7
    assert got["serve_goodput_under_slo"] is not None


# ---------------------------------------------------------- validation

SAMPLE_ERRORS = {
    "negative": dict(sample_tokens=-1),
    "prompt-empty": dict(sample_tokens=4, sample_prompt_len=0),
    "prompt-long": dict(sample_tokens=4, sample_prompt_len=17),
    "capacity": dict(sample_tokens=30, sample_prompt_len=8),
}
SERVE_ERRORS = {
    "negative": dict(serve_requests=-1),
    "slots": dict(serve_slots=0),
    "max-new": dict(serve_max_new=0),
    "chunk": dict(serve_prefill_chunk=-1),
    "pool": dict(serve_prefix_cache=-1),
    "block": dict(serve_prefix_block=0),
    "shared": dict(serve_shared_prefix=-1),
    "slo-ttft": dict(serve_slo_ttft=0.0),
    "slo-itl": dict(serve_slo_itl=-1.0),
    "queue-cap": dict(serve_queue_cap=-1),
    "draft-k": dict(serve_draft_k=0),
    "draft-spec": dict(serve_draft_config="depth=3"),
    "draft-value": dict(serve_draft_config="layers=x"),
    "kv-dtype": dict(serve_kv_dtype="fp8"),
    "layout": dict(serve_kv_layout="ragged"),
    "paged-negative": dict(serve_kv_layout="paged", serve_paged_blocks=-1),
    "paged-needs-layout": dict(serve_paged_block=8),
    "paged-divides": dict(serve_kv_layout="paged", serve_paged_block=5),
    "paged-vs-pool": dict(serve_kv_layout="paged", serve_paged_block=8,
                          serve_prefix_cache=4, serve_prefix_block=4),
    "multi-step": dict(serve_multi_step=0),
    "prompt-empty": dict(serve_prompt_len=0),
    "prompt-long": dict(serve_prompt_len=17),
    "capacity": dict(serve_shared_prefix=10, serve_prompt_len=8,
                     serve_max_new=16),
}


def _validation_pair(check, kw, model_name="gpt"):
    """The ValueError each validator raises for ``kw``: (JAX's, port's)."""
    test = tloaders.load_lm_dataset("lm_synth", split="test", seq_len=16,
                                    vocab_size=64, n_test=8)
    if model_name == "gpt":
        jm, _, tm = _gpt_pair()
    else:
        jm = jmodels.create_model(model_name, num_classes=2, vocab_size=64)
        tm = tmodels.create_model(model_name, num_classes=2, vocab_size=64,
                                  device="cpu")
    errs = []
    for lib, ex in ((jharness, _jax_ex(jm)), (tharness, _port_ex(tm))):
        cfg = lib.ExperimentConfig(model=model_name, **kw)
        with pytest.raises(ValueError) as err:
            getattr(lib, check)(cfg, ex, test)
        errs.append(str(err.value))
    return errs


@pytest.mark.parametrize("case", sorted(SAMPLE_ERRORS))
def test_validate_sampling_raises_as_jax(case):
    want, got = _validation_pair("_validate_sampling", SAMPLE_ERRORS[case])
    assert got == want


@pytest.mark.parametrize("case", sorted(SERVE_ERRORS))
def test_validate_serving_raises_as_jax(case):
    want, got = _validation_pair("_validate_serving", SERVE_ERRORS[case])
    assert got == want


@pytest.mark.parametrize("check, kw", [
    ("_validate_sampling", dict(sample_tokens=4)),
    ("_validate_serving", dict(serve_requests=4))])
def test_validators_reject_a_classifier_as_jax(check, kw):
    want, got = _validation_pair(check, kw, model_name="bert_tiny")
    assert got == want


@pytest.mark.parametrize("flag, value", [
    ("--serve-disaggregate", "1:1"), ("--serve-routing", "affinity"),
    ("--serve-autoscale", "1:2")])
def test_fleet_flags_raise_not_ported(flag, value):
    # the fleet's replica flags are ported (tests/test_torch_fleet.py);
    # disaggregation, routing and autoscale wait for item 10b
    argv = ["--device", "cpu", "-n", "1", "--model", "gpt_tiny", "--serve",
            "4", flag] + ([value] if value is not None else [])
    with pytest.raises(NotImplementedError, match="Queue 1: 10b"):
        tcli.main(argv, dataset_fn=_small_lm_fn)


def test_sample_needs_a_causal_lm_before_setup():
    cfg = tharness.ExperimentConfig(model="mlp", sample_tokens=4,
                                    device="cpu")
    with pytest.raises(ValueError, match="needs a causal LM"):
        tharness._setup(cfg)


# ------------------------------------------------------------------ SLO

def test_slo_monitor_equals_jax():
    rng = np.random.default_rng(3)
    monitors = [JaxSLO(0.5, 0.05), SLOMonitor(0.5, 0.05)]
    for _ in range(40):
        ttft = float(rng.exponential(0.3))
        gaps = list(rng.exponential(0.02, int(rng.integers(0, 12))))
        if rng.random() < 0.2:
            shed = int(rng.integers(1, 3))
            for m in monitors:
                m.shed(shed)
        met = [m.observe(ttft, gaps) for m in monitors]
        assert met[0] == met[1]
    assert monitors[1].summary(3.5) == monitors[0].summary(3.5)
    assert monitors[1].summary() == monitors[0].summary()
    assert 0 < monitors[1].good_requests < monitors[1].requests
    for m in monitors:
        m.reset()
    assert monitors[1].summary(1.0) == monitors[0].summary(1.0)


# ------------------------------------------------------------------ CLI

NEW_FLAGS = [
    "--lr-schedule", "linear", "--warmup-steps", "3", "--weight-decay",
    "0.05", "--clip-norm", "0.5", "--positional", "rope", "--kv-heads", "1",
    "--sample", "5", "--sample-prompt-len", "4", "--serve", "6",
    "--serve-slots", "2", "--serve-max-new", "7", "--serve-prompt-len", "5",
    "--serve-kv-dtype", "bfloat16", "--serve-draft-config", "layers=1",
    "--serve-draft-k", "3", "--serve-prefill-chunk", "4",
    "--serve-prefix-cache", "16", "--serve-prefix-block", "4",
    "--serve-kv-layout", "paged", "--serve-paged-block", "4",
    "--serve-paged-blocks", "64", "--serve-shared-prefix", "4",
    "--serve-slo-ttft", "1.5", "--serve-slo-itl", "0.25",
    "--serve-queue-cap", "9", "--serve-multi-step", "2"]


def test_cli_flags_reach_config(monkeypatch):
    """Every new flag lands in the config field the JAX CLI fills."""
    configs = {}
    for name, lib in (("jax", jcli), ("port", tcli)):
        monkeypatch.setattr(lib, "run", lambda config, name=name: (
            configs.__setitem__(name, config) or {}))
        lib.main(["-n", "1", "--model", "gpt_tiny", "--dataset",
                  "lm_synth"] + NEW_FLAGS
                 + (["--device", "cpu"] if lib is tcli else []))
    want, got = configs["jax"], configs["port"]
    fields = [f.name for f in dataclasses.fields(got)
              if f.name not in ("device", "model_fn", "dataset_fn")]
    for field in fields:
        assert getattr(got, field) == getattr(want, field), field
    assert (got.serve_multi_step, got.kv_heads, got.weight_decay) == (
        2, 1, 0.05)


def test_cli_main_trains_samples_and_serves_gpt_tiny(capsys):
    """One CPU run of a small gpt_tiny through cli.main with the recipe,
    rope and GQA, --sample and a paged --serve window."""
    summary = tcli.main([
        "--device", "cpu", "-m", "c", "-cs", "sync", "-n", "1", "-b", "4",
        "--model", "gpt_tiny", "--dataset", "lm_synth", "--attention",
        "flash", "--model-arg", "hidden=32", "--model-arg", "layers=1",
        "--model-arg", "heads=2", "--model-arg", "ffn=64", "--model-arg",
        "max_len=32", "--lr-schedule", "cosine", "--warmup-steps", "2",
        "--weight-decay", "0.1", "--clip-norm", "1.0", "--positional",
        "rope", "--kv-heads", "1", "--sample", "6", "--serve", "5",
        "--serve-slots", "2", "--serve-max-new", "4", "--serve-kv-layout",
        "paged", "--serve-prefix-block", "8", "--log-every", "0"],
        dataset_fn=_small_lm_fn)
    assert summary["steps"] == 6
    assert np.isclose(summary["test_perplexity"],
                      np.exp(summary["test_loss"]))
    assert len(summary["samples"]) == 1 and len(summary["samples"][0]) == 6
    serve = summary["serve"]
    assert serve["completed"] == 5 and serve["serve_kv_layout"] == "paged"
    assert serve["serve_goodput_under_slo"] is not None
    assert serve["slo"]["requests"] == 5
    assert summary["serve_exit_policy"] == 0
    assert "results" not in serve
