"""The port's pipeline stages, sequential forward, ``generate`` and
rejections against the JAX package, in one process (CPU).

The JAX references run on the 8-device CPU mesh; the port's engine runs
on a (1, 1) ('data', 'pipe') mesh of one gloo rank (the multi-rank
schedules are ``test_torch_pipeline_dist.py``'s).  Every port module
takes JAX's initial weights through ``convert.pipeline_state_dicts``.
Tolerances, each with its reason:

* each stage module (the built-in MLP stages, the GPT stages with learned
  positions and with RoPE and ``kv_heads`` 2, the BERT stages) on JAX's
  input to it: rtol 1e-5, atol 1e-5 (f32: the same math, summed in
  other orders by XLA and by torch);
* ``_sequential_logits`` with two stages held in one process: the same
  bound;
* ``generate`` (greedy, fixed-length decode) after one SGD step: the
  tokens bitwise JAX's, and bitwise the port's own naive rollout;
* the rejections: JAX's messages word for word, or
  ``NotImplementedError`` naming "remaining engines: pipeline
  composites".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.engines.pipeline import (
    PipelineEngine as JPipelineEngine)
from distributed_tensorflow_tpu.models.bert import (
    bert_pipeline_stages as jbert_stages)
from distributed_tensorflow_tpu.models.gpt import (
    gpt_pipeline_stages as jgpt_stages)
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.utils import harness as jharness
from distributed_tensorflow_tpu_torch.engines.pipeline import (
    PipelineEngine, SequentialStages)
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models.bert import bert_pipeline_stages
from distributed_tensorflow_tpu_torch.models.gpt import gpt_pipeline_stages
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.utils import harness

F32 = dict(rtol=1e-5, atol=1e-5)
GPT = dict(vocab_size=64, hidden=32, heads=4, ffn=64, max_len=16)
BERT = dict(num_classes=2, vocab_size=64, hidden=32, heads=2, ffn=64,
            max_len=16)
FAMILIES = {
    "mlp": {},
    "gpt": dict(GPT),
    "gpt_rope": dict(GPT, positional="rope", kv_heads=2),
    "bert": dict(BERT),
}


def _inputs(family: str, n: int = 8):
    rng = np.random.default_rng(11)
    if family == "mlp":
        return rng.random((n, 4, 4, 1), np.float32), \
            (np.arange(n) % 10).astype(np.int32)
    ids = rng.integers(1, 64, (n, 16)).astype(np.int32)
    if family == "bert":
        ids[:, 12:] = 0          # padded keys
        return ids, (np.arange(n) % 2).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1).astype(np.int32)


def _jax_mesh(dp: int, pp: int):
    return jmesh.create_mesh(dp * pp, shape=(dp, pp),
                             axis_names=(jmesh.DATA_AXIS, jmesh.PIPE_AXIS))


def _jax_stages(family: str):
    kw = FAMILIES[family]
    if family == "mlp":
        return None
    if family == "bert":
        return jbert_stages(**kw)
    return jgpt_stages(**kw)


def _port_stages(family: str, **extra):
    kw = dict(FAMILIES[family], **extra)
    if family == "mlp":
        return None
    if family == "bert":
        return bert_pipeline_stages(**kw, device="cpu")
    return gpt_pipeline_stages(**kw, device="cpu")


def _jax_engine(family: str, dp: int = 1, pp: int = 2, **kw):
    return JPipelineEngine(num_classes=10, hidden=16, microbatches=2,
                           mesh=_jax_mesh(dp, pp), stages=_jax_stages(family),
                           **kw)


def _np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(params))


@pytest.fixture(scope="module")
def mesh():
    m = meshlib.create_mesh(1, device="cpu", shape=(1, 1),
                            axis_names=("data", "pipe"))
    yield m
    m.close()


def _port_engine(family: str, mesh, x, **kw):
    eng = PipelineEngine(num_classes=10, hidden=16, microbatches=2,
                         mesh=mesh, stages=_port_stages(family, **kw),
                         optimizer=lambda p: torch.optim.SGD(p, lr=0.1))
    state = eng.init_state(torch.Generator().manual_seed(0), x)
    return eng, state


def _load_stage(module, sd):
    module.load_state_dict(sd)
    return module


def _close(got, want, what):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=what, **F32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_stage_modules_match_jax(mesh, family):
    x, _ = _inputs(family)
    jeng = _jax_engine(family)
    params = _np_tree(jeng.init_state(jax.random.key(0), x).params)
    embed_sd, blocks, head_sd = convert.pipeline_state_dicts(params)
    assert len(blocks) == 2
    eng, _ = _port_engine(family, mesh, x)
    # the embed on the data, each module on JAX's input to it
    h = jeng.embed.apply({"params": params["embed"]}, jnp.asarray(x))
    _close(_load_stage(eng.embed, embed_sd)(torch.as_tensor(x)), h,
           f"{family} embed")
    for s, sd in enumerate(blocks):
        bp = jax.tree.map(lambda a, s=s: a[s], params["blocks"])
        out = jeng.block.apply({"params": bp}, h)
        carry = tuple(torch.as_tensor(np.asarray(a)) for a in h) \
            if isinstance(h, tuple) else torch.as_tensor(np.asarray(h))
        _close(_load_stage(eng.block, sd)(carry), out, f"{family} block {s}")
        h = out
    logits = jeng.head.apply({"params": params["head"]}, h)
    carry = tuple(torch.as_tensor(np.asarray(a)) for a in h) \
        if isinstance(h, tuple) else torch.as_tensor(np.asarray(h))
    _close(_load_stage(eng.head, head_sd)(carry), logits, f"{family} head")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sequential_logits_of_two_stages_match_jax(mesh, family):
    """Two stages held in one process (``SequentialStages`` of the
    converted weights) against JAX's ``_sequential_logits``."""
    import copy

    x, _ = _inputs(family)
    jeng = _jax_engine(family)
    params = _np_tree(jeng.init_state(jax.random.key(1), x).params)
    want = jeng._sequential_logits(params, jnp.asarray(x))
    embed_sd, blocks, head_sd = convert.pipeline_state_dicts(params)
    eng, _ = _port_engine(family, mesh, x)
    model = SequentialStages(
        _load_stage(eng.embed, embed_sd),
        [_load_stage(copy.deepcopy(eng.block), sd) for sd in blocks],
        _load_stage(eng.head, head_sd))
    got = eng._sequential_logits(model, torch.as_tensor(x))
    _close(got, want, f"{family} sequential logits")


def test_generate_matches_jax_bitwise(mesh):
    """JAX ``test_pipeline_generate_matches_naive_rollout``'s setting: GPT
    stages on a (1, 2) mesh after one SGD step, a (2, 6) prompt and 5 new
    tokens.  The port holds both stages in one (``layers_per_stage`` 2,
    stage s's layer as layer s)."""
    kw = dict(vocab_size=64, hidden=32, heads=2, ffn=64, max_len=24)
    jeng = JPipelineEngine(microbatches=2, mesh=_jax_mesh(1, 2),
                           optimizer=optax.sgd(0.1),
                           stages=jgpt_stages(**kw))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (8, 24)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    state = jeng.init_state(jax.random.key(0), x)
    state, _ = jeng.step(state, *jeng.shard_batch(x, y))
    prompt = x[:2, :6]
    want = np.asarray(jeng.generate(state, prompt, 5))
    assert want.shape == (2, 11)

    embed_sd, blocks, head_sd = convert.pipeline_state_dicts(
        _np_tree(state.params))
    eng = PipelineEngine(microbatches=2, mesh=mesh,
                         stages=gpt_pipeline_stages(**kw, layers_per_stage=2,
                                                    device="cpu"))
    pstate = eng.init_state(torch.Generator().manual_seed(0), x)
    merged = {f"embed.{k}": v for k, v in embed_sd.items()}
    merged.update({f"head.{k}": v for k, v in head_sd.items()})
    for s, sd in enumerate(blocks):
        merged.update({f"block.{k.replace('layers.0.', f'layers.{s}.')}": v
                       for k, v in sd.items()})
    pstate.model.load_state_dict(merged)
    got = eng.generate(pstate, prompt, 5)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the naive rollout: the sequential forward on the growing prefix
    model = eng.eval_params(pstate)
    toks = torch.as_tensor(prompt).long()
    with torch.no_grad():
        for _ in range(5):
            nxt = eng._sequential_logits(model, toks)[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(toks.numpy(), got)


def _messages(jfn, pfn):
    with pytest.raises(ValueError) as ref:
        jfn()
    with pytest.raises(ValueError) as port:
        pfn()
    assert str(port.value) == str(ref.value)
    return str(ref.value)


def test_engine_rejections_are_jax_word_for_word():
    m = meshlib.create_mesh(1, device="cpu")
    try:
        _messages(lambda: JPipelineEngine(mesh=jmesh.create_mesh(8)),
                  lambda: PipelineEngine(mesh=m))
    finally:
        m.close()
    for axes, kw in ((("data", "pipe"), {"schedule": "zigzag"}),
                     (("data", "pipe", "foo"), {})):
        shape = (1,) * len(axes)
        m = meshlib.create_mesh(1, device="cpu", shape=shape, axis_names=axes)
        try:
            _messages(lambda: JPipelineEngine(
                mesh=jmesh.create_mesh(1, shape=shape, axis_names=axes),
                **kw), lambda: PipelineEngine(mesh=m, **kw))
        finally:
            m.close()


@pytest.mark.parametrize("axis", ["model", "seq", "expert"])
def test_composite_mesh_axes_raise_not_ported(axis):
    """An 'expert' axis (the pp×ep composites) cites its title; 'model'
    and 'seq' compose (pp×tp, pp×sp), and the MLP stages, which neither
    axis cuts, train over them as on the (1, 1) mesh, bitwise."""
    m = meshlib.create_mesh(1, device="cpu", shape=(1, 1, 1),
                            axis_names=("data", "pipe", axis))
    try:
        if axis == "expert":
            with pytest.raises(NotImplementedError,
                               match="remaining engines: pipeline "
                                     "composites"):
                PipelineEngine(mesh=m)
            return
        twin = meshlib.create_mesh(1, device="cpu", shape=(1, 1),
                                   axis_names=("data", "pipe"))
        x, y = _inputs("mlp")
        runs = []
        for mm in (m, twin):
            eng, state = _port_engine("mlp", mm, x)
            state, met = eng.step(state, *eng.shard_batch(x, y))
            runs.append((float(met["loss"]), eng.full_state_dict(state)))
        (loss, got), (want_loss, want) = runs
        assert loss == want_loss
        assert all(torch.equal(got[k], v) for k, v in want.items())
    finally:
        m.close()


@pytest.mark.parametrize("factory,kw", [
    (gpt_pipeline_stages, {"partition_model": True}),
    (gpt_pipeline_stages, {"seq_axis": "seq"}),
    (gpt_pipeline_stages, {"attention_impl": "ring"}),
    (gpt_pipeline_stages, {"moe_experts": 4}),
    (bert_pipeline_stages, {"partition_model": True}),
    (bert_pipeline_stages, {"moe_experts": 4})])
def test_stage_composite_options_raise_not_ported(factory, kw):
    """MoE stages (the pp×ep composites) cite their title.  The dense
    options are ported: ``partition_model`` builds the Megatron layers
    (pp×tp), a ring block builds and refuses to run without a bound mesh,
    and a ``seq_axis`` with dense attention is refused in JAX's words."""
    from distributed_tensorflow_tpu_torch.models.layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)

    if "moe_experts" in kw:
        with pytest.raises(NotImplementedError,
                           match="remaining engines: pipeline composites"):
            factory(**kw, device="cpu")
    elif "seq_axis" in kw:
        jfactory = jgpt_stages
        _, jblock, _ = jfactory(**GPT, **kw)
        _messages(lambda: jblock.init(jax.random.key(0),
                                      jnp.zeros((1, 16, 32))),
                  lambda: factory(**GPT, **kw, device="cpu"))
    elif "attention_impl" in kw:
        _, block, _ = factory(**GPT, **kw, device="cpu")
        assert block.attention_impl == "ring"
        with pytest.raises(ValueError, match="no mesh bound"):
            block(torch.zeros(1, 16, 32))
    else:
        base = GPT if factory is gpt_pipeline_stages else BERT
        embed, block, head = factory(**base, **kw, device="cpu")
        kinds = {type(m) for m in block.modules()}
        assert {ColumnParallelLinear, RowParallelLinear} <= kinds
        assert any(isinstance(m, VocabParallelEmbedding)
                   for m in embed.modules())
        plain = factory(**base, device="cpu")
        for part, twin in zip((embed, block, head), plain):
            assert {k: v.shape for k, v in part.state_dict().items()} == {
                k: v.shape for k, v in twin.state_dict().items()}


def test_stages_must_hold_no_dropout(mesh):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTBlock

    embed, block, head = gpt_pipeline_stages(**GPT, device="cpu")
    block.layers[0] = GPTBlock(32, 4, 64, dropout_rate=0.1, device="cpu")
    with pytest.raises(ValueError, match="dropout 0"):
        PipelineEngine(mesh=mesh, stages=(embed, block, head))


def test_generate_rejections_are_jax_word_for_word(mesh):
    jb = JPipelineEngine(microbatches=2, mesh=_jax_mesh(1, 1),
                         stages=jbert_stages(**BERT))
    pb = PipelineEngine(microbatches=2, mesh=mesh,
                        stages=bert_pipeline_stages(**BERT, device="cpu"))
    zeros = np.zeros((1, 4), np.int32)
    _messages(lambda: jb.generate(None, zeros, 4),
              lambda: pb.generate(None, zeros, 4))
    jg = JPipelineEngine(microbatches=2, mesh=_jax_mesh(1, 1),
                         stages=jgpt_stages(**GPT))
    pg = PipelineEngine(microbatches=2, mesh=mesh,
                        stages=gpt_pipeline_stages(**GPT, device="cpu"))
    for prompt, n in ((np.zeros(4, np.int32), 4), (zeros, 0), (zeros, 13)):
        _messages(lambda: jg.generate(None, prompt, n),
                  lambda: pg.generate(None, prompt, n))


_PP = dict(model="mlp", dataset="synthetic", n_devices=2,
           pipeline_parallel=2)


@pytest.mark.parametrize("extra", [
    {"precision": "bf16"}, {"grad_compression": "int8"},
    {"grad_bucket_mb": 4.0}, {"grad_accum": 2}, {"engine": "fsdp"},
    {"model": "bert_tiny", "dataset": "glue_synth", "sample_tokens": 4}],
    ids=["precision", "grad_compression", "grad_bucket_mb", "grad_accum",
         "fsdp", "sample_bert"])
def test_harness_rejections_under_pp_are_jax_word_for_word(extra):
    cfg = dict(_PP, **extra)
    _messages(lambda: jharness._setup(jharness.ExperimentConfig(**cfg)),
              lambda: harness._setup(harness.ExperimentConfig(
                  **cfg, device="cpu")))


def _experiment(mod, engine, test_ds):
    return mod._Experiment(mesh=None, n=1, train_ds=test_ds, test_ds=test_ds,
                           engine=engine, global_batch=8,
                           name="pipeline_parallel")


def test_serve_and_sample_validation_under_pp(mesh):
    """``--serve`` on any pipeline and ``--sample`` on BERT stages fail
    before training with JAX's words (the validators on an experiment
    holding each side's pipeline engine)."""
    from distributed_tensorflow_tpu.data.loaders import load_lm_dataset
    from distributed_tensorflow_tpu_torch.data import loaders

    jds = load_lm_dataset(seq_len=16, vocab_size=64, n_train=8, n_test=8,
                          split="test")
    pds = loaders.load_lm_dataset(seq_len=16, vocab_size=64, n_train=8,
                                  n_test=8, split="test")
    jg = JPipelineEngine(microbatches=2, mesh=_jax_mesh(1, 1),
                         stages=jgpt_stages(**GPT))
    pg = PipelineEngine(microbatches=2, mesh=mesh,
                        stages=gpt_pipeline_stages(**GPT, device="cpu"))
    jcfg, pcfg = (mod.ExperimentConfig(model="gpt", serve_requests=4)
                  for mod in (jharness, harness))
    msg = _messages(
        lambda: jharness._validate_serving(
            jcfg, _experiment(jharness, jg, jds), jds),
        lambda: harness._validate_serving(
            pcfg, _experiment(harness, pg, pds), pds))
    assert "pipe-stacked" in msg
    jb = JPipelineEngine(microbatches=2, mesh=_jax_mesh(1, 1),
                         stages=jbert_stages(**BERT))
    pb = PipelineEngine(microbatches=2, mesh=mesh,
                        stages=bert_pipeline_stages(**BERT, device="cpu"))
    jcfg, pcfg = (mod.ExperimentConfig(model="gpt", sample_tokens=4)
                  for mod in (jharness, harness))
    _messages(
        lambda: jharness._validate_sampling(
            jcfg, _experiment(jharness, jb, jds), jds),
        lambda: harness._validate_sampling(
            pcfg, _experiment(harness, pb, pds), pds))


@pytest.mark.parametrize("name,model_args", [
    ("_reject_model_args", {"hidden": 64}),
    ("_stage_model_args", {"hidden": 64})])
def test_model_arg_rejections_are_jax_word_for_word(name, model_args):
    _messages(
        lambda: getattr(jharness, name)(
            jharness.ExperimentConfig(model_args=model_args),
            "pipeline_parallel"),
        lambda: getattr(harness, name)(
            harness.ExperimentConfig(model_args=model_args),
            "pipeline_parallel"))


def test_decay_mask_uses_the_stacked_rank(mesh):
    """JAX's ``_decay_mask`` runs on the stacked tree: a block's biases and
    LayerNorm scales are (S, d) there and decayed, embed's and head's are
    not.  The port's mask, on this rank's module, is JAX's leaf for
    leaf."""
    x, _ = _inputs("gpt")
    jeng = _jax_engine("gpt")
    params = _np_tree(jeng.init_state(jax.random.key(0), x).params)
    mask = jax.tree_util.tree_map(
        lambda keep, a: np.full(np.shape(a), float(keep), np.float32),
        jharness._decay_mask(params), params)
    embed, blocks, head = convert.pipeline_state_dicts(mask)
    want = {f"embed.{k}": bool(v.reshape(-1)[0]) for k, v in embed.items()}
    want.update({f"block.{k}": bool(v.reshape(-1)[0])
                 for k, v in blocks[0].items()})
    want.update({f"head.{k}": bool(v.reshape(-1)[0])
                 for k, v in head.items()})
    eng, _ = _port_engine("gpt", mesh, x)
    got = harness._decay_mask(eng.model)
    assert got == want
    assert got["block.layers.0.ln1.bias"] and got["block.layers.0.fc1.bias"]
    assert not got["head.ln_f.bias"] and not got["head.lm_head.bias"]


def test_stacked_state_dict_roundtrip():
    x, _ = _inputs("bert")
    jeng = _jax_engine("bert", pp=2)
    params = _np_tree(jeng.init_state(jax.random.key(0), x).params)
    embed, blocks, head = convert.pipeline_state_dicts(params)
    stacked = convert.stacked_state_dict(embed, blocks, head)
    assert stacked["block.layers.0.attn.query.weight"].shape == (2, 32, 32)
    back = convert.unstacked_state_dicts(stacked)
    for a, b in zip((embed, *blocks, head), (back[0], *back[1], back[2])):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
