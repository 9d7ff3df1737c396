"""The roofline (``observability/roofline.py``) and its wiring through the
Trainer, the batcher, the run report, the harness and the CLI, held to
the JAX package on the CPU at small sizes:

* ``GPTCostModel.from_model`` on the port's GPT equals it on the flax GPT
  (dense, GQA, rope, MoE), and every cost figure and stdlib helper is the
  JAX module's on the same inputs;
* the peak table is the H100 SXM's data sheet, and the CPU, None, a TPU's
  name and the H100's other variants give None;
* ``Trainer.fit(roofline=)`` adds JAX's keys with JAX's model FLOPs;
* the batcher's analytic tallies (prefill and decode FLOPs, must-read
  bytes) equal JAX's batcher's exactly on the same requests, monolithic
  and paged, f32 and int8 storage, multi-step rounds and speculative
  verifies; the device seconds differ, so only the key sets of the MFU
  and MBU are compared;
* the run report's ``roofline`` section has JAX's keys;
* ``--roofline`` and ``--compile-cache`` parse as JAX's, and a harness run
  with ``roofline`` and a serve window reports every section.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.data import loaders as jloaders
from distributed_tensorflow_tpu.engines.allreduce import Trainer as JaxTrainer
from distributed_tensorflow_tpu.engines.sync import SyncEngine as JaxSync
from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu.observability import report as jreport
from distributed_tensorflow_tpu.observability import roofline as jrf
from distributed_tensorflow_tpu.parallel.mesh import create_mesh
from distributed_tensorflow_tpu.serving import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest,
    SlotKVCache as JaxKV, VirtualClock as JaxClock)
from distributed_tensorflow_tpu_torch.data import loaders as tloaders
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.models.convert import gpt_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.observability import roofline as rf
from distributed_tensorflow_tpu_torch.observability.report import (
    build_run_report)
from distributed_tensorflow_tpu_torch.serving import (
    ContinuousBatcher, Request, SlotKVCache, VirtualClock)

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0)
BLK = 4
H100 = "NVIDIA H100 80GB HBM3"


# ------------------------------------------------------------ cost model

@pytest.mark.parametrize("kw", [
    dict(kv_heads=None), dict(kv_heads=2), dict(positional="rope"),
    dict(moe_experts=4), dict(tie_embeddings=False),
], ids=["dense", "gqa", "rope", "moe", "untied"])
def test_cost_model_from_port_gpt_equals_flax(kw):
    cfg = dict(SMALL, **kw)
    want = jrf.GPTCostModel.from_model(JaxGPT(**cfg))
    got = rf.GPTCostModel.from_model(GPTLM(**cfg, device="cpu"))
    # the port's GPT resolves kv_heads=None to its head count when built
    want = dataclasses.replace(want, kv_heads=want.n_kv_heads)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for fn, args in (("param_count", ()), ("param_bytes", ()),
                     ("fwd_flops_per_token", (32,)),
                     ("train_step_flops", (8, 32)),
                     ("decode_flops_per_token", (17,)),
                     ("verify_flops", (9, 5)),
                     ("prefill_chunk_flops", (6, 4)),
                     ("kv_read_bytes", (13,)),
                     ("decode_step_bytes", ([3, 9, 17],))):
        assert getattr(got, fn)(*args) == getattr(want, fn)(*args), fn
    # a model outside the family: None on both sides
    assert rf.GPTCostModel.from_model(torch.nn.Linear(2, 2)) is None


@pytest.mark.parametrize("layout,dtype", [("monolithic", "float32"),
                                          ("paged", "int8")])
def test_kv_byte_accounting_equals_jax(layout, dtype):
    kw = dict(kv_dtype=dtype, kv_layout=layout, paged_block=BLK)
    base = dict(vocab=64, hidden=32, layers=2, heads=4, ffn=64, max_len=32)
    got, want = rf.GPTCostModel(**base, **kw), jrf.GPTCostModel(**base, **kw)
    for ctx in ([1, 5, 31], [], [8]):
        assert got.decode_step_bytes(ctx) == want.decode_step_bytes(ctx)


# ----------------------------------------------------------------- peaks

def test_h100_peaks_and_unknown_kinds():
    peaks = rf.device_peaks(H100)
    assert peaks.flops_per_s == {"bf16": 989e12, "f32": 67e12,
                                 "int8": 1979e12}
    assert peaks.hbm_bytes_per_s == 3.35e12
    assert peaks.revision == rf.PEAK_TABLE_REVISION != \
        jrf.PEAK_TABLE_REVISION
    for kind in (None, "", "cpu", "TPU v5 lite", "TPU v4", "v6e",
                 "NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
        assert rf.device_peaks(kind) is None, kind
    # the two dtypes' ridge points, and fp16 on bf16's tensor-core rate
    assert rf.ridge_point(peaks, "bf16") == 989e12 / 3.35e12
    assert rf.ridge_point(peaks, "f32") == 67e12 / 3.35e12
    assert rf._dtype_key(torch.float16) == rf._dtype_key(
        torch.bfloat16) == "bf16"
    assert rf._dtype_key(torch.float32) == "f32"
    r = rf.Roofline(peaks, n_devices=2, dtype="f32")
    assert r.mfu(67e12) == 0.5 and r.mbu(3.35e12) == 0.5
    assert rf.Roofline(None).mfu(1.0) is None


def test_stdlib_helpers_match_jax():
    jpeaks = jrf.DevicePeaks("x", {"bf16": 1e12, "f32": 5e11}, 1e11)
    peaks = rf.DevicePeaks("x", {"bf16": 1e12, "f32": 5e11}, 1e11)
    for intensity in (None, 0.5, 10.0, 1e4):
        for dt in ("bf16", "f32"):
            assert rf.classify_bound(intensity, peaks, dt) == \
                jrf.classify_bound(intensity, jpeaks, dt)
            assert rf.attainable_fraction(intensity, peaks, dt) == \
                jrf.attainable_fraction(intensity, jpeaks, dt)
    programs = {"a": {"flops": 1e9, "bytes_accessed": 1e6},
                "b": {"flops": None, "bytes_accessed": None}, "c": None}
    assert rf.program_attribution(programs, peaks) == \
        jrf.program_attribution(programs, jpeaks)
    for a, x in ((1e9, 3e9), (None, 1.0), (0, 2.0)):
        assert rf.flops_crosscheck(a, x) == jrf.flops_crosscheck(a, x)
        assert rf.arithmetic_intensity(a, x) == jrf.arithmetic_intensity(
            a, x)
    got = rf.Roofline(peaks, 3, dtype="f32").describe()
    want = jrf.Roofline(jpeaks, 3, dtype="f32").describe()
    assert {k: v for k, v in got.items() if k != "peak_table_revision"} \
        == {k: v for k, v in want.items() if k != "peak_table_revision"}


# --------------------------------------------------------------- trainer

def _lm(n=32):
    return jloaders.synthetic_lm(n, seq_len=32, vocab_size=64, seed=3,
                                 split="train")


def test_trainer_roofline_keys_match_jax():
    x, y = _lm()
    cfg = dict(SMALL, attention_impl="flash")
    want = JaxTrainer(None, engine=JaxSync(JaxGPT(**cfg),
                                           mesh=create_mesh(1)), seed=0).fit(
        jloaders.Dataset(x=x, y=y, num_classes=64), batch_size=8,
        log_every=0, max_steps=2, log_fn=lambda _: None,
        roofline=jrf.Roofline.for_model(JaxGPT(**cfg), "cpu"))
    eng = SyncEngine(GPTLM(**cfg, device="cpu"), device="cpu")
    got = Trainer(None, engine=eng, seed=0).fit(
        tloaders.Dataset(x=x, y=y, num_classes=64), batch_size=8,
        log_every=0, max_steps=2, log_fn=lambda _: None,
        roofline=rf.Roofline(None, 1, eng.roofline_model(), "f32"))
    keys = ("train_model_flops_per_step", "train_achieved_flops_per_sec",
            "train_mfu", "roofline_peak_table_revision")
    assert set(keys) <= set(want) and set(keys) <= set(got)
    assert got["train_model_flops_per_step"] == \
        want["train_model_flops_per_step"] == \
        8 * 32 * eng.roofline_model().train_flops_per_token(32)
    assert got["train_achieved_flops_per_sec"] > 0
    assert got["train_mfu"] is None and want["train_mfu"] is None
    # with the H100's peak the MFU is the achieved rate over 67 TFLOP/s
    got = Trainer(None, engine=SyncEngine(GPTLM(**cfg, device="cpu"),
                                          device="cpu"), seed=0).fit(
        tloaders.Dataset(x=x, y=y, num_classes=64), batch_size=8,
        log_every=0, max_steps=2, log_fn=lambda _: None,
        roofline=rf.Roofline.for_model(GPTLM(**cfg, device="cpu"), H100))
    assert got["train_mfu"] == got["train_achieved_flops_per_sec"] / 67e12
    # without a roofline, none of the keys
    plain = Trainer(None, engine=SyncEngine(GPTLM(**cfg, device="cpu"),
                                            device="cpu"), seed=0).fit(
        tloaders.Dataset(x=x, y=y, num_classes=64), batch_size=8,
        log_every=0, max_steps=1)
    assert not set(keys) & set(plain)


# --------------------------------------------------------------- batcher

@pytest.fixture(scope="module")
def models():
    jm = JaxGPT(**SMALL)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    params = dict(params, token_embed={
        "embedding": params["token_embed"]["embedding"] * 6.0})
    return jm, params, gpt_state_dict(jax.tree.map(np.asarray, params))


def _trace(seed=1, n=6, shared=8):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 64, shared).astype(np.int32)
    return [(i, np.concatenate([head, rng.integers(
        0, 64, int(rng.integers(3, 12))).astype(np.int32)]),
        int(rng.integers(2, 10)), float(rng.integers(0, 6)))
        for i in range(n)]


def _tables(models, layout, dtype, pool, draft):
    jm, params, sd = models
    kw = dict(kv_layout=layout, prefix_block=BLK, prefix_cache_blocks=pool,
              kv_dtype=dtype)
    if layout == "paged":
        kw["paged_block"] = BLK
    jkv = JaxKV(jm, params, slots=3, **kw)
    tkv = SlotKVCache(GPTLM(**SMALL, device="cpu"), sd, 3, device="cpu",
                      **kw)
    if not draft:
        return jkv, tkv, {}, {}
    jd = JaxKV(jm, params, slots=3, kv_layout=layout, prefix_block=BLK,
               **({"paged_block": BLK} if layout == "paged" else {}))
    td = SlotKVCache(GPTLM(**SMALL, device="cpu"), sd, 3, device="cpu",
                     kv_layout=layout, prefix_block=BLK,
                     **({"paged_block": BLK} if layout == "paged" else {}))
    return jkv, tkv, dict(draft_kv=jd, draft_k=3), dict(draft_kv=td,
                                                       draft_k=3)


TALLIES = ("prefill_model_flops", "decode_model_flops",
           "decode_must_read_bytes")


@pytest.mark.parametrize("layout,dtype,pool,extra", [
    ("monolithic", None, 0, {}),
    ("paged", None, 8, {}),
    ("monolithic", "int8", 8, {"prefill_chunk": 4}),
    ("paged", "int8", 0, {"multi_step": 3}),
    ("paged", None, 0, {"draft": True}),
], ids=["mono", "paged-pool", "mono-int8-chunked", "paged-int8-multi",
        "paged-spec"])
def test_batcher_tallies_equal_jax(models, layout, dtype, pool, extra):
    extra = dict(extra)
    draft = extra.pop("draft", False)
    jkv, tkv, jdraft, tdraft = _tables(models, layout, dtype, pool, draft)
    trace = _trace()
    want = JaxBatcher(jkv, clock=JaxClock(), roofline=jrf.Roofline.for_kv(
        jkv, None), **jdraft, **extra).run(
        [JaxRequest(i, p, n, a) for i, p, n, a in trace])
    got = ContinuousBatcher(tkv, clock=VirtualClock(),
                            roofline=rf.Roofline.for_kv(tkv, None),
                            **tdraft, **extra).run(
        [Request(i, p, n, a) for i, p, n, a in trace])
    assert [r.tokens for r in got["results"]] == \
        [r.tokens for r in want["results"]]
    for key in TALLIES:
        assert got["roofline"][key] == want["roofline"][key], key
    assert got["roofline"]["decode_model_flops"] > 0
    assert set(got["roofline"]) == set(want["roofline"])
    for key in ("serve_prefill_mfu", "serve_decode_mbu"):
        assert key in got and key in want and got[key] is None
    # the same table under the H100's peaks: shares of them
    got = ContinuousBatcher(
        _tables(models, layout, dtype, pool, False)[1], clock=VirtualClock(),
        roofline=rf.Roofline.for_kv(tkv, H100), **extra).run(
        [Request(i, p, n, a) for i, p, n, a in trace])
    sec = got["roofline"]
    assert got["serve_decode_mbu"] == sec["decode_mbu"] == (
        sec["decode_must_read_bytes"] / sec["decode_s"] / 3.35e12)
    assert got["serve_prefill_mfu"] == sec["prefill_mfu"] == (
        sec["prefill_model_flops"] / sec["prefill_s"] / 67e12)


def test_batcher_without_roofline_keeps_its_keys(models):
    _, _, sd = models
    kv = SlotKVCache(GPTLM(**SMALL, device="cpu"), sd, 3, device="cpu")
    got = ContinuousBatcher(kv, clock=VirtualClock()).run(
        [Request(i, p, n, a) for i, p, n, a in _trace(n=2)])
    assert not {"roofline", "serve_prefill_mfu",
                "serve_decode_mbu"} & set(got)


# ---------------------------------------------------------------- report

def test_report_roofline_section_keys_match_jax():
    from distributed_tensorflow_tpu.observability import (
        ProgramLedger as JaxLedger)

    from distributed_tensorflow_tpu_torch.observability import ProgramLedger

    fit = {"elapsed": 1.0, "steps": 4, "train_model_flops_per_step": 1e9,
           "train_achieved_flops_per_sec": 4e9, "train_mfu": None}
    serve = {"roofline": {"decode_mbu": None}}
    want = jreport.build_run_report(fit, serve=serve, ledger=JaxLedger(),
                                    roofline=jrf.Roofline(None))
    got = build_run_report(fit, serve=serve, ledger=ProgramLedger(),
                           roofline=rf.Roofline(None))
    assert set(got["roofline"]) == set(want["roofline"])
    assert got["roofline"]["train"] == want["roofline"]["train"]
    assert got["roofline"]["serve"] == want["roofline"]["serve"]
    assert got["train_mfu"] == want["train_mfu"] is None
    # a ledger program with measured FLOPs: the cross-check (a chunk of 8
    # steps against 8 steps' model FLOPs) and a row
    ledger = ProgramLedger()
    ledger.record("train_chunk_k8", compile_s=0.5, flops=6e9)
    got = build_run_report(fit, ledger=ledger,
                           roofline=rf.Roofline(rf.device_peaks(H100)))
    assert got["roofline"]["train"]["xla_flops_crosscheck"] == 0.75
    assert [r["program"] for r in got["roofline"]["programs"]] == [
        "train_chunk_k8"]
    assert got["compile_total_s"] == 0.5


# ------------------------------------------------------ harness and flags

def test_cli_roofline_and_compile_cache_flags_parse_as_jax():
    from distributed_tensorflow_tpu.cli import build_parser as jax_parser

    from distributed_tensorflow_tpu_torch.cli import build_parser

    dests = ("roofline", "compile_cache")
    for argv in ([], ["--roofline", "--compile-cache", "cache"]):
        a, b = build_parser().parse_args(argv), jax_parser().parse_args(argv)
        assert [getattr(a, d) for d in dests] == [getattr(b, d)
                                                  for d in dests], argv


def _lm_fn(batch_size, type="train"):  # noqa: A002 — harness API
    return tloaders.load_lm_dataset("lm_synth", split=type, seq_len=16,
                                    vocab_size=64, n_train=24, n_test=24)


def test_harness_roofline_and_compile_cache_run(tmp_path, monkeypatch):
    from distributed_tensorflow_tpu_torch.ops import _build
    from distributed_tensorflow_tpu_torch.utils import harness

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    out = harness.run(harness.ExperimentConfig(
        model="gpt_tiny", dataset_fn=_lm_fn, batch_size=8, epochs=1,
        log_every=0, device="cpu", roofline=True, serve_requests=3,
        serve_slots=2, serve_max_new=3, serve_prompt_len=4,
        compile_cache=str(tmp_path / "kernels")))
    assert _build.BUILD_DIR == (tmp_path / "kernels").resolve()
    report = out["run_report"]
    assert report["roofline"]["device"]["known_device"] is False
    assert report["roofline"]["train"]["model_flops_per_step"] > 0
    assert report["train_mfu"] is None
    assert report["roofline"]["serve"]["decode_model_flops"] > 0
    assert out["serve"]["serve_decode_mbu"] is None
    # the ledger the roofline arms: the serve table's first calls
    names = set(report["xla"]["programs"])
    assert "kv_decode_step" in names
    assert any(n.startswith("kv_prefill_chunk_l") for n in names)
    assert report["peak_hbm_bytes_est"] == 0
    assert not math.isnan(report["compile_total_s"])
