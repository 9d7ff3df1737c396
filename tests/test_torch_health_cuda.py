"""The health layer and the program ledger on the card.  Marked ``cuda``:
skipped without an NVIDIA GPU.  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_health_cuda.py

* A GPT's replayed CUDA-graph chunks with health on give the eager
  steps' losses and six health streams bitwise (the capture's scalars,
  snapshot and EMA are device tensors updated in place by each replay),
  and an injection inside a replayed chunk poisons exactly its step.
* A chunk captured with health off launches what the eager steps launch,
  and health adds no counted launch.
* The non-finite count reads NaN and inf on CUDA tensors (the max-abs
  multi-tensor norm propagates them).
* The program ledger records the chunk's capture (seconds, memory during
  it, the warm-up's FLOPs) and a decode round's.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.engines import SyncEngine
from distributed_tensorflow_tpu_torch.engines.sync import _launch_counters
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.observability import (
    HealthConfig, ProgramLedger)
from distributed_tensorflow_tpu_torch.observability import health as hl

pytestmark = pytest.mark.cuda

GPT = dict(vocab_size=128, hidden=128, layers=2, heads=2, ffn=256,
           max_len=64, dropout_rate=0.1, attention_impl="flash")
K, CHUNKS = 4, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the Hopper "
                    "kernels have no CPU mode")
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = flag


def _batches(n):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 128, (n, 8, 64)).astype(np.int64)
    return [(b, np.roll(b, -1, axis=1)) for b in x]


def _engine(health, ledger=None):
    eng = SyncEngine(GPTLM(**GPT, device="cuda"), device="cuda")
    if health is not None:
        eng.enable_health(health)
    eng.ledger = ledger
    state = eng.init_state(torch.Generator().manual_seed(0))
    return eng, state


def _counts():
    return {(id(fn), name): getattr(fn, name)
            for fn, name in _launch_counters()}


def _run(health, chunked, ledger=None):
    """K·CHUNKS steps: chunks of K (eager warm-up, capture, replay) or
    single eager steps; each step's metrics and the launches moved."""
    eng, state = _engine(health, ledger)
    data = [eng.shard_batch(x, y) for x, y in _batches(K * CHUNKS)]
    before = _counts()
    rows = []
    if chunked:
        for c in range(CHUNKS):
            part = data[c * K:(c + 1) * K]
            state, m = eng.many_step(state, [x for x, _ in part],
                                     [y for _, y in part])
            rows += [{k: v[i].item() for k, v in m.items()} for i in range(K)]
    else:
        for x, y in data:
            state, m = eng.step(state, x, y)
            rows.append({k: v.item() for k, v in m.items()})
    after = _counts()
    return rows, {k: after[k] - before[k] for k in after}, eng


def test_replayed_health_streams_are_the_eager_steps(cuda_device):
    from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph

    captures = _ChunkGraph.captures
    eager, _, _ = _run(HealthConfig(), chunked=False)
    replayed, _, eng = _run(HealthConfig(), chunked=True)
    assert _ChunkGraph.captures == captures + 1 and eng._graphs
    assert len(eager) == len(replayed) == K * CHUNKS
    for i, (a, b) in enumerate(zip(eager, replayed)):
        assert set(hl.HEALTH_KEYS) <= set(a)
        assert a == b, i
    assert all(np.isfinite(r["grad_norm"]) and r["nonfinite_count"] == 0
               for r in replayed)
    # the injection inside the replayed (third) chunk: its step alone
    # turns the update non-finite, and the parameters stay so
    at = 2 * K + 2
    poisoned, _, _ = _run(HealthConfig(inject_nan_at=at), chunked=True)
    for i, r in enumerate(poisoned, 1):
        if i < at:
            assert r == replayed[i - 1], i
        else:
            assert r["nonfinite_count"] > 0, i


def test_health_off_capture_launches_the_eager_steps(cuda_device):
    _, eager, _ = _run(None, chunked=False)
    rows_off, off, _ = _run(None, chunked=True)
    rows_on, on, _ = _run(HealthConfig(), chunked=True)
    assert off == eager and on == off
    assert any(v > 0 for v in off.values())
    assert [r["loss"] for r in rows_off] == [r["loss"] for r in rows_on]
    assert "grad_norm" not in rows_off[0]


def test_nonfinite_count_on_cuda_tensors(cuda_device):
    a = torch.ones(1000, device="cuda")
    b = torch.ones(7, 3, device="cuda", dtype=torch.bfloat16)
    assert int(hl.nonfinite_leaf_count([a, b])) == 0
    a[500] = float("nan")
    b[2, 1] = float("-inf")
    assert int(hl.nonfinite_leaf_count([a, b])) == 2
    big = torch.full((64,), 3e38, device="cuda")
    # a finite tensor whose squares overflow is not non-finite
    assert int(hl.nonfinite_leaf_count([big])) == 0
    assert not torch.isfinite(hl.global_norm([big]))


def test_ledger_records_chunk_and_round_captures(cuda_device):
    from distributed_tensorflow_tpu_torch.serving import SlotKVCache

    ledger = ProgramLedger()
    _run(None, chunked=True, ledger=ledger)
    rec = ledger.programs()[f"train_chunk_k{K}"]
    assert rec["compiles"] == 1 and rec["compile_s"] > 0
    assert rec["peak_bytes_est"] > 0 and rec["flops"] > 0
    model = GPTLM(**dict(GPT, dropout_rate=0.0), device="cuda")
    kv = SlotKVCache(model, None, 2, kv_layout="paged", paged_block=8,
                     prefix_block=8, device="cuda", ledger=ledger)
    kv.insert(np.arange(5, dtype=np.int32))
    for _ in range(3):
        kv.advance_multi(4)
    progs = ledger.programs()
    assert progs["kv_paged_decode_multi_k4"]["compiles"] == 1
    assert progs["kv_paged_decode_multi_k4"]["peak_bytes_est"] >= 0
    assert progs["kv_paged_prefill_chunk_l5"]["compile_s"] > 0
