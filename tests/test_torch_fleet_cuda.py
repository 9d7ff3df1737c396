"""The serving fleet on the card.  Marked ``cuda``: skipped without an
NVIDIA GPU (the paged kernel and CUDA graphs have no CPU mode).  On the
card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_fleet_cuda.py

* Two replicas on threads (the wall clock), paged tables, each on its own
  stream, with and without fused rounds (``multi_step`` 4: every round a
  replayed CUDA graph, captured at the fleet's construction): the streams
  are bitwise those of one table, and the launch counters are exact —
  the paged kernel's launches are layers × the replicas' decode steps
  (layers × 4 a replayed round), ``RoundGraph.replays`` the rounds, and
  ``RoundGraph.captures`` does not move while the threads serve.
* A hot swap to the weights × 0.5 on one replica with fused rounds: the
  requests admitted before it decode under the old weights, those after
  it under the new ones (each bitwise a one-table window under those
  weights), with no capture during the run: the swap copies in place, so
  the captured round replays on the new weights.
* The same swap on the threaded driver, with the new weights computed
  behind a spin of the caller's stream: the replica's stream waits for
  them, and every stream is the new weights' one-table stream.
* No window failed a replica over (a survivor would hide it).

A small f32 GPT (TF32 off) from a seed: f32 greedy decode of a slot is
the same math whatever else the table holds.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.ops import paged_attention as tpa
from distributed_tensorflow_tpu_torch.serving import (
    ContinuousBatcher, ReplicaSet, Request, SlotKVCache, VirtualClock,
    build_replica_kvs)
from distributed_tensorflow_tpu_torch.serving.decode_graph import RoundGraph

pytestmark = pytest.mark.cuda

LAYERS = 2
# no prefix pool: every prefill is the whole prompt in one forward, on
# whichever replica, so the streams do not hang on where the pool hit
TABLE = dict(kv_layout="paged", paged_block=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged kernel and CUDA graphs "
                    "have no CPU mode")
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = flag


def _model(seed=0):
    model = create_model("gpt", num_classes=128, max_len=64, hidden=64,
                         layers=LAYERS, heads=4, ffn=128, dropout_rate=0.0,
                         dtype="float32", device="cuda")
    return model.reset_parameters(torch.Generator().manual_seed(seed))


def _requests(n=12, arrival=lambda i: 0.0):
    rng = np.random.default_rng(4)
    shared = rng.integers(0, 128, 8).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate(
        [shared, rng.integers(0, 128, int(rng.integers(3, 12)))
         .astype(np.int32)]), max_new_tokens=int(rng.integers(6, 20)),
        arrival_s=arrival(i)) for i in range(n)]


def _one_table(model, requests, **kw):
    kv = SlotKVCache(model, None, 4, device="cuda", **TABLE)
    s = ContinuousBatcher(kv, clock=VirtualClock(), **kw).run(requests)
    return {r.rid: r.tokens for r in s["results"]}


def _assert_no_failure(s):
    """No replica failed over: a caught failure whose requests a
    survivor served would give the same streams."""
    fleet = s["serve_fleet"]
    assert fleet["failovers"] == 0 and fleet["failed_replicas"] == []
    assert fleet["faults_injected"] == [] and fleet["retries"] == 0


@pytest.mark.parametrize("multi_step", [None, 4])
def test_threaded_replicas_match_one_table(cuda_device, multi_step):
    model = _model()
    kw = {} if multi_step is None else dict(multi_step=multi_step)
    want = _one_table(model, _requests(), **kw)
    rs = ReplicaSet(build_replica_kvs(model, None, 2, 4, device="cuda",
                                      **TABLE), **kw)
    assert rs.threaded
    assert all(r.stream is not None for r in rs.replicas)
    captures, replays = RoundGraph.captures, RoundGraph.replays
    tpa.paged_attention.launches = 0
    try:
        s = rs.run(_requests())
    finally:
        rs.close()
    torch.cuda.synchronize()
    assert s["completed"] == 12 and s["serve_duplicate_emissions"] == 0
    _assert_no_failure(s)
    assert {r.rid: r.tokens for r in s["results"]} == want
    assert RoundGraph.captures == captures
    if multi_step is None:
        assert tpa.paged_attention.launches == LAYERS * s[
            "decode_iterations"]
        assert RoundGraph.replays == replays
    else:
        rounds = s["serve_dispatches"] - s["prefills"]
        assert RoundGraph.replays - replays == rounds > 0
        assert tpa.paged_attention.launches == LAYERS * multi_step * rounds


def test_swap_reaches_the_captured_round(cuda_device):
    model = _model()
    new = {k: v * 0.5 for k, v in model.state_dict().items()}
    reqs = _requests(n=6, arrival=lambda i: 0.0 if i < 3 else 500.0)
    old_streams = _one_table(model, reqs, multi_step=4)
    twin = _model()
    twin.load_state_dict(new)
    new_streams = _one_table(twin, reqs, multi_step=4)
    rs = ReplicaSet(build_replica_kvs(model, None, 1, 4, device="cuda",
                                      **TABLE),
                    clock=VirtualClock(), multi_step=4)
    kv = rs.replicas[0].kv
    ptrs = [p.data_ptr() for p in kv.model.parameters()]
    rs.schedule_swap(new, after_completions=3)
    captures, replays = RoundGraph.captures, RoundGraph.replays
    s = rs.run(reqs)
    torch.cuda.synchronize()
    assert rs.swap_generations == 1 and s["completed"] == 6
    _assert_no_failure(s)
    got = {r.rid: r.tokens for r in s["results"]}
    assert {i: got[i] for i in range(3)} == {
        i: old_streams[i] for i in range(3)}
    assert {i: got[i] for i in range(3, 6)} == {
        i: new_streams[i] for i in range(3, 6)}
    assert old_streams[3] != new_streams[3]
    assert RoundGraph.captures == captures
    assert RoundGraph.replays > replays
    assert [p.data_ptr() for p in kv.model.parameters()] == ptrs


def test_threaded_swap_waits_for_its_weights(cuda_device):
    """A swap scheduled on one thread and performed on the replica's
    worker thread, on its own stream, reads the new weights only once the
    caller's stream has written them: here they are computed behind a
    spin of the caller's stream, which a copy not ordered after it would
    overtake."""
    model = _model()
    new = {k: v * 0.5 for k, v in model.state_dict().items()}
    twin = _model()
    twin.load_state_dict(new)
    want = _one_table(twin, _requests(n=6), multi_step=4)
    rs = ReplicaSet(build_replica_kvs(model, None, 1, 4, device="cuda",
                                      **TABLE), multi_step=4)
    assert rs.threaded
    captures = RoundGraph.captures
    torch.cuda._sleep(200_000_000)           # ~0.1 s on the caller's stream
    fresh = {k: v * 0.5 for k, v in model.state_dict().items()}
    rs.schedule_swap(fresh, after_completions=0)
    try:
        s = rs.run(_requests(n=6))
    finally:
        rs.close()
    torch.cuda.synchronize()
    assert rs.swap_generations == 1 and s["completed"] == 6
    _assert_no_failure(s)
    assert {r.rid: r.tokens for r in s["results"]} == want
    assert RoundGraph.captures == captures
