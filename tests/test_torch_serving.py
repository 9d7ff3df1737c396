"""Port of ``serving/`` (paged layout + continuous batcher), held to the JAX
package at a small size in f32: paged decode logits step by step against
JAX ``PagedSlotKVCache`` (fused read, Pallas interpret mode), whole seeded
``ContinuousBatcher`` runs on ``VirtualClock`` with chunked prefill whose
greedy token streams and accounting equal the JAX batcher's, and the
port's own block bookkeeping (copy-on-write, admission gates, drain).

Tolerance for decode logits: ``atol=1e-4, rtol=1e-4`` — the fused read's
online softmax reassociates against the gather read's dense softmax (the
JAX package states the same tolerance-only contract), and the error passes
through two layers.  Token streams are compared exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu.serving import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest,
    SlotKVCache as JaxKV, VirtualClock as JaxClock)
from distributed_tensorflow_tpu_torch.models.convert import gpt_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.serving import (
    BlockPoolExhausted, ContinuousBatcher, PagedSlotKVCache, Request,
    SlotKVCache, SlotOverflow, VirtualClock)

SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
             ffn=64, max_len=32, dropout_rate=0.0)
BLK = 4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    """One flax GPT and its port at the same params.  The token embedding
    is scaled ×6 so greedy streams vary instead of repeating one token."""
    jm = JaxGPT(**SMALL)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    params = dict(params, token_embed={
        "embedding": params["token_embed"]["embedding"] * 6.0})
    sd = gpt_state_dict(jax.tree.map(np.asarray, params))
    return jm, params, sd


def _port_kv(sd, slots=3, **kw):
    tm = GPTLM(**SMALL, device="cpu")
    return SlotKVCache(tm, sd, slots, kv_layout="paged", paged_block=BLK,
                       device="cpu", **kw)


def _trace(seed=1, n=6):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 64, int(rng.integers(3, 12)))
             .astype(np.int32), int(rng.integers(2, 10)),
             float(rng.integers(0, 6))) for i in range(n)]


def test_paged_decode_logits_match_jax_steps(models):
    """Admit three prompts, then four decode steps: each step's logits
    (fused kernel read) equal the JAX paged table's, and so do the greedy
    tokens and the block tables."""
    jm, params, sd = models
    jkv = JaxKV(jm, params, slots=3, kv_layout="paged", paged_block=BLK)
    tkv = _port_kv(sd)
    rng = np.random.default_rng(5)
    for n in (5, 9, 3):
        prompt = rng.integers(0, 64, n).astype(np.int32)
        assert jkv.insert(prompt) == tkv.insert(prompt)
    tkv.evict(1)
    jkv.evict(1)                   # an inactive row routed to scratch
    for _ in range(4):
        mask = jkv.active
        for s in np.flatnonzero(mask):     # what jkv.advance does first
            jkv._ensure_writable(int(s), int(jkv.lengths[s]),
                                 int(jkv.lengths[s]) + 1)
        bt = jkv._masked_bt(mask)
        want, _ = jkv.dm.apply(
            {"params": jkv.params, "cache": jkv.cache},
            jnp.asarray(jkv.tokens)[:, None], train=False,
            positions=jnp.asarray(jkv.lengths)[:, None], block_tables=bt,
            mutable=["cache"])
        got = tkv.decode_logits()
        np.testing.assert_allclose(got[mask].numpy(),
                                   np.asarray(want[:, -1])[mask],
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(tkv.advance(), jkv.advance())
        np.testing.assert_array_equal(tkv.lengths, jkv.lengths)
    np.testing.assert_array_equal(tkv.block_tables_np, jkv.block_tables_np)
    assert tkv.kv_bytes_per_slot() == jkv.kv_bytes_per_slot()
    assert tkv.paged_stats() == jkv.paged_stats()


@pytest.mark.parametrize("mode, chunk", [("continuous", 4),
                                         ("static", 0)])
def test_batcher_streams_equal_jax_batcher(models, mode, chunk):
    """A seeded VirtualClock run: greedy token streams, TTFTs, ITLs and
    the run accounting equal the JAX batcher's."""
    jm, params, sd = models
    trace = _trace()
    jkv = JaxKV(jm, params, slots=3, kv_layout="paged", paged_block=BLK)
    want = JaxBatcher(jkv, clock=JaxClock(), mode=mode,
                      prefill_chunk=chunk).run(
        [JaxRequest(i, p, n, a) for i, p, n, a in trace])
    got = ContinuousBatcher(_port_kv(sd), clock=VirtualClock(), mode=mode,
                            prefill_chunk=chunk).run(
        [Request(i, p, n, a) for i, p, n, a in trace])
    assert len({t for r in got["results"] for t in r.tokens}) > 3
    for a, b in zip(want["results"], got["results"]):
        assert (a.rid, a.tokens) == (b.rid, b.tokens)
        assert (a.ttft_s, a.itl_s, a.queue_wait_s) == (
            b.ttft_s, b.itl_s, b.queue_wait_s)
    for key in ("completed", "decode_iterations", "prefills",
                "prefill_chunks", "prefill_tokens", "decode_tokens",
                "tokens_generated", "elapsed_s", "serve_tokens_per_sec",
                "serve_requests_per_sec", "serve_ttft_p50_s",
                "serve_ttft_p95_s", "serve_itl_p50_s", "serve_itl_p95_s",
                "serve_kv_bytes_per_slot", "serve_kv_layout",
                "serve_kv_dtype", "serve_kv_blocks_in_use", "paged",
                "queue_depth_high_watermark", "offered", "admitted"):
        assert got[key] == want[key], key


def test_fused_and_gather_tables_agree(models):
    """paged_fused=False keeps decode on the gather read: same greedy
    stream, logits within tolerance of the fused read."""
    _, _, sd = models
    trace = _trace(seed=3, n=4)
    runs = [ContinuousBatcher(_port_kv(sd, paged_fused=fused),
                              clock=VirtualClock(), prefill_chunk=3).run(
        [Request(i, p, n, a) for i, p, n, a in trace])
        for fused in (True, False)]
    assert ([r.tokens for r in runs[0]["results"]]
            == [r.tokens for r in runs[1]["results"]])


def test_copy_on_write_isolates_a_shared_block(models):
    """A block shared by two slots (refcount 2) is copied before a write:
    the writer gets a private copy, the other sharer keeps the original."""
    _, _, sd = models
    kv = _port_kv(sd, slots=2)
    kv.insert(np.arange(1, 7, dtype=np.int32))          # slot 0: 2 blocks
    shared = kv._slot_blocks[0][0]
    kv._slot_blocks[1].append(shared)                   # alias into slot 1
    kv.block_tables_np[1, 0] = shared
    kv._block_refs[shared] += 1
    before = kv.cache[0]["key_pool"][shared].clone()
    kv._ensure_writable(1, 2, 3)
    new = kv._slot_blocks[1][0]
    assert new != shared and kv.block_tables_np[1, 0] == new
    assert kv._block_refs[shared] == 1
    assert kv.paged_stats()["cow_copies"] == 1
    assert torch.equal(kv.cache[0]["key_pool"][new], before)
    assert torch.equal(kv.cache[0]["key_pool"][shared], before)


def test_block_pool_gates(models):
    """can_admit counts free blocks minus live budgets; a pool run dry
    mid-flight raises BlockPoolExhausted; an overflow raises SlotOverflow;
    eviction returns every block."""
    _, _, sd = models
    kv = _port_kv(sd, slots=2, paged_blocks=8)
    assert kv.can_admit(10, 22)                         # 8 blocks needed
    slot, _ = kv.insert(np.arange(1, 11, dtype=np.int32))
    kv.note_admission(slot, 32)
    assert not kv.can_admit(4, 4)                       # budget holds 8
    kv2 = _port_kv(sd, slots=2, paged_blocks=8)
    kv2.insert(np.arange(1, 30, dtype=np.int32))        # 8 blocks
    with pytest.raises(BlockPoolExhausted):
        kv2.insert(np.arange(1, 4, dtype=np.int32))
    assert kv2.free_slots == [1] and kv2.blocks_in_use == 8
    kv2.lengths[0] = 32
    with pytest.raises(SlotOverflow):
        kv2.advance()
    kv2.lengths[0] = 29
    kv2.evict(0)
    assert kv2.blocks_in_use == 0


def test_scheduler_defers_on_block_pressure_and_drains(models):
    """Pool pressure defers admissions (counted) but every request
    completes and the pool drains back to zero blocks."""
    _, _, sd = models
    kv = _port_kv(sd, slots=3, paged_blocks=8)
    reqs = [Request(i, np.arange(1, 12, dtype=np.int32), 10)
            for i in range(4)]
    res = ContinuousBatcher(kv, clock=VirtualClock()).run(reqs)
    assert res["completed"] == 4 and res["serve_kv_block_deferrals"] > 0
    assert kv.blocks_in_use == 0 and res["paged"]["blocks_in_use"] == 0


def test_queue_cap_and_lease_drain_conserve_requests(models):
    _, _, sd = models
    reqs = [Request(i, np.arange(1, 6, dtype=np.int32), 4)
            for i in range(8)]
    res = ContinuousBatcher(_port_kv(sd), clock=VirtualClock(),
                            queue_cap=2).run(reqs)
    assert res["shed_requests"] > 0
    assert (res["admitted"] + res["shed_requests"]
            + res["unserved_requests"] == res["offered"] == 8)
    res = ContinuousBatcher(
        _port_kv(sd), clock=VirtualClock(),
        should_stop=lambda it: "lease" if it >= 2 else None).run(
        [Request(i, np.arange(1, 6, dtype=np.int32), 4, float(i))
         for i in range(8)])
    assert res["preempted"] == "lease" and res["unserved_requests"] > 0
    assert res["admitted"] + res["unserved_requests"] == 8


def test_unported_serving_options_raise(models):
    _, _, sd = models
    tm = GPTLM(**SMALL, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlotKVCache(tm, sd, 2)                          # monolithic
    for kw in (dict(prefix_cache_blocks=4), dict(kv_dtype="int8"),
               dict(greedy=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SlotKVCache(tm, sd, 2, kv_layout="paged", device="cpu", **kw)
    kv = _port_kv(sd)
    assert isinstance(kv, PagedSlotKVCache)
    for kw in (dict(multi_step=2), dict(draft_kv=kv),
               dict(role="prefill", handoff_out=print)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ContinuousBatcher(kv, **kw)
    # options of features the port lacks are not accepted and ignored
    for kw in (dict(prefill_bucket=16), dict(temperature=0.5)):
        with pytest.raises(TypeError):
            SlotKVCache(tm, sd, 2, kv_layout="paged", device="cpu", **kw)
    for kw in (dict(draft_k=8), dict(timeline_tag=1)):
        with pytest.raises(TypeError):
            ContinuousBatcher(kv, **kw)
