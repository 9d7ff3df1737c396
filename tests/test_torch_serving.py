"""Port of ``serving/`` (both table layouts + continuous batcher), held to
the JAX package at a small size in f32: monolithic and paged decode logits
step by step against the JAX tables (the paged fused read in Pallas
interpret mode), whole seeded ``ContinuousBatcher`` runs on
``VirtualClock`` — both layouts, prefix pool off and on, bf16-free f32 and
int8 storage — whose greedy token streams, latencies and accounting equal
the JAX batcher's, the prefix pool's LRU and the paged zero-copy ledger
(block tables, refcount pins, copy-on-write) against JAX, temperature
sampling, and the port's own block bookkeeping (copy-on-write, admission
gates, drain).

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
from distributed_tensorflow_tpu_torch.models.gpt import (
    generate, sample_tokens)

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

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


def _port_kv(sd, slots=3, layout="paged", **kw):
    tm = GPTLM(**SMALL, device="cpu")
    if layout == "paged":
        kw.setdefault("paged_block", BLK)
    return SlotKVCache(tm, sd, slots, kv_layout=layout, prefix_block=BLK,
                       device="cpu", **kw)


def _jax_kv(jm, params, slots=3, layout="paged", **kw):
    if layout == "paged":
        kw.setdefault("paged_block", BLK)
    return JaxKV(jm, params, slots=slots, kv_layout=layout,
                 prefix_block=BLK, **kw)


def _trace(seed=1, n=6, shared=0):
    """Seeded requests (rid, prompt, max_new_tokens, arrival); with
    ``shared`` every prompt starts with the same ``shared`` tokens."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 64, shared).astype(np.int32)
    return [(i, np.concatenate([head, rng.integers(
        0, 64, int(rng.integers(3, 12))).astype(np.int32)]),
        int(rng.integers(2, 10)), float(rng.integers(0, 6)))
        for i in range(n)]


def _run_pair(jkv, tkv, trace, **kw):
    want = JaxBatcher(jkv, clock=JaxClock(), **kw).run(
        [JaxRequest(i, p, n, a) for i, p, n, a in trace])
    got = ContinuousBatcher(tkv, clock=VirtualClock(), **kw).run(
        [Request(i, p, n, a) for i, p, n, a in trace])
    return want, got


def _assert_streams_equal(want, got):
    assert len(want["results"]) == len(got["results"])
    for a, b in zip(want["results"], got["results"]):
        assert (a.rid, a.tokens) == (b.rid, b.tokens)
        assert (a.ttft_s, a.itl_s, a.queue_wait_s) == (
            b.ttft_s, b.itl_s, b.queue_wait_s)


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


SUMMARY_KEYS = (
    "completed", "decode_iterations", "prefills", "prefill_chunks",
    "prefill_tokens", "decode_tokens", "tokens_generated", "elapsed_s",
    "serve_tokens_per_sec", "serve_requests_per_sec", "serve_ttft_p50_s",
    "serve_ttft_p95_s", "serve_itl_p50_s", "serve_itl_p95_s",
    "serve_kv_bytes_per_slot", "serve_kv_layout", "serve_kv_dtype",
    "serve_kv_blocks_in_use", "serve_kv_block_utilization", "paged",
    "serve_prefix_cache_hit_rate", "prefix_cache",
    "serve_prefix_zero_copy_hit_rate", "queue_depth_high_watermark",
    "offered", "admitted")


@pytest.mark.parametrize("mode, chunk, layout, pool", [
    ("continuous", 4, "paged", 0), ("continuous", 4, "paged", 8),
    ("continuous", 4, "monolithic", 0), ("continuous", 4, "monolithic", 8),
    ("static", 0, "paged", 0), ("static", 0, "monolithic", 8)])
def test_batcher_streams_equal_jax_batcher(models, mode, chunk, layout,
                                           pool):
    """A seeded VirtualClock run in each layout, prefix pool off and on
    (every prompt then shares an 8-token head): greedy token streams,
    TTFTs, ITLs and the run accounting equal the JAX batcher's."""
    jm, params, sd = models
    trace = _trace(shared=8 if pool else 0)
    want, got = _run_pair(
        _jax_kv(jm, params, layout=layout, prefix_cache_blocks=pool),
        _port_kv(sd, layout=layout, prefix_cache_blocks=pool), trace,
        mode=mode, prefill_chunk=chunk)
    assert len({t for r in got["results"] for t in r.tokens}) > 3
    _assert_streams_equal(want, got)
    for key in SUMMARY_KEYS:
        assert got[key] == want[key], key
    if pool:
        assert got["prefix_cache"]["hits"] > 0


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


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_int8_streams_equal_jax(models, layout):
    """int8 K/V storage (one f32 max-abs scale per written vector, the
    codec bitwise equal to JAX's): greedy streams, latencies and the
    stored bytes per slot equal the JAX int8 table's."""
    jm, params, sd = models
    trace = _trace(seed=4, shared=8)
    want, got = _run_pair(
        _jax_kv(jm, params, layout=layout, kv_dtype="int8",
                prefix_cache_blocks=8),
        _port_kv(sd, layout=layout, kv_dtype="int8", prefix_cache_blocks=8),
        trace, prefill_chunk=4)
    _assert_streams_equal(want, got)
    for key in SUMMARY_KEYS:
        assert got[key] == want[key], key
    assert got["serve_kv_dtype"] == "int8"


def test_monolithic_decode_logits_match_jax_steps(models):
    """Monolithic table: admit three prompts (bf16 storage), evict one,
    four decode steps — each step's logits equal the JAX monolithic
    step's, and so do the greedy tokens and the bytes per slot."""
    jm, params, sd = models
    jkv = _jax_kv(jm, params, layout="monolithic", kv_dtype="bfloat16")
    tkv = _port_kv(sd, layout="monolithic", kv_dtype="bfloat16")
    assert not isinstance(tkv, PagedSlotKVCache)
    rng = np.random.default_rng(5)
    for n in (5, 9, 3):
        prompt = rng.integers(0, 64, n).astype(np.int32)
        assert jkv.insert(prompt) == tkv.insert(prompt)
    tkv.evict(1)
    jkv.evict(1)
    for _ in range(4):
        want, _ = jkv.dm.apply(
            {"params": jkv.params, "cache": jkv.cache},
            jnp.asarray(jkv.tokens)[:, None], train=False,
            positions=jnp.asarray(jkv.lengths)[:, None], mutable=["cache"])
        got = tkv.decode_logits()
        mask = jkv.active
        np.testing.assert_allclose(got[mask].numpy(),
                                   np.asarray(want[:, -1])[mask],
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(tkv.advance(), jkv.advance())
        np.testing.assert_array_equal(tkv.lengths, jkv.lengths)
    assert tkv.kv_dtype == jkv.kv_dtype == "bfloat16"
    assert tkv.kv_bytes_per_slot() == jkv.kv_bytes_per_slot()


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_prefix_pool_lru_eviction_matches_jax(models, layout):
    """A 2-block pool under three 2-block prefixes: LRU evictions, a full
    miss on an evicted prefix, hits once it is pooled again, and a reset —
    the pool ledger and first tokens equal the JAX table's at every step
    (under paged, blocks in use too: eviction and reset release pins)."""
    jm, params, sd = models
    jkv = _jax_kv(jm, params, slots=1, layout=layout, prefix_cache_blocks=2)
    tkv = _port_kv(sd, slots=1, layout=layout, prefix_cache_blocks=2)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 64, 10).astype(np.int32) for _ in range(3)]
    for p in prompts + prompts[:1] + prompts[:1]:
        (js, jf), (ts, tf) = jkv.insert(p), tkv.insert(p)
        assert (js, jf) == (ts, tf)
        jkv.evict(js)
        tkv.evict(ts)
        assert tkv.prefix_cache_stats() == jkv.prefix_cache_stats()
        if layout == "paged":
            assert tkv.blocks_in_use == jkv.blocks_in_use
    stats = tkv.prefix_cache_stats()
    assert stats["evictions"] >= 2 and stats["cached_blocks"] == 2
    assert stats["hits"] > 0
    tkv.reset_prefix_cache()
    jkv.reset_prefix_cache()
    assert tkv.prefix_cache_stats() == jkv.prefix_cache_stats()
    assert tkv.prefix_cache_stats()["cached_blocks"] == 0
    if layout == "paged":
        assert tkv.blocks_in_use == 0


def test_zero_copy_ledger_tables_and_pins_match_jax(models):
    """The paged zero-copy pool against JAX: three admissions of a shared
    8-token prefix alias the same two blocks (counters, block tables and
    refcounts equal JAX's); a fully aligned re-admission copies its last
    block on write; evicted slots leave the pool's pins; reset releases
    them.  Tokens equal JAX's throughout."""
    jm, params, sd = models
    jkv = _jax_kv(jm, params, slots=3, prefix_cache_blocks=8)
    tkv = _port_kv(sd, slots=3, prefix_cache_blocks=8)
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 64, 4)
                               .astype(np.int32)]) for _ in range(3)]

    def same():
        assert tkv.paged_stats() == jkv.paged_stats()
        np.testing.assert_array_equal(tkv.block_tables_np,
                                      jkv.block_tables_np)
        np.testing.assert_array_equal(tkv._block_refs, jkv._block_refs)
        np.testing.assert_array_equal(tkv.lengths, jkv.lengths)
        assert tkv.prefix_cache_stats() == jkv.prefix_cache_stats()

    for p in prompts:
        assert tkv.insert(p) == jkv.insert(p)
        same()
    for _ in range(3):
        np.testing.assert_array_equal(tkv.advance(), jkv.advance())
        same()
    st = tkv.paged_stats()
    assert (st["zero_copy_hits"], st["zero_copy_blocks"],
            st["zero_copy_tokens"], st["cow_copies"]) == (2, 4, 16, 0)
    shared_ids = tkv.block_tables_np[0, :2]
    assert all(tkv._block_refs[int(b)] == 4 for b in shared_ids)
    tkv.evict(0)
    jkv.evict(0)
    aligned = prompts[0][:8]                  # exactly the pooled blocks
    assert tkv.insert(aligned) == jkv.insert(aligned)
    same()
    assert tkv.paged_stats()["cow_copies"] == 1
    for _ in range(2):
        np.testing.assert_array_equal(tkv.advance(), jkv.advance())
    for s in np.flatnonzero(tkv.active):
        tkv.evict(int(s))
        jkv.evict(int(s))
    same()
    assert tkv.blocks_in_use == len(tkv._prefix_pool) > 0
    tkv.reset_prefix_cache()
    jkv.reset_prefix_cache()
    same()
    assert tkv.blocks_in_use == 0


def test_prefix_pool_lowers_virtual_ttft(models):
    """With prefill cost modelled (``prefill_token_tick``), the pooled run's
    TTFT p50 is lower than the pool-off run's on the same trace, with the
    same token streams."""
    _, _, sd = models
    rng = np.random.default_rng(14)
    shared = rng.integers(0, 64, 12).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 64, 3)
                               .astype(np.int32)]) for _ in range(4)]

    def run(blocks):
        return ContinuousBatcher(
            _port_kv(sd, slots=2, layout="monolithic",
                     prefix_cache_blocks=blocks),
            clock=VirtualClock(prefill_token_tick=0.5)).run(
            [Request(i, p, 4, float(i)) for i, p in enumerate(prompts)])

    cached, cold = run(32), run(0)
    assert cached["serve_prefix_cache_hit_rate"] > 0
    assert cold["serve_prefix_cache_hit_rate"] is None
    assert cold["paged"] is None and cold["serve_kv_blocks_in_use"] is None
    assert cached["serve_ttft_p50_s"] < cold["serve_ttft_p50_s"]
    assert ([r.tokens for r in cached["results"]]
            == [r.tokens for r in cold["results"]])


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_temperature_sampling_is_seeded(models, layout):
    """``greedy=False`` draws with the table's generator: at T = 4 the same
    seed gives the same streams and another seed other streams; T = 1e-6
    gives the greedy streams."""
    _, _, sd = models
    trace = _trace(seed=2)

    def run(**kw):
        res = ContinuousBatcher(_port_kv(sd, layout=layout, **kw),
                                clock=VirtualClock(), prefill_chunk=4).run(
            [Request(i, p, n, a) for i, p, n, a in trace])
        return [r.tokens for r in res["results"]]

    def seeded(seed, temperature=4.0):
        return run(greedy=False, temperature=temperature,
                   generator=torch.Generator().manual_seed(seed))

    first = seeded(3)
    assert first == seeded(3) != seeded(4)
    assert all(0 <= t < 64 for toks in first for t in toks)
    assert seeded(5, temperature=1e-6) == run()


def test_sample_tokens_frequencies_follow_softmax():
    """Draw frequencies of ``sample_tokens`` over a 4-token vocabulary match
    ``softmax(logits / T)`` within 5 standard errors; ``generate`` draws
    the same stream from the same seed."""
    logits = torch.tensor([[1.0, 0.0, -0.5, 2.0]]).expand(40000, 4)
    for temp in (0.8, 2.0):
        toks = sample_tokens(logits, greedy=False, temperature=temp,
                             generator=torch.Generator().manual_seed(0))
        freq = np.bincount(toks.numpy(), minlength=4) / len(toks)
        want = torch.softmax(logits[0] / temp, -1).numpy()
        se = np.sqrt(want * (1 - want) / len(toks))
        assert np.all(np.abs(freq - want) < 5 * se), (temp, freq, want)
    assert torch.equal(sample_tokens(logits[:3], greedy=True),
                       torch.full((3,), 3))
    tm = GPTLM(**SMALL, device="cpu")
    prompt = np.arange(6, dtype=np.int32).reshape(2, 3)
    a, b = (generate(tm, None, prompt, 8, temperature=0.8, device="cpu",
                     generator=torch.Generator().manual_seed(1))
            for _ in range(2))
    assert torch.equal(a, b)


def test_unported_serving_options_raise(models):
    _, _, sd = models
    tm = GPTLM(**SMALL, device="cpu")
    # ported since: the program ledger and the batcher's roofline
    from distributed_tensorflow_tpu_torch.observability import (
        ProgramLedger, Roofline)

    for layout in ("monolithic", "paged"):
        ledger = ProgramLedger()
        SlotKVCache(tm, sd, 2, kv_layout=layout, device="cpu",
                    ledger=ledger).insert(np.arange(3, dtype=np.int32))
        assert ledger.programs()
    # ported since: mesh-sharded tables (TP decode), which keep JAX's
    # refusal of slots the 'data' axis does not divide
    from distributed_tensorflow_tpu_torch.parallel.mesh import Mesh

    two = Mesh(rank=0, world_size=2, device=torch.device("cpu"),
               backend="gloo")
    for layout in ("monolithic", "paged"):
        with pytest.raises(ValueError, match=r"slots \(3\) must divide by "
                           r"the mesh's data axis \(2\)"):
            SlotKVCache(tm, sd, 3, kv_layout=layout, device="cpu",
                        mesh=two)
    kv = _port_kv(sd)
    assert isinstance(kv, PagedSlotKVCache)
    assert not isinstance(_port_kv(sd, layout="monolithic"),
                          PagedSlotKVCache)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatcher(kv, role="prefill", handoff_out=print)
    # ported since: speculative decoding and multi-step rounds
    ContinuousBatcher(kv, multi_step=2)
    ContinuousBatcher(kv, draft_kv=_port_kv(sd), draft_k=8)
    # options of features the port lacks are not accepted and ignored
    for layout in ("monolithic", "paged"):
        with pytest.raises(TypeError):
            SlotKVCache(tm, sd, 2, kv_layout=layout, device="cpu",
                        prefill_bucket=16)
    with pytest.raises(ValueError, match="must equal prefix_block"):
        SlotKVCache(tm, sd, 2, kv_layout="paged", device="cpu",
                    prefix_cache_blocks=4, prefix_block=4, paged_block=8)
    with pytest.raises(ValueError, match="only apply"):
        SlotKVCache(tm, sd, 2, device="cpu", paged_block=4)
    assert ContinuousBatcher(kv, roofline=Roofline(None)).roofline \
        is not None
    # ported since: the timeline sampler and its replica tag
    ContinuousBatcher(kv, timeline=object(), timeline_tag=1)
