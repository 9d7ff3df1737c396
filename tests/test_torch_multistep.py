"""Port of the fused k-step decode round (``advance_multi`` /
``dispatch_multi`` + ``drain_multi``) and the batcher's ``multi_step``
pipeline, held to the JAX package at a small size in f32
(``tests/test_serving_multistep.py``'s counterpart): ``advance_multi(k)``
equals k single steps and the JAX table's steps, k ∈ {1, 2, 4, 8}, on both
layouts, f32 and int8; EOS and budget deactivation on the device; the
pipeline's guards; greedy streams bitwise equal to single-step decode and
to the JAX batcher at every k in fewer dispatches, alone and with the
serving features; per-token ITL under ``VirtualClock``; admission
staleness at most k; validation; the fused draft loop; sampled streams
equal to single-step decode at a seed (``sample_tokens`` is
``torch.multinomial``'s draw).  On the CPU a round is the eager loop; the
CUDA graph is held to it in ``tests/test_torch_multistep_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu.models.gpt import GPTLM as JaxGPT
from distributed_tensorflow_tpu.serving import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest,
    RequestQueue as JaxQueue, SlotKVCache as JaxKV,
    VirtualClock as JaxClock)
from distributed_tensorflow_tpu_torch.models.convert import gpt_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, sample_tokens
from distributed_tensorflow_tpu_torch.serving import (
    ContinuousBatcher, Request, RequestQueue, SlotKVCache, VirtualClock)

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TARGET = dict(vocab_size=64, hidden=32, layers=2, heads=2, ffn=64,
              max_len=32, dropout_rate=0.0)
DRAFT = dict(TARGET, hidden=16, layers=1, ffn=32)
BLK = 4
MULTI_KEYS = {"serve_multi_step", "serve_dispatches", "serve_host_gap_s"}


def _init(cfg, key):
    jm = JaxGPT(**cfg)
    x = jnp.asarray(np.random.default_rng(0).integers(0, 64, (2, 8)),
                    jnp.int32)
    params = jm.init(jax.random.key(key), x, train=False)["params"]
    return jm, params, gpt_state_dict(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def target():
    return _init(TARGET, 0)


@pytest.fixture(scope="module")
def draft():
    return _init(DRAFT, 1)


def _kv(model, slots=3, layout="monolithic", **kw):
    if layout == "paged":
        kw.setdefault("paged_block", BLK)
    cfg = TARGET if model[0].layers == 2 else DRAFT
    return SlotKVCache(GPTLM(**cfg, device="cpu"), model[2], slots,
                       kv_layout=layout, device="cpu", **kw)


def _requests(cls=Request, n=8, seed=7, spread=0.05, head=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(0, 64, 3 + (i % 5)).astype(np.int32)
        if head is not None:
            p = np.concatenate([head, p])
        out.append(cls(i, p, 4 + (i % 6), spread * i))
    return out


def _streams(summary):
    return {r.rid: r.tokens for r in summary["results"]}


def _run(model, multi_step, *, slots=3, kv_kw=None, b_kw=None, reqs=None,
         draft_kv=None):
    kv = _kv(model, slots, **(kv_kw or {}))
    s = ContinuousBatcher(kv, clock=VirtualClock(), multi_step=multi_step,
                          draft_kv=draft_kv, **(b_kw or {})).run(
        RequestQueue(reqs if reqs is not None else _requests()))
    return kv, s


# ------------------------------------------------------- the slot table


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_advance_multi_matches_k_single_steps(target, layout, kv_dtype):
    """Rounds of k = 1, 2, 4, 8 equal 15 single steps of the port's table
    and of the JAX table: tokens, lengths, last tokens; one dispatch per
    round, and every slot active at every level."""
    kw = dict(layout=layout,
              **({} if kv_dtype is None else dict(kv_dtype=kv_dtype)))
    single, fused = _kv(target, **kw), _kv(target, **kw)
    jkw = dict(kw)
    jlayout = jkw.pop("layout")
    jkv = JaxKV(target[0], target[1], slots=3, kv_layout=jlayout,
                **(dict(paged_block=BLK) if jlayout == "paged" else {}),
                **jkw)
    for r in _requests(n=3, seed=2):
        assert fused.insert(r.prompt) == single.insert(r.prompt) \
            == jkv.insert(r.prompt)
    want = np.stack([jkv.advance() for _ in range(15)])
    np.testing.assert_array_equal(
        np.stack([single.advance() for _ in range(15)]), want)
    levels = []
    for k in (1, 2, 4, 8):
        d0 = fused.dispatch_count
        toks, acts = fused.advance_multi(k)
        assert fused.dispatch_count == d0 + 1
        assert toks.shape == acts.shape == (k, 3) and acts.all()
        levels.append(toks)
    np.testing.assert_array_equal(np.concatenate(levels), want)
    np.testing.assert_array_equal(fused.lengths, jkv.lengths)
    np.testing.assert_array_equal(fused.tokens, jkv.tokens)
    assert not fused._inflight.any()


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_in_device_deactivation_eos_and_budget(target, layout):
    """A budget stops a slot after that many emissions and an EOS the
    step it is emitted, inside the round; a stopped slot is ``halted``
    and left out of the next round, and a rewind clears that."""
    kv = _kv(target, 2, layout)
    reqs = _requests(n=2, seed=3)
    s0, _ = kv.insert(reqs[0].prompt)
    s1, _ = kv.insert(reqs[1].prompt)
    kv.set_decode_limits(s0, None, 2)
    _, acts = kv.advance_multi(5)
    assert acts[:, s0].tolist() == [True, True, False, False, False]
    assert acts[:, s1].all()
    assert kv.halted[s0] and not kv.halted[s1]
    assert int(kv.budget[s0]) == 0
    _, acts2 = kv.advance_multi(2)
    assert not acts2[:, s0].any() and acts2[:, s1].all()
    kv.rewind(s0, int(kv.lengths[s0]), int(kv.tokens[s0]))
    assert kv.advance_multi(1)[1][:, s0].all()
    with pytest.raises(ValueError, match="budget"):
        kv.set_decode_limits(s0, None, -1)
    # EOS: the slot's third emission; the round stops it at level 2
    for seed in range(20):
        p = _requests(n=1, seed=seed)[0].prompt
        ref = _kv(target, 1, layout)
        first = ref.insert(p)[1]
        nxt = [int(ref.advance()[0]) for _ in range(3)]
        if nxt[2] not in (first, nxt[0], nxt[1]):
            break
    else:
        pytest.fail("no greedy stream of three new tokens in 20 seeds")
    kv2 = _kv(target, 1, layout)
    kv2.insert(p)
    kv2.set_decode_limits(0, nxt[2], 0)        # budget 0 = unlimited
    toks3, acts3 = kv2.advance_multi(5)
    assert acts3[:, 0].tolist() == [True, True, True, False, False]
    assert toks3[:3, 0].tolist() == nxt and kv2.halted[0]
    assert int(kv2.tokens[0]) == nxt[2]


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_pipeline_discipline_guards(target, layout):
    """A single step refuses while a round is out, rounds drain in
    dispatch order, and ``abandon_multi`` drops the outstanding rounds
    without touching the host mirrors; the table then decodes on."""
    kv = _kv(target, 2, layout)
    kv.insert(_requests(n=1, seed=4)[0].prompt)
    h1 = kv.dispatch_multi(2)
    h2 = kv.dispatch_multi(2)
    assert kv.pending_multi == 2
    assert int(kv._inflight[0]) == 4
    with pytest.raises(RuntimeError, match="in flight"):
        kv.advance()
    with pytest.raises(RuntimeError, match="dispatch order"):
        kv.drain_multi(h2)
    kv.drain_multi(h1)
    kv.drain_multi(h2)
    assert kv.pending_multi == 0 and not kv._inflight.any()
    lens = kv.lengths.copy()
    kv.dispatch_multi(3)
    kv.abandon_multi()
    assert kv.pending_multi == 0 and not kv._inflight.any()
    np.testing.assert_array_equal(kv.lengths, lens)
    kv.evict(0)
    kv.insert(_requests(n=1, seed=5)[0].prompt)
    _, acts = kv.advance_multi(2)
    assert acts[:, 0].all()


def test_multi_step_validation(target):
    kv = _kv(target, 2)
    with pytest.raises(ValueError, match=">= 1"):
        kv.dispatch_multi(0)
    with pytest.raises(RuntimeError, match="no fused round"):
        kv.drain_multi()
    with pytest.raises(ValueError, match="multi_step"):
        ContinuousBatcher(kv, multi_step=0)


# ------------------------------------------------------------ the batcher


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_bitwise_parity_and_fewer_dispatches(target, layout):
    """Greedy streams at k = 1, 2, 4, 8 equal the single-step batcher's
    and the JAX batcher's, in fewer dispatches as k grows (the JAX
    batcher's count at k = 4); without the option the summary has no
    multi-step key."""
    kv_kw = dict(layout=layout)
    jkw = dict(paged_block=BLK) if layout == "paged" else {}
    want = JaxBatcher(JaxKV(target[0], target[1], slots=3,
                            kv_layout=layout, **jkw),
                      clock=JaxClock(), multi_step=4).run(
        JaxQueue(_requests(JaxRequest)))
    _, s0 = _run(target, None, kv_kw=kv_kw)
    _, s1 = _run(target, 1, kv_kw=kv_kw)
    oracle = _streams(s0)
    assert oracle == _streams(s1) == _streams(want)
    assert not MULTI_KEYS & set(s0)
    assert set(s0) == set(s1) - MULTI_KEYS
    prev = s1["serve_dispatches"]
    for k in (2, 4, 8):
        kvk, sk = _run(target, k, kv_kw=kv_kw)
        assert _streams(sk) == oracle, k
        assert sk["serve_dispatches"] < s1["serve_dispatches"], k
        assert sk["serve_dispatches"] <= prev, k
        assert sk["serve_multi_step"] == k and sk["serve_host_gap_s"] >= 0
        assert kvk.free_slots == [0, 1, 2] and not kvk._inflight.any()
        prev = sk["serve_dispatches"]
        if k == 4:
            assert sk["serve_dispatches"] == want["serve_dispatches"]
            assert sk["decode_iterations"] == want["decode_iterations"]
            assert [r.itl_s for r in sk["results"]] == [
                r.itl_s for r in want["results"]]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_itl_is_per_token_under_virtual_clock(target, k):
    """A fused round's tokens are delivered level by level: every gap
    after a request's first is one decode iteration."""
    _, s = _run(target, k)
    for r in s["results"]:
        assert all(g == 1.0 for g in r.itl_s[1:]), (k, r.rid, r.itl_s)


def test_admission_staleness_bounded_by_k(target):
    """A request arriving mid-round waits at most k - 1 iterations more
    than at k = 1; one arriving at an idle table is admitted at once."""
    k = 4
    reqs = _requests(n=6, seed=9, spread=0.6)
    _, s1 = _run(target, 1, slots=6, reqs=reqs)
    _, sk = _run(target, k, slots=6, reqs=_requests(n=6, seed=9,
                                                    spread=0.6))
    w1 = {r.rid: r.queue_wait_s for r in s1["results"]}
    wk = {r.rid: r.queue_wait_s for r in sk["results"]}
    for rid in w1:
        assert wk[rid] <= w1[rid] + (k - 1) + 1e-9, (rid, wk[rid], w1[rid])
    assert wk[0] == w1[0] == 0.0


SHARED = np.arange(16, dtype=np.int32) % 64


@pytest.mark.parametrize("case", ["chunk", "prefix", "paged", "int8",
                                  "paged_int8", "paged_prefix"])
def test_parity_composes_with_serving_features(target, case):
    """Multi-step under chunked prefill, the prefix pool, the paged table
    (with its zero-copy pool too) and int8 storage: the same streams as
    single-step decode, in fewer dispatches."""
    kv_kw, b_kw, head = {
        "chunk": (dict(), dict(prefill_chunk=4), None),
        "prefix": (dict(prefix_cache_blocks=8, prefix_block=8), dict(),
                   SHARED),
        "paged": (dict(layout="paged", paged_blocks=48),
                  dict(prefill_chunk=4), None),
        "int8": (dict(kv_dtype="int8"), dict(), None),
        "paged_int8": (dict(layout="paged", paged_blocks=48,
                            kv_dtype="int8"), dict(prefill_chunk=4), None),
        "paged_prefix": (dict(layout="paged", prefix_cache_blocks=8,
                              prefix_block=BLK), dict(prefill_chunk=4),
                         SHARED),
    }[case]
    runs = [_run(target, k, kv_kw=kv_kw, b_kw=b_kw,
                 reqs=_requests(head=head))[1] for k in (None, 1, 4)]
    assert _streams(runs[0]) == _streams(runs[1]) == _streams(runs[2])
    assert runs[2]["serve_dispatches"] < runs[1]["serve_dispatches"]
    if head is not None:
        assert runs[2]["prefix_cache"]["hits"] > 0


@pytest.mark.parametrize("chunk", [0, 4])
def test_fused_draft_loop(target, draft, chunk):
    """With a draft the loop stays per verify round, and the draft's
    proposals come from one fused round: the same streams as without
    ``multi_step`` and without a draft, fewer dispatches than the
    draft's single steps, the same at any k."""
    def run(ms):
        dkv = _kv(draft, 3)
        kv, s = _run(target, ms, draft_kv=dkv,
                     b_kw=dict(draft_k=3, prefill_chunk=chunk))
        return s, kv.dispatch_count + dkv.dispatch_count, dkv

    s_off, d_off, _ = run(None)
    s1, _, _ = run(1)
    s4, _, dkv = run(4)
    _, plain = _run(target, None, b_kw=dict(prefill_chunk=chunk))
    assert _streams(s_off) == _streams(s1) == _streams(s4) \
        == _streams(plain)
    assert s4["serve_dispatches"] < d_off
    assert s4["serve_dispatches"] == s1["serve_dispatches"]
    assert s4["speculative"] == s_off["speculative"]
    assert dkv.free_slots == [0, 1, 2]


# ---------------------------------------------------------------- sampling


def test_sample_tokens_is_multinomials_draw():
    """The exponential race draws what ``torch.multinomial(p, 1)`` draws
    from the same generator state, call after call."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for i in range(6):
        logits = torch.from_numpy(np.random.default_rng(i).standard_normal(
            (5, 64)).astype(np.float32) * 3)
        probs = torch.softmax(logits / 0.8, dim=-1)
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        got = sample_tokens(logits, greedy=False, temperature=0.8,
                            generator=g2)
        assert torch.equal(got, want), i


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_sampled_rounds_equal_single_steps(target, layout):
    """Temperature sampling at a seed: rounds of 4 steps draw what 4
    single steps of a twin table draw (each step takes the generator's
    draws in the same order), over three rounds; another seed draws
    other tokens."""
    def table(seed):
        kv = _kv(target, 3, layout, greedy=False, temperature=1.5,
                 generator=torch.Generator().manual_seed(seed))
        for r in _requests(n=3, seed=2):
            kv.insert(r.prompt)
        return kv

    single, fused, other = table(5), table(5), table(6)
    want = np.stack([single.advance() for _ in range(12)])
    got = np.concatenate([fused.advance_multi(4)[0] for _ in range(3)])
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(
        np.concatenate([other.advance_multi(4)[0] for _ in range(3)]), want)
