"""Port of speculative decoding (draft-k → verify-1), held to the JAX
package at a small size in f32 (``tests/test_spec_decode.py``'s
counterpart): ``verify_block``'s logits and argmaxes against the JAX
table's verify forward at widths 2-5 on both layouts, f32 and int8;
rollback by length bookkeeping alone; the guards of ``rewind`` and
``verify_block``; ``advance(only=)``; whole ``ContinuousBatcher`` runs
whose speculative streams equal the non-speculative port batcher's and the
JAX speculative batcher's (draft 'self' and a random 1-layer draft, with
and without the fused draft loop), with the conservation ledger, EOS, ITL
per emitted token, draft validation and failure cleanup.

Tolerance for verify logits: ``atol=rtol=1e-4`` (as
``tests/test_torch_serving.py``: the paged fused read reassociates the
softmax against the gather read).  Argmaxes and token streams are compared
exactly.
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
from distributed_tensorflow_tpu.utils.harness import (
    parse_draft_config as jax_parse_draft_config)
from distributed_tensorflow_tpu_torch.models.convert import gpt_state_dict
from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.serving import (
    ContinuousBatcher, Request, SlotKVCache, SlotOverflow, VirtualClock)
from distributed_tensorflow_tpu_torch.utils.harness import (
    parse_draft_config)

TARGET = dict(vocab_size=64, hidden=32, layers=2, heads=2, ffn=64,
              max_len=32, dropout_rate=0.0)
DRAFT = dict(TARGET, hidden=16, layers=1, ffn=32)
BLK = 4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NEWS = [6, 3, 8, 2, 5]
ARRIVALS = [0.0, 0.0, 1.0, 4.0, 6.0]


def _init(cfg, key, seed):
    jm = JaxGPT(**cfg)
    x = jnp.asarray(np.random.default_rng(seed).integers(0, 64, (2, 8)),
                    jnp.int32)
    params = jm.init(jax.random.key(key), x, train=False)["params"]
    return jm, params, gpt_state_dict(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def target():
    return _init(TARGET, 0, 0)


@pytest.fixture(scope="module")
def draft():
    """A smaller, independently seeded draft: its proposals disagree with
    the target often, which exercises rejection and rollback."""
    return _init(DRAFT, 7, 1)


def _port_kv(model, slots=2, layout="monolithic", **kw):
    cfg = TARGET if model[0].layers == 2 else DRAFT
    if layout == "paged":
        kw.setdefault("paged_block", BLK)
    return SlotKVCache(GPTLM(**cfg, device="cpu"), model[2], slots,
                       kv_layout=layout, device="cpu", **kw)


def _jax_kv(model, slots=2, layout="monolithic", **kw):
    if layout == "paged":
        kw.setdefault("paged_block", BLK)
    return JaxKV(model[0], model[1], slots=slots, kv_layout=layout, **kw)


def _prompts(n, seed=0, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _cache_bytes(kv):
    return [t.clone() for layer in kv.cache for t in layer.values()]


# ------------------------------------------------------ table-level verify


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_verify_logits_and_argmaxes_match_jax(target, layout, kv_dtype):
    """Three slots (one evicted: a row outside the verify), then verify
    blocks of widths 2-5 at the same lengths: each block's logits equal
    the JAX table's verify forward (``_verify``) and the argmaxes its
    argmaxes; paged, the block tables grow alike."""
    kw = {} if kv_dtype is None else dict(kv_dtype=kv_dtype)
    jkv = _jax_kv(target, 3, layout, **kw)
    tkv = _port_kv(target, 3, layout, **kw)
    for p in _prompts(3, seed=3, lo=5, hi=9):
        assert jkv.insert(p) == tkv.insert(p)
    jkv.evict(1)
    tkv.evict(1)
    rng = np.random.default_rng(4)
    verify = jax.jit(lambda params, cache, block, pos, extra: jkv.dm.apply(
        {"params": params, "cache": cache}, block, train=False,
        positions=pos, mutable=["cache"], **extra))
    for width in (2, 3, 4, 5):
        block = rng.integers(0, 64, (3, width)).astype(np.int32)
        block[:, 0] = jkv.tokens
        if layout == "paged":
            for s in np.flatnonzero(jkv.active):   # what verify_block does
                jkv._ensure_writable(int(s), int(jkv.lengths[s]),
                                     int(jkv.lengths[s]) + width)
            extra = dict(block_tables=jkv._masked_bt(jkv.active))
        else:
            extra = {}
        pos = (jnp.asarray(jkv.lengths)[:, None]
               + jnp.arange(width, dtype=jnp.int32)[None, :])
        want, upd = verify(jkv.params, jkv.cache, jnp.asarray(block), pos,
                           extra)
        jkv.cache = upd["cache"]
        want = np.asarray(want)
        got = tkv.verify_logits(block).numpy()
        live = jkv.active
        np.testing.assert_allclose(got[live], want[live], **LOGIT_TOL)
        np.testing.assert_array_equal(got[live].argmax(-1),
                                      want[live].argmax(-1))
        g = tkv.verify_block(block)
        np.testing.assert_array_equal(g[live], want[live].argmax(-1))
    if layout == "paged":
        np.testing.assert_array_equal(tkv.block_tables_np,
                                      jkv.block_tables_np)


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_verify_commit_then_decode_continues_the_stream(target, layout):
    """Feeding the pending token + the target's own continuation scores
    the next tokens exactly (the JAX table's ``verify_block`` on the same
    block), committing them continues the stream; a block with a junk
    tail commits only its accepted prefix, the rollback touches no table
    byte, and decoding continues right over the rejected positions — as
    the JAX table does after the same calls."""
    jkv, tkv = _jax_kv(target, 2, layout), _port_kv(target, 2, layout)
    ref = _port_kv(target, 2, layout)
    p = _prompts(1, seed=5, lo=5, hi=6)[0]
    for kv in (jkv, tkv, ref):
        slot, first = kv.insert(p)
    stream = [first] + [int(ref.advance()[slot]) for _ in range(9)]
    block = np.zeros((2, 4), np.int32)
    block[slot] = stream[:4]
    g = tkv.verify_block(block)
    np.testing.assert_array_equal(g[slot], stream[1:5])
    np.testing.assert_array_equal(g[slot], jkv.verify_block(block)[slot])
    base = int(tkv.lengths[slot])
    for kv in (tkv, jkv):
        kv.commit_block(slot, 4, int(g[slot, 3]))
    # pending + one correct proposal + two junk ones
    block[slot] = [stream[4], stream[5], (stream[6] + 1) % 64,
                   (stream[7] + 5) % 64]
    g = tkv.verify_block(block)
    assert int(g[slot, 0]) == stream[5]
    np.testing.assert_array_equal(g[slot], jkv.verify_block(block)[slot])
    stale = _cache_bytes(tkv)
    for kv in (tkv, jkv):
        kv.commit_block(slot, 2, int(g[slot, 1]))
    assert int(tkv.lengths[slot]) == base + 6
    assert int(tkv.tokens[slot]) == stream[6]
    for a, b in zip(stale, _cache_bytes(tkv)):
        assert torch.equal(a, b)
    got = [int(tkv.advance()[slot]) for _ in range(3)]
    assert got == stream[7:10]
    assert got == [int(jkv.advance()[slot]) for _ in range(3)]


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_rewind_and_commit_guards(target, layout):
    kv = _port_kv(target, 1, layout)
    slot, _ = kv.insert(_prompts(1, seed=6)[0])
    with pytest.raises(ValueError, match="extend"):
        kv.rewind(slot, int(kv.lengths[slot]) + 1, 0)
    kv.halted[slot] = True
    kv.rewind(slot, int(kv.lengths[slot]) - 1, 3)
    assert int(kv.tokens[slot]) == 3 and not kv.halted[slot]
    with pytest.raises(ValueError, match="n >= 1"):
        kv.commit_block(slot, 0, 0)
    with pytest.raises(SlotOverflow, match="exceeds max_len"):
        kv.commit_block(slot, kv.max_len, 0)
    kv.evict(slot)
    with pytest.raises(RuntimeError, match="not active"):
        kv.rewind(slot, 0, 0)
    with pytest.raises(RuntimeError, match="not active"):
        kv.commit_block(slot, 1, 0)


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_verify_block_guards(target, layout):
    kv = _port_kv(target, 2, layout)
    with pytest.raises(ValueError, match="slots, width"):
        kv.verify_block(np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError, match="greedy"):
        _port_kv(target, 2, layout, greedy=False).verify_block(
            np.zeros((2, 2), np.int32))
    # capacity: a near-full slot refuses an over-wide block
    kv.insert(np.zeros(TARGET["max_len"] - 2, np.int32))
    with pytest.raises(SlotOverflow, match="verify width"):
        kv.verify_block(np.zeros((2, 3), np.int32))
    kv.verify_block(np.zeros((2, 2), np.int32))
    kv.dispatch_multi(1)
    with pytest.raises(RuntimeError, match="in flight"):
        kv.verify_block(np.zeros((2, 2), np.int32))


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_masked_advance_only_moves_masked_slots(target, layout):
    """``advance(only=mask)`` (the draft's catch-up step) advances exactly
    the masked slots; both slots then decode as the JAX table does after
    the same calls."""
    jkv, tkv = _jax_kv(target, 2, layout), _port_kv(target, 2, layout)
    for p in _prompts(2, seed=8):
        assert jkv.insert(p) == tkv.insert(p)
    len1, tok1 = int(tkv.lengths[1]), int(tkv.tokens[1])
    mask = np.array([True, False])
    toks = tkv.advance(only=mask)
    np.testing.assert_array_equal(toks, jkv.advance(only=mask))
    assert (int(tkv.lengths[1]), int(tkv.tokens[1])) == (len1, tok1)
    for _ in range(3):
        np.testing.assert_array_equal(tkv.advance(), jkv.advance())
    np.testing.assert_array_equal(tkv.lengths, jkv.lengths)


# ------------------------------------------------------------- the batcher

_RUNS: dict = {}


def _requests(cls, eos=None):
    return [cls(i, p, NEWS[i], ARRIVALS[i], eos)
            for i, p in enumerate(_prompts(5, seed=4))]


def _spec_runs(target, draft, layout, which, multi_step=None):
    """(JAX speculative summary, port speculative summary, port
    non-speculative summary) on the staggered trace, cached per case."""
    key = (layout, which, multi_step)
    if key not in _RUNS:
        dmodel = target if which == "self" else draft
        kw = dict(draft_k=3, multi_step=multi_step)
        want = JaxBatcher(_jax_kv(target, 2, layout), clock=JaxClock(),
                          draft_kv=_jax_kv(dmodel, 2), **kw).run(
            _requests(JaxRequest))
        tkv = _port_kv(target, 2, layout)
        got = ContinuousBatcher(tkv, clock=VirtualClock(),
                                draft_kv=_port_kv(dmodel, 2), **kw).run(
            _requests(Request))
        assert tkv.free_slots == [0, 1]
        base = ContinuousBatcher(_port_kv(target, 2, layout),
                                 clock=VirtualClock()).run(
            _requests(Request))
        _RUNS[key] = want, got, base
    return _RUNS[key]


SPEC_CASES = [("monolithic", "self", None), ("paged", "self", None),
              ("monolithic", "small", None), ("paged", "small", 4)]


@pytest.mark.parametrize("layout, which, multi_step", SPEC_CASES)
def test_spec_streams_equal_nonspec_and_jax(target, draft, layout, which,
                                            multi_step):
    """Speculative streams are bitwise the non-speculative port
    batcher's and the JAX speculative batcher's, with the same TTFTs, ITLs,
    iteration count and ledger; draft 'self' accepts everything and takes
    fewer iterations than single-step decode."""
    want, got, base = _spec_runs(target, draft, layout, which, multi_step)
    assert got["completed"] == base["completed"] == 5
    for a, b, c in zip(want["results"], got["results"], base["results"]):
        assert a.tokens == b.tokens == c.tokens, a.rid
        assert (a.ttft_s, a.itl_s) == (b.ttft_s, b.itl_s), a.rid
        assert (a.proposed_tokens, a.accepted_tokens) == (
            b.proposed_tokens, b.accepted_tokens)
    assert len({t for r in got["results"] for t in r.tokens}) > 3
    for key in ("decode_iterations", "serve_accept_rate", "speculative",
                "decode_tokens", "tokens_generated"):
        assert got[key] == want[key], key
    assert base["serve_accept_rate"] is None and base["speculative"] is None
    if which == "self":
        assert got["serve_accept_rate"] == 1.0
        assert got["decode_iterations"] < base["decode_iterations"]
    if multi_step is not None:
        assert got["serve_dispatches"] == want["serve_dispatches"]


@pytest.mark.parametrize("layout, which, multi_step", SPEC_CASES)
def test_accept_ledger_is_conserved(target, draft, layout, which,
                                    multi_step):
    """accepted + rejected == proposed, per request and in the ledger;
    tokens per second still count emitted tokens only."""
    _, res, _ = _spec_runs(target, draft, layout, which, multi_step)
    spec = res["speculative"]
    assert spec["proposed_tokens"] > 0 and spec["draft_iterations"] > 0
    assert (spec["accepted_tokens"] + spec["rejected_tokens"]
            == spec["proposed_tokens"])
    assert spec["proposed_tokens"] == sum(
        r.proposed_tokens for r in res["results"])
    assert spec["accepted_tokens"] == sum(
        r.accepted_tokens for r in res["results"])
    assert res["serve_accept_rate"] == pytest.approx(
        spec["accepted_tokens"] / spec["proposed_tokens"])
    if which == "small":
        assert spec["rejected_tokens"] > 0
    assert res["tokens_generated"] == sum(NEWS)
    assert res["serve_tokens_per_sec"] == pytest.approx(
        res["tokens_generated"] / res["elapsed_s"])


@pytest.mark.parametrize("layout, which, multi_step", SPEC_CASES)
def test_spec_itl_per_emitted_token(target, draft, layout, which,
                                    multi_step):
    """A verify round's tokens arrive at one instant: the round's first
    carries the gap, the rest 0, and the gaps sum to the decode time."""
    _, res, _ = _spec_runs(target, draft, layout, which, multi_step)
    for r in res["results"]:
        assert len(r.itl_s) == len(r.tokens) - 1
        assert sum(r.itl_s) == pytest.approx(r.decode_s)
    if which == "self":
        assert any(0.0 in r.itl_s for r in res["results"])


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_spec_decode_respects_eos(target, layout):
    """An EOS inside a verify block ends the stream where single-step
    decode ends it."""
    p = _prompts(1, seed=12)[0]

    def run(draft_kv, eos):
        return ContinuousBatcher(
            _port_kv(target, 1, layout), clock=VirtualClock(),
            draft_kv=draft_kv, draft_k=4).run(
            [Request(0, p, 8, 0.0, eos)])["results"][0].tokens

    stream = run(None, None)
    # the first token past the third that did not come before it
    end = next(j for j in range(3, len(stream))
               if stream[j] not in stream[:j])
    eos = stream[end]
    spec = run(_port_kv(target, 1), eos)
    assert spec == run(None, eos) == stream[:end + 1]


def test_draft_validation(target, draft):
    kv = _port_kv(target, 2)
    with pytest.raises(ValueError, match="draft_k"):
        ContinuousBatcher(kv, draft_kv=_port_kv(target, 2), draft_k=0)
    with pytest.raises(ValueError, match="match the"):
        ContinuousBatcher(kv, draft_kv=_port_kv(target, 4))
    with pytest.raises(ValueError, match="greedy"):
        ContinuousBatcher(kv, draft_kv=_port_kv(target, 2, greedy=False))
    short = SlotKVCache(GPTLM(**dict(DRAFT, max_len=16), device="cpu"),
                        None, 2, device="cpu")
    with pytest.raises(ValueError, match="must cover"):
        ContinuousBatcher(kv, draft_kv=short)
    with pytest.raises(ValueError, match="multi_step"):
        ContinuousBatcher(kv, multi_step=0)


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_spec_failure_cleanup_frees_draft_slots(target, layout):
    """A failure mid-run leaves both tables empty (fused rounds
    abandoned), and they serve the next window."""
    kv, dkv = _port_kv(target, 2, layout), _port_kv(target, 2)
    calls = [0]

    def boom(rid, tok):
        calls[0] += 1
        if calls[0] >= 3:
            raise RuntimeError("sink died")

    reqs = [Request(i, p, 4, 0.0) for i, p in enumerate(_prompts(2, 7))]
    with pytest.raises(RuntimeError, match="sink died"):
        ContinuousBatcher(kv, clock=VirtualClock(), draft_kv=dkv,
                          draft_k=3, multi_step=2).run(reqs, on_token=boom)
    assert kv.free_slots == dkv.free_slots == [0, 1]
    assert kv.pending_multi == dkv.pending_multi == 0
    assert not kv._inflight.any() and not dkv._inflight.any()
    res = ContinuousBatcher(kv, clock=VirtualClock(), draft_kv=dkv,
                            draft_k=3).run(reqs)
    assert res["completed"] == 2
    if layout == "paged":
        assert kv.blocks_in_use == 0


@pytest.mark.parametrize("spec", [
    "self", "layers=1", "hidden=16, layers=1,ffn=32", "kv_heads=1,heads=2",
    "", "vocab=8", "layers", "layers=x", "max_len=16"])
def test_parse_draft_config_matches_jax(spec):
    try:
        want = jax_parse_draft_config(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_draft_config(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_draft_config(spec) == want
