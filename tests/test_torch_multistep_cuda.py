"""The fused decode round as a CUDA graph, and the paged kernel at the
verify width, on the card.  Marked ``cuda``: skipped without an NVIDIA GPU
(CUDA graphs and the Hopper kernel have no CPU mode).  On the card, with
no JAX installed there:

    python -m pytest -m cuda tests/test_torch_multistep_cuda.py

* Rounds of ``advance_multi(4)`` — the first eager on a side stream, the
  second captured and replayed, the third replayed — equal 12 single
  steps of a twin table bitwise: greedy and temperature-sampled (the
  graph advances the registered generator's Philox offset by what its
  steps draw), monolithic and paged, f32 and int8 storage.
* A replayed dispatch makes no host sync
  (``torch.cuda.set_sync_debug_mode("error")`` around it).
* After replays ``paged_attention.launches`` counts one launch per layer
  per step; a graph refuses a table it was not captured for.
* The paged kernel at ``l_q = 5`` (a ``draft_k = 4`` verify) on bf16 and
  int8 pools at the serving shape (8 slots, 8 heads and kv heads, head
  dim 64, 8-token blocks, 18 table entries) against its plain version,
  bf16 tolerance ``rtol=atol=8e-3`` (both accumulate in f32 and round
  once to bf16); a paged table's verify launches it once per query
  column at ``l_q = 1``, as a decode step does (the verify's columns are
  bitwise decode steps).
* ``sample_tokens`` draws what ``torch.multinomial`` draws on the card.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.models.gpt import GPTLM, sample_tokens
from distributed_tensorflow_tpu_torch.ops import paged_attention as tpa
from distributed_tensorflow_tpu_torch.serving import SlotKVCache
from distributed_tensorflow_tpu_torch.serving.decode_graph import RoundGraph

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=64, hidden=64, layers=2, heads=4, kv_heads=2,
             ffn=128, max_len=64, dropout_rate=0.0)
BF16 = dict(rtol=8e-3, atol=8e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the Hopper "
                    "kernel have no CPU mode")
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = flag


def _model():
    m = GPTLM(**SMALL, device="cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.token_embed.weight.mul_(6.0)    # streams that vary
    return m


def _table(layout, seed=None, **kw):
    kw = dict(kw, kv_layout=layout)
    if layout == "paged":
        kw["paged_block"] = 8
    if seed is not None:
        kw.update(greedy=False, temperature=1.5,
                  generator=torch.Generator("cuda").manual_seed(seed))
    kv = SlotKVCache(_model(), None, 4, device="cuda", **kw)
    rng = np.random.default_rng(2)
    for n in (5, 9, 3, 12):
        kv.insert(rng.integers(0, 64, n).astype(np.int32))
    return kv


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_replayed_rounds_equal_single_steps(cuda_device, layout, sampled,
                                            kv_dtype):
    seed = 5 if sampled else None
    single = _table(layout, seed, kv_dtype=kv_dtype)
    fused = _table(layout, seed, kv_dtype=kv_dtype)
    want = np.stack([single.advance() for _ in range(12)])
    caps, reps = RoundGraph.captures, RoundGraph.replays
    got = np.concatenate([fused.advance_multi(4)[0] for _ in range(3)])
    assert (RoundGraph.captures - caps, RoundGraph.replays - reps) == (1, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fused.lengths, single.lengths)
    for a, b in zip(_logical_kv(fused), _logical_kv(single)):
        assert torch.equal(a, b)


def _logical_kv(kv):
    """Each slot's stored K/V (and scales) at its valid positions, in
    position order: the paged table's physical block ids depend on when
    blocks were allocated (a fused round covers k steps ahead)."""
    out = []
    for layer in kv.cache:
        for t in layer.values():
            for s in range(kv.slots):
                n = int(kv.lengths[s])
                if kv.kv_layout == "paged":
                    ids = torch.from_numpy(kv.block_tables_np[s]).long()
                    rows = t[ids.to(t.device)].flatten(0, 1)
                else:
                    rows = t[s]
                out.append(rows[:n])
    return out


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_replay_makes_no_host_sync_and_counts_launches(cuda_device, layout):
    kv = _table(layout)
    kv.advance_multi(4)                 # eager
    kv.advance_multi(4)                 # captured, replayed
    graph = kv._graphs[4]
    before = tpa.paged_attention.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kv.dispatch_multi(4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    toks, acts = kv.drain_multi()
    assert acts.all() and toks.shape == (4, 4)
    per_step = SMALL["layers"] if layout == "paged" else 0
    assert tpa.paged_attention.launches == before + 4 * per_step
    other = _table(layout)
    with pytest.raises(ValueError, match="another slot table"):
        graph.replay(other)


def _pools(seed, int8):
    """The serving shape's pools and a verify block's queries: 8 slots,
    5 query rows, 8 heads and kv heads, head dim 64, 8-token blocks, 18
    table entries."""
    s, l_q, h, d, blk, mb = 8, 5, 8, 64, 8, 18
    rng = np.random.default_rng(seed)
    n = s * mb + 1
    t = lambda a, dt=None: torch.from_numpy(a).to("cuda", dt)  # noqa: E731
    q = t(rng.standard_normal((s, l_q, h, d)).astype(np.float32),
          torch.bfloat16)
    ks = vs = None
    if int8:
        k = t(rng.integers(-127, 128, (n, blk, h, d)).astype(np.int8))
        v = t(rng.integers(-127, 128, (n, blk, h, d)).astype(np.int8))
        ks = t((rng.uniform(0.5, 1.5, (n, blk, h)) / 127).astype(
            np.float32))
        vs = t((rng.uniform(0.5, 1.5, (n, blk, h)) / 127).astype(
            np.float32))
    else:
        k = t(rng.standard_normal((n, blk, h, d)).astype(np.float32),
              torch.bfloat16)
        v = t(rng.standard_normal((n, blk, h, d)).astype(np.float32),
              torch.bfloat16)
    bt = t(rng.permutation(n)[:s * mb].reshape(s, mb).astype(np.int32))
    pos = t(rng.integers(0, mb * blk - l_q + 1, s).astype(np.int32))
    return q, k, v, bt, pos, ks, vs


@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_at_verify_width(cuda_device, int8):
    q, k, v, bt, pos, ks, vs = _pools(11, int8)
    before = tpa.paged_attention.int8_launches
    out = tpa.paged_attention(q, k, v, bt, pos, k_scale=ks, v_scale=vs)
    ref = tpa.paged_attention_reference(q, k, v, bt, pos, k_scale=ks,
                                        v_scale=vs)
    torch.cuda.synchronize()
    assert tpa.paged_attention.int8_launches == before + int8
    torch.testing.assert_close(out.float(), ref.float(), **BF16)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_verify_launches_the_kernel(cuda_device, kv_dtype):
    """A paged table's verify of width 5 launches the kernel once per
    layer and query column, all at ``l_q = 1`` (the shape of a decode
    step), and its logits match the gather read's."""
    def table(fused):
        kv = SlotKVCache(_model(), None, 4,
                         kv_layout="paged", paged_block=8, device="cuda",
                         kv_dtype=kv_dtype, paged_fused=fused)
        rng = np.random.default_rng(3)
        for n in (5, 9, 3, 12):
            kv.insert(rng.integers(0, 64, n).astype(np.int32))
        return kv

    fused, gather = table(True), table(False)
    block = np.random.default_rng(4).integers(0, 64, (4, 5)).astype(
        np.int32)
    block[:, 0] = fused.tokens
    before = tpa.paged_attention.launches
    wide = tpa.paged_attention.verify_launches
    got = fused.verify_logits(block)
    assert tpa.paged_attention.launches == before + 5 * SMALL["layers"]
    assert tpa.paged_attention.verify_launches == wide
    want = gather.verify_logits(block)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_sample_tokens_is_multinomials_draw_on_the_card(cuda_device):
    g1 = torch.Generator("cuda").manual_seed(3)
    g2 = torch.Generator("cuda").manual_seed(3)
    for i in range(4):
        logits = torch.randn(8, 1024, device="cuda",
                             generator=torch.Generator("cuda").manual_seed(i))
        probs = torch.softmax(logits * 2, dim=-1)
        want = torch.multinomial(probs, 1, generator=g1)[:, 0]
        got = sample_tokens(logits * 2, greedy=False, generator=g2)
        assert torch.equal(got, want), i
