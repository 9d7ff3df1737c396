"""TP decode on the card.  Marked ``cuda``: skipped without an NVIDIA GPU
(the paged kernel has no CPU mode).  On the card, with no JAX installed
there:

    python -m pytest -m cuda tests/test_torch_tp_decode_cuda.py

The card is one GPU, and NCCL takes one rank per device, so the many-rank
math is held on gloo ranks on the CPU (``tests/test_torch_tp_decode.py``).
Here:

* the paged kernel at the serve GPT's per-rank K/V heads (its 8 kv heads
  cut over tp 2, 4 and 8: 4, 2 and 1 heads a rank), and a GQA model's
  (8 heads over 2 kv heads at tp 2: 4 query heads on 1 kv head), on bf16
  and int8 pools, against its plain version: ``rtol=atol=8e-3`` for bf16
  queries (both versions accumulate in f32 and round once to bf16, so
  they may differ by one bf16 rounding), as the paged kernel's own
  ``cuda`` test holds them;
* on a (1, 1) (data, model) NCCL mesh, a partitioned bf16 GPT bound to it
  decodes bitwise its unbound twin: ``generate(mesh=...)``, and the
  batcher's streams over ``SlotKVCache(mesh=...)`` monolithic, paged and
  paged int8 (every collective a copy over a group of one, the
  row-parallel bias in its GEMM, the head's GEMM at the same width), the
  paged tables through the kernel, one launch a layer a decode step, and
  the TP table's rounds eager (``eager_rounds``: no CUDA graph captured).
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import paged_attention as tpa

pytestmark = pytest.mark.cuda

BF16 = dict(rtol=8e-3, atol=8e-3)
LAYERS = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _pools(seed, s, h, kvh, d, blk, mb, int8, device):
    rng = np.random.default_rng(seed)
    n = s * mb + 1

    def t(a, dtype=None):
        return torch.from_numpy(a).to(device, dtype)

    q = t(rng.standard_normal((s, 1, h, d)).astype(np.float32),
          torch.bfloat16)
    ks = vs = None
    if int8:
        k = t(rng.integers(-127, 128, (n, blk, kvh, d)).astype(np.int8))
        v = t(rng.integers(-127, 128, (n, blk, kvh, d)).astype(np.int8))
        ks = t((rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127).astype(
            np.float32))
        vs = t((rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127).astype(
            np.float32))
    else:
        k = t(rng.standard_normal((n, blk, kvh, d)).astype(np.float32),
              torch.bfloat16)
        v = t(rng.standard_normal((n, blk, kvh, d)).astype(np.float32),
              torch.bfloat16)
    bt = t(rng.permutation(n)[:s * mb].reshape(s, mb).astype(np.int32))
    pos = t(rng.integers(0, mb * blk, s).astype(np.int32))
    return q, k, v, bt, pos, ks, vs


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h, kvh", [(4, 4), (2, 2), (1, 1), (4, 1)],
                         ids=["tp2", "tp4", "tp8", "gqa_tp2"])
def test_paged_kernel_at_per_rank_heads(cuda_device, h, kvh, int8):
    """The serve GPT's table (8 slots, head_dim 64, block 8, 18 entries)
    at one rank's heads."""
    q, k, v, bt, pos, ks, vs = _pools(0, 8, h, kvh, 64, 8, 18, int8,
                                      cuda_device)
    before = tpa.paged_attention.launches
    at_kvh = tpa.paged_attention.launches_by_kv_heads.get(kvh, 0)
    out = tpa.paged_attention(q, k, v, bt, pos, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    assert tpa.paged_attention.launches_by_kv_heads[kvh] == at_kvh + 1
    ref = tpa.paged_attention_reference(q, k, v, bt, pos, k_scale=ks,
                                        v_scale=vs)
    torch.testing.assert_close(out.float(), ref.float(), **BF16)


def _gpt(partition_model):
    from distributed_tensorflow_tpu_torch.models.gpt import GPTLM

    return GPTLM(vocab_size=512, hidden=128, layers=LAYERS, heads=4,
                 kv_heads=2, ffn=256, max_len=64, dropout_rate=0.0,
                 dtype=torch.bfloat16, partition_model=partition_model)


def _requests():
    from distributed_tensorflow_tpu_torch.serving import Request

    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, 16).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate(
        [shared, rng.integers(0, 512, 4 + i).astype(np.int32)]),
        max_new_tokens=12) for i in range(6)]


@pytest.fixture
def tp_mesh(cuda_device):
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "model"))
    yield mesh
    mesh.close()


def test_tp_decode_on_one_rank_is_bitwise_the_unbound_model(tp_mesh):
    from distributed_tensorflow_tpu_torch.models.gpt import generate
    from distributed_tensorflow_tpu_torch.serving import (
        ContinuousBatcher, SlotKVCache)
    from distributed_tensorflow_tpu_torch.serving.decode_graph import (
        RoundGraph)

    whole = _gpt(False)
    whole.reset_parameters(torch.Generator().manual_seed(0))
    sd = whole.state_dict()
    prompt = np.random.default_rng(1).integers(0, 512, (4, 8))
    want = generate(whole, None, prompt, 16, greedy=True)
    got = generate(_gpt(True), sd, prompt, 16, greedy=True, mesh=tp_mesh)
    assert torch.equal(got, want)
    for kw in (dict(), dict(kv_layout="paged"),
               dict(kv_layout="paged", kv_dtype="int8")):
        pool = dict(prefix_cache_blocks=16, prefix_block=8, **kw)
        base = ContinuousBatcher(SlotKVCache(whole, None, 4, **pool),
                                 prefill_chunk=8, multi_step=4).run(
                                     _requests())
        kv = SlotKVCache(_gpt(True), sd, 4, mesh=tp_mesh, **pool)
        assert kv.eager_rounds and kv.model.tp_mesh is tp_mesh
        before = tpa.paged_attention.launches
        captures = RoundGraph.captures
        tp = ContinuousBatcher(kv, prefill_chunk=8, multi_step=4).run(
            _requests())
        torch.cuda.synchronize()
        assert RoundGraph.captures == captures
        assert ([r.tokens for r in tp["results"]]
                == [r.tokens for r in base["results"]]), kw
        launches = tpa.paged_attention.launches - before
        if kw:
            # every forward but the prefill chunks is a round
            rounds = tp["serve_dispatches"] - tp["prefill_chunks"]
            assert launches == LAYERS * 4 * rounds > 0, (launches, rounds)
        else:
            assert launches == 0
