"""BERT-tiny (BASELINE config 5) and remat on the card.  Marked ``cuda``:
skipped without an NVIDIA GPU (the flash kernels and CUDA graphs have no
CPU mode).  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_bert_cuda.py

* BERT ``flash`` against BERT ``dense`` with the same weights on a seeded
  32 × 128 batch whose rows have padded tails of random length, plus one
  row that is all padding: at f32 every flash launch is on the 3xTF32
  tensor-core kernels (``tc32``, ``csrc/flash_attention_f32_sm90.cu``), at
  bf16 on the 16-bit tensor-core kernels (``tc``).  Logits: f32 within ``rtol=1e-4, atol=1e-4`` (the
  kernels' online softmax sums in another order than one dense pass, as
  ``tests/test_flash_attention.py`` allows, through two layers, a pooler
  and LayerNorms); bf16 within ``atol=5e-2`` (the dense path rounds
  scores, probabilities and P·V to bf16 where the kernels keep f32: a few
  bf16 roundings, 2^-8 each, of logits of order 1).  The all-padding row
  of the attention itself is the mean of V over its 128 keys on both
  routes.
* Remat against no remat, dropout 0.1 on: eager steps, and a drained chunk
  replayed as a CUDA graph (``SyncEngine.many_step``: chunk 1 eager,
  chunk 2 captured and replayed, chunk 3 replayed), give the same losses
  and parameters bit for bit: the recompute draws the masks its forward
  drew (``remat`` saves the engine generator's state before each block
  and sets it again for the recompute), also inside the capture.  The
  flash forward launches per step double under remat; the backward
  launches do not.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.engines import SyncEngine
from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda

F32_LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_LOGITS = dict(rtol=0.0, atol=5e-2)
COUNTS = ("fwd", "dq", "dkv", "fwd_tc", "dq_tc", "dkv_tc")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels and CUDA "
                    "graphs have no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _counts():
    return {n: getattr(tfa.flash_attention, f"{n}_launches") for n in COUNTS}


def padded_batch(seed=0, b=32, l=128, vocab=1024):
    """Token ids with padded tails of random length and an all-padding
    last row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, l))
    for r in range(b - 1):
        ids[r, rng.integers(1, l + 1):] = 0
    ids[-1] = 0
    return torch.from_numpy(ids).cuda()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_flash_matches_dense_on_padded_rows(cuda_device, dtype):
    ids = padded_batch()
    logits = {}
    for impl in ("dense", "flash"):
        model = create_model("bert_tiny", num_classes=2, vocab_size=1024,
                             attention_impl=impl, dtype=dtype)
        model.reset_parameters(torch.Generator().manual_seed(0))
        before = _counts()
        with torch.no_grad():
            logits[impl] = model(ids)
        torch.cuda.synchronize()
        moved = {n: _counts()[n] - before[n] for n in COUNTS}
        tc = int(dtype == "bfloat16")
        want = 2 if impl == "flash" else 0        # one per layer
        assert moved == {"fwd": want, "dq": 0, "dkv": 0,
                         "fwd_tc": want * tc, "dq_tc": 0, "dkv_tc": 0}
    tol = F32_LOGITS if dtype == "float32" else BF16_LOGITS
    torch.testing.assert_close(logits["flash"], logits["dense"], **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_with_no_valid_key_gets_the_mean_of_v(cuda_device, dtype):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(2, 128, 2, 64, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    mask = torch.ones(2, 128, device="cuda")
    mask[1] = 0
    out = tfa.flash_attention(q, k, v, kv_mask=mask)
    mean_v = v[1].float().mean(0, keepdim=True).expand(128, -1, -1)
    # bf16: the tc kernel rounds each P and the output to bf16
    tol = (dict(rtol=1e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2.0 ** -7, atol=2.0 ** -8))
    torch.testing.assert_close(out[1].float(), mean_v, **tol)


def _train(kind, remat, chunks=3, k=4):
    """``chunks`` drained chunks of ``k`` steps (the first eager, the second
    captured and replayed, the third replayed), dropout 0.1."""
    if kind == "gpt":
        model = create_model("gpt", num_classes=64, hidden=64, layers=2,
                             heads=2, ffn=128, max_len=64, dropout_rate=0.1,
                             attention_impl="flash", dtype="bfloat16",
                             remat=remat)
        eng = SyncEngine(model, precision="bf16-f32master")
        rng = np.random.default_rng(0)
        x = rng.integers(0, 64, (chunks * k * 8, 64))
        y = rng.integers(0, 64, (chunks * k * 8, 64))
    else:
        model = create_model("bert_tiny", num_classes=2, vocab_size=1024,
                             attention_impl="flash", remat=remat)
        eng = SyncEngine(model)
        x = padded_batch(2, b=chunks * k * 8).cpu().numpy()
        y = np.random.default_rng(3).integers(0, 2, (chunks * k * 8,))
    state = eng.init_state(torch.Generator().manual_seed(0))
    losses = []
    graphs = _ChunkGraph.captures, _ChunkGraph.replays
    before = _counts()
    for c in range(chunks):
        xs, ys = zip(*(eng.shard_batch(x[8 * i:8 * i + 8], y[8 * i:8 * i + 8])
                       for i in range(c * k, (c + 1) * k)))
        state, m = eng.many_step(state, list(xs), list(ys))
        losses.append(m["loss"].cpu())
    torch.cuda.synchronize()
    moved = {n: _counts()[n] - before[n] for n in COUNTS}
    graphs = (_ChunkGraph.captures - graphs[0],
              _ChunkGraph.replays - graphs[1])
    assert graphs == (1, chunks - 1), graphs
    return torch.cat(losses), [p.detach().cpu()
                               for p in state.model.parameters()], moved


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_remat_equals_no_remat_eager_and_in_a_replayed_chunk(cuda_device,
                                                             kind):
    runs = {remat: _train(kind, remat) for remat in (False, True)}
    (l0, p0, c0), (l1, p1, c1) = runs[False], runs[True]
    assert torch.isfinite(l0).all()
    assert torch.equal(l0, l1), (l0, l1)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    steps = 12 * 2                                  # steps x layers
    assert c0["fwd"] == steps and c1["fwd"] == 2 * steps, (c0, c1)
    assert c0["dq"] == c1["dq"] == c0["dkv"] == c1["dkv"] == steps
