"""A speculative verify row is bitwise the decode step at the same prefix.

``SlotKVCache.verify_logits`` scores a ``(slots, width)`` block in one
forward whose GEMMs and attention reads run one query column at a time
(``GPTLM.forward(by_column=True)``), at the shape of a one-token decode
step.  These tests hold every verify column, on both KV layouts, to the
logits that ``decode_logits`` gives after the block's earlier tokens were
fed one decode step at a time: bitwise, with no tolerance.  The verify is
the speculative batcher's, so its streams then equal the plain batcher's
(``tests/test_torch_spec_decode.py`` holds those against the JAX package).

The CPU cases run a small f32 GPT.  The ``cuda`` case runs a bf16 GPT at
draft_k = 4 on the card, where a GEMM over ``slots x width`` rows would
take another cuBLAS kernel than the decode step's ``slots`` rows (and the
paged kernel another split of its sums at ``l_q = 5``); it imports no JAX:

    python -m pytest -m cuda tests/test_torch_verify_columns.py
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.models.gpt import GPTLM
from distributed_tensorflow_tpu_torch.serving import SlotKVCache

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SMALL = dict(vocab_size=64, hidden=32, layers=2, heads=2, ffn=64,
             max_len=48, dropout_rate=0.0)
CARD = dict(vocab_size=2048, hidden=256, layers=2, heads=4, ffn=1024,
            max_len=96, dropout_rate=0.0)
DRAFT_K = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged kernel and cuBLAS's "
                    "row-count-dependent GEMMs run only there")
    return "cuda"


def _model(cfg, device, dtype):
    model = GPTLM(**cfg, dtype=dtype, device=device)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.eval()


def _tables(model, layout, slots, prompts, kv_dtype):
    kw = dict(kv_layout=layout, kv_dtype=kv_dtype,
              device=model.token_embed.weight.device)
    if layout == "paged":
        kw["paged_block"] = 4
    tables = [SlotKVCache(model, None, slots, **kw) for _ in range(2)]
    for table in tables:
        for p in prompts:
            table.insert(p)
    return tables


def _check_columns(model, layout, slots, prompts, kv_dtype=None, seed=0):
    """Verify a random draft block on one table; feed the same block
    token by token through decode steps of a twin; every active row's
    columns must be bitwise equal.  Returns the columns compared."""
    vt, dt = _tables(model, layout, slots, prompts, kv_dtype)
    rng = np.random.default_rng(seed)
    vocab = model.vocab_size
    block = rng.integers(0, vocab, (slots, DRAFT_K + 1)).astype(np.int32)
    block[:, 0] = vt.tokens
    got = vt.verify_logits(block)
    assert got.shape == (slots, DRAFT_K + 1, vocab)
    active = np.flatnonzero(dt.active)
    assert 0 < len(active) < slots        # a row outside the verify too
    for j in range(DRAFT_K + 1):
        want = dt.decode_logits()
        for s in active:
            assert torch.equal(got[s, j], want[s]), (layout, kv_dtype, s, j)
        if j < DRAFT_K:
            dt.advance()
            dt.tokens[active] = block[active, j + 1]
    return len(active) * (DRAFT_K + 1)


def _prompts(n, vocab, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(
        np.int32) for _ in range(n)]


@pytest.mark.parametrize("layout", ["monolithic", "paged"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_verify_columns_are_bitwise_decode_steps_cpu(layout, kv_dtype):
    model = _model(SMALL, "cpu", torch.float32)
    n = _check_columns(model, layout, 4, _prompts(3, 64, 1, 3, 12),
                       kv_dtype)
    assert n == 3 * (DRAFT_K + 1)


def test_verify_by_column_is_decode_mode_only():
    model = _model(SMALL, "cpu", torch.float32)
    with pytest.raises(ValueError, match="by_column"):
        model(torch.zeros(1, 4, dtype=torch.long), by_column=True)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["monolithic", "paged"])
def test_verify_columns_are_bitwise_decode_steps_on_the_card(cuda_device,
                                                             layout):
    model = _model(CARD, cuda_device, torch.bfloat16)
    prompts = _prompts(7, CARD["vocab_size"], 2, 8, 60)
    total = 0
    for seed in range(3):
        total += _check_columns(model, layout, 8, prompts, seed=seed)
    torch.cuda.synchronize()
    assert total == 3 * 7 * (DRAFT_K + 1)
