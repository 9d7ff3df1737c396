"""Sequence parallelism on the card.  Marked ``cuda``: skipped without an
NVIDIA GPU (the flash kernels have no CPU mode).  On the card, with no JAX
installed there:

    python -m pytest -m cuda tests/test_torch_seq_parallel_cuda.py

The card is one GPU, and NCCL takes one rank per device, so the ring's
many-rank math is held on gloo ranks on the CPU
(``tests/test_torch_ring_attention.py``, ``tests/test_torch_seq_parallel.py``).
Here:

* the virtual-rank ring: ``ring_attention.virtual_ring`` runs the ring's
  own per-block functions (``ring_fwd_block``/``ring_bwd_block``, with
  ``_merge_blocks``) for every (rank, step) of n ranks in one process, and
  the result is held to ``flash_fwd_block``/``flash_bwd_block`` over the
  whole sequence: causal at n = 4 (10 forward, dQ and dK/dV launches: 4
  diagonal, 6 past, 6 future pairings skipped) and under a key mask at
  n = 2, f32 within
  ``rtol=1e-5, atol=2e-5`` (out, lse) and ``rtol=1e-4, atol=1e-4`` (the
  gradients: tiles and online-softmax merges sum in another order, as
  ``chip_smoke.py``'s block check allows);
* ``SeqParallelEngine`` on a (1, 1) NCCL mesh: ``ring_flash`` and
  ``ulysses_flash`` GPT training against ``SyncEngine`` with the flash
  attention from the same weights and batches, 2 forward, dQ and dK/dV
  launches a step.  At one rank the all-to-all is a copy, so
  ``ulysses_flash``'s f32 losses are bitwise the flash GPT's; the ring's
  merge multiplies the block's output by exactly 1, so its first loss
  (the forward alone) is held within ``rtol=1e-6`` and the rest within
  ``1e-4``.

``ring_case`` is imported by the CPU test of the same composition against
the JAX package.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa
from distributed_tensorflow_tpu_torch.parallel import ring_attention as ra

pytestmark = pytest.mark.cuda

OUT_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def ring_case(seed, *, b, l, h, d, masked, device, dtype=torch.float32):
    """Seeded q, k, v, dO (B, L, H, D) and a (B, L) key mask (every row
    keeps at least its first key when ``masked``)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.standard_normal((b, l, h, d)),
                                dtype=dtype, device=device)
                   for _ in range(4))
    mask = np.ones((b, l), np.float32)
    if masked:
        for r in range(b):
            mask[r, rng.integers(1, l + 1):] = 0.0
    return q, k, v, do, torch.tensor(mask, device=device)


def whole_sequence(q, k, v, mask, do, *, causal, scale):
    """``flash_fwd_block``/``flash_bwd_block`` over the whole sequence."""
    out, lse = tfa.flash_fwd_block(q, k, v, mask, scale=scale, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    grads = tfa.flash_bwd_block(q, k, v, mask, do, lse, delta.contiguous(),
                                scale=scale, causal=causal)
    return (out, lse, *grads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU "
                    "mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _launches():
    f = tfa.flash_attention
    return (f.fwd_launches, f.dq_launches, f.dkv_launches)


@pytest.mark.parametrize("n,causal,b,l,h", [(4, True, 2, 512, 4),
                                            (2, False, 4, 128, 2)])
def test_virtual_ring_equals_whole_sequence_kernels(cuda_device, n, causal,
                                                    b, l, h):
    q, k, v, do, mask = ring_case(3, b=b, l=l, h=h, d=64,
                                  masked=not causal, device=cuda_device)
    scale = 64 ** -0.5
    before = _launches()
    got = ra.virtual_ring(q, k, v, mask, do, n, causal=causal,
                          scale=scale)
    launched = [a - z for a, z in zip(_launches(), before)]
    want = whole_sequence(q, k, v, mask, do, causal=causal, scale=scale)
    torch.cuda.synchronize()
    pairings = n * (n + 1) // 2 if causal else n * n
    assert launched == [pairings] * 3
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, **OUT_TOL)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, **GRAD_TOL)


def _gpt(impl):
    from distributed_tensorflow_tpu_torch.models import create_model

    return create_model("gpt", num_classes=512, hidden=128, layers=2,
                        heads=2, ffn=256, max_len=256, dropout_rate=0.0,
                        attention_impl=impl)


@pytest.mark.parametrize("impl", ["ring_flash", "ulysses_flash"])
def test_one_rank_engine_equals_flash_sync_engine(cuda_device, impl):
    """Both engines draw the same weights from one seed (the parameters do
    not depend on ``attention_impl``).  ``ulysses_flash`` runs the flash
    GPT's own kernels, bitwise; ``ring_flash``'s forward is bitwise too (a
    merge with weight 1), its backward the same f32 kernels with a key
    mask of ones, so its losses are held to ``rtol=1e-6`` on the first
    step (the forward) and ``1e-4`` after."""
    from distributed_tensorflow_tpu_torch.engines import (
        SeqParallelEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    tok = np.random.default_rng(0).integers(0, 512, (4, 4, 257))
    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "seq"))
    try:
        losses = {}
        for name in ("flash", impl):
            model = _gpt(name)
            # one Adam for both (SyncEngine's default is capturable)
            opt = lambda p: torch.optim.Adam(p, lr=1e-3)  # noqa: E731
            eng = (SyncEngine(model, mesh=mesh, optimizer=opt)
                   if name == "flash"
                   else SeqParallelEngine(model, mesh=mesh, optimizer=opt))
            state = eng.init_state(torch.Generator().manual_seed(0))
            before = _launches()
            got = []
            for x in tok:
                state, m = eng.step(state, *eng.shard_batch(x[:, :-1],
                                                            x[:, 1:]))
                got.append(float(m["loss"]))
            launched = [a - z for a, z in zip(_launches(), before)]
            assert launched == [2 * len(tok)] * 3, launched
            losses[name] = got
        if impl == "ulysses_flash":
            assert losses[impl] == losses["flash"], losses
        else:
            np.testing.assert_allclose(losses[impl][0], losses["flash"][0],
                                       rtol=1e-6)
            np.testing.assert_allclose(losses[impl], losses["flash"],
                                       rtol=1e-4)
    finally:
        mesh.close()
