"""The Hopper kernel of ``ops/paged_attention.py`` held to its plain PyTorch
version on the card.  Marked ``cuda``: skipped without an NVIDIA GPU (the
kernel has no CPU mode).  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_paged_attention_cuda.py

The kernel splits the key axis (flash-decoding) and merges the splits'
partials; each case runs at forced split counts 1, 2 and the table width
(one entry per split, most splits empty), beside the split count
``_splits`` picks, and a long-context case (4096-token tables).

Tolerances: f32 ``rtol=1e-5, atol=2e-5`` (the JAX package's kernel-vs-
oracle bound); bf16 ``rtol=atol=8e-3`` — both versions accumulate in f32
and round once to bf16, so they may differ by one bf16 rounding (2^-8).
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import paged_attention as tpa

F32 = dict(rtol=1e-5, atol=2e-5)
BF16 = dict(rtol=8e-3, atol=8e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _inputs(seed, s, l_q, h, kvh, d, blk, mb, dtype, int8, device,
            pos_lo=0):
    rng = np.random.default_rng(seed)
    n = s * mb + 1
    t = lambda a, dt=None: torch.from_numpy(a).to(device, dt)  # noqa: E731
    q = t(rng.standard_normal((s, l_q, h, d)).astype(np.float32), dtype)
    ks = vs = None
    if int8:
        k = t(rng.integers(-127, 128, (n, blk, kvh, d)).astype(np.int8))
        v = t(rng.integers(-127, 128, (n, blk, kvh, d)).astype(np.int8))
        ks = t((rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127).astype(
            np.float32))
        vs = t((rng.uniform(0.5, 1.5, (n, blk, kvh)) / 127).astype(
            np.float32))
    else:
        k = t(rng.standard_normal((n, blk, kvh, d)).astype(np.float32), dtype)
        v = t(rng.standard_normal((n, blk, kvh, d)).astype(np.float32), dtype)
    bt = t(rng.permutation(n)[:s * mb].reshape(s, mb).astype(np.int32))
    pos = t(rng.integers(pos_lo, mb * blk - l_q + 1, s).astype(np.int32))
    return q, k, v, bt, pos, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 2, "max"])
@pytest.mark.parametrize("s, l_q, h, kvh, d, blk, mb, dtype, int8, tol", [
    (8, 1, 8, 8, 64, 8, 18, torch.bfloat16, False, BF16),   # serving decode
    (4, 1, 4, 2, 8, 4, 4, torch.float32, False, F32),       # GQA
    (4, 3, 4, 2, 8, 4, 4, torch.float32, False, F32),       # verify width
    (4, 1, 4, 2, 8, 4, 4, torch.float32, True, F32),        # int8 pools
    (3, 5, 32, 2, 128, 8, 6, torch.float32, False, F32),    # 93 KB smem
    (2, 1, 2, 2, 256, 16, 3, torch.float32, False, F32),    # head_dim 256
])
def test_cuda_kernel_matches_plain_version(cuda_device, s, l_q, h, kvh, d,
                                           blk, mb, dtype, int8, tol,
                                           splits):
    q, k, v, bt, pos, ks, vs = _inputs(0, s, l_q, h, kvh, d, blk, mb, dtype,
                                       int8, cuda_device)
    before = tpa.paged_attention.launches
    if splits is None:                      # the wrapper's own choice
        out = tpa.paged_attention(q, k, v, bt, pos, k_scale=ks, v_scale=vs)
    else:
        out = tpa._paged_cuda(q, k, v, bt, pos, k_scale=ks, v_scale=vs,
                              splits=mb if splits == "max" else splits)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    ref = tpa.paged_attention_reference(q, k, v, bt, pos, k_scale=ks,
                                        v_scale=vs)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 4, 32])
def test_long_context_matches_plain_version(cuda_device, splits):
    """8 slots x 8 kv heads at 4096-token tables (block 16, 256 entries),
    positions in [3584, 4095], bf16: a split's range is longer than one
    chunk, so its blocks stream through two shared-memory stages."""
    q, k, v, bt, pos, _, _ = _inputs(1, 8, 1, 8, 8, 64, 16, 256,
                                     torch.bfloat16, False, cuda_device,
                                     pos_lo=3584)
    out = tpa._paged_cuda(q, k, v, bt, pos, splits=splits)
    torch.cuda.synchronize()
    ref = tpa.paged_attention_reference(q, k, v, bt, pos)
    torch.testing.assert_close(out.float(), ref.float(), **BF16)
