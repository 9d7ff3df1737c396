"""The Hopper kernels of ``ops/flash_attention.py`` (forward, dQ, dK/dV)
held to their plain PyTorch versions on the card.  Marked ``cuda``:
skipped without an NVIDIA GPU (the kernels have no CPU mode).  On the
card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_flash_attention_cuda.py

Tolerances: f32 outputs and lse ``rtol=1e-5, atol=2e-5``, f32 gradients
``rtol=atol=1e-4`` (the bounds of ``tests/test_flash_attention.py``:
online-softmax and tile-order reassociation against one dense pass); bf16
outputs ``rtol=atol=8e-3`` — both versions compute in f32 and round once
to bf16, so they may differ by one bf16 rounding (2^-8).
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

F32 = dict(rtol=1e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=8e-3, atol=8e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _inputs(seed, b, lq, lk, h, d, dtype, masked, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device, dtype)  # noqa: E731
    q = t(rng.standard_normal((b, lq, h, d)).astype(np.float32))
    k = t(rng.standard_normal((b, lk, h, d)).astype(np.float32))
    v = t(rng.standard_normal((b, lk, h, d)).astype(np.float32))
    do = t(rng.standard_normal((b, lq, h, d)).astype(np.float32))
    mask = None
    if masked:
        m = (rng.uniform(size=(b, lk)) > 0.3).astype(np.float32)
        m[:, 0] = 1.0
        mask = torch.from_numpy(m).to(device)
    return q, k, v, do, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b, lq, lk, h, d, causal, masked", [
    (2, 200, 200, 2, 64, True, False),      # ragged tiles, causal
    (2, 96, 160, 2, 32, False, True),       # cross lengths, key mask
    (1, 130, 130, 2, 128, True, True),      # head_dim tier 128
    (1, 70, 70, 1, 256, False, False),      # head_dim tier 256
    (2, 64, 64, 2, 8, True, False),         # small head_dim
])
def test_kernels_match_plain_versions_f32(cuda_device, b, lq, lk, h, d,
                                          causal, masked):
    q, k, v, do, mask = _inputs(0, b, lq, lk, h, d, torch.float32, masked,
                                cuda_device)
    scale = d ** -0.5
    before = tfa.flash_attention.fwd_launches
    out, lse = tfa._fwd_cuda(q, k, v, mask, scale, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention.fwd_launches == before + 1
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, mask, scale, causal)
    torch.testing.assert_close(out, ref_out, **F32)
    torch.testing.assert_close(lse, ref_lse, **F32)
    delta = (do * ref_out).sum(-1).transpose(1, 2).contiguous()
    got = tfa._bwd_cuda(q, k, v, mask, do, ref_lse.contiguous(), delta,
                        scale, causal)
    torch.cuda.synchronize()
    want = tfa._bwd_reference(q, k, v, mask, do, ref_lse, delta, scale,
                              causal)
    for g, w, name in zip(got, want, "qkv"):
        torch.testing.assert_close(g, w, msg=f"d{name}", **GRAD)


@pytest.mark.cuda
def test_bf16_autograd_matches_plain_version(cuda_device):
    q, k, v, do, _ = _inputs(1, 2, 256, 256, 4, 64, torch.bfloat16, False,
                             cuda_device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True)
    out.backward(do)
    ref_out, _ = tfa._fwd_reference(q, k, v, None, 64 ** -0.5, True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref_out.float(), **BF16)
    assert all(x.grad.dtype == torch.bfloat16 for x in leaves)


@pytest.mark.cuda
def test_row_with_no_valid_key_and_block_primitives(cuda_device):
    q, k, v, do, _ = _inputs(2, 2, 48, 48, 2, 16, torch.float32, False,
                             cuda_device)
    mask = torch.ones(2, 48, device=cuda_device)
    mask[1] = 0.0
    out = tfa.flash_attention(q, k, v, kv_mask=mask)
    torch.testing.assert_close(
        out[1], v[1].mean(0, keepdim=True).expand_as(out[1]), **F32)
    # two-block split: block 0 of the keys with the rows' GLOBAL lse/delta
    ref_out, lse = tfa._fwd_reference(q, k, v, None, 0.25, False)
    delta = (do * ref_out).sum(-1).transpose(1, 2).contiguous()
    half = torch.ones(2, 24, device=cuda_device)
    b_out, b_lse = tfa.flash_fwd_block(q, k[:, :24], v[:, :24], half,
                                       scale=0.25)
    w_out, w_lse = tfa._fwd_reference(q, k[:, :24], v[:, :24], half, 0.25,
                                      False)
    torch.testing.assert_close(b_out, w_out, **F32)
    torch.testing.assert_close(b_lse, w_lse, **F32)
    got = tfa.flash_bwd_block(q, k[:, :24], v[:, :24], half, do, lse, delta,
                              scale=0.25)
    want = tfa._bwd_reference(q, k[:, :24], v[:, :24], half, do, lse, delta,
                              0.25, False)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **GRAD)
