"""The Hopper kernels of ``ops/flash_attention.py`` (forward, dQ, dK/dV)
held to their plain PyTorch versions on the card.  Marked ``cuda``:
skipped without an NVIDIA GPU (the kernels have no CPU mode).  On the
card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_flash_attention_cuda.py

bf16 inputs with a head dim that is a multiple of 16 up to 128 take the
tensor-core route (``csrc/flash_attention_sm90.cu``: forward, dQ and
dK/dV); f32 dQ and dK/dV at those head dims the 3xTF32 tensor-core route
(``tc32``, ``csrc/flash_attention_f32_sm90.cu``), held to the plain
backward at the f32 gradient tolerance and bitwise to itself run again;
the f32 forward and other head dims take the SIMT route
(``csrc/flash_attention.cu``).

Tolerances: f32 outputs and lse ``rtol=1e-5, atol=2e-5``, f32 gradients
``rtol=atol=1e-4`` (the bounds of ``tests/test_flash_attention.py``:
online-softmax and tile-order reassociation against one dense pass).  The
tensor-core kernels round each P (and dS) to bf16 before
their products and the result to bf16 again: two bf16 roundings.  Each
rounding of a term moves an output by at most 2^-9 (bf16's unit roundoff)
of that term, so an output is held element-wise to
``|got - want| <= 2^-8 (|want| + Σ|terms|) + 1e-5``, ``Σ|terms|`` from
``_term_sums`` (a bound relative to the output alone fails where large
terms cancel, as in dK of a row with no valid key, whose P is 1 for every
key), and to a relative Frobenius error under 1e-2 (the roundings are
random in sign and average far below it).  lse stays f32 on both routes
(f32 scores and sums): ``rtol=1e-5, atol=2e-5``.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

F32 = dict(rtol=1e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
TC_RTOL, TC_ATOL = 2.0 ** -8, 1e-5
TC_FROBENIUS = 1e-2


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
    before = _counts()
    out, lse = tfa._fwd_cuda(q, k, v, mask, scale, causal)
    torch.cuda.synchronize()
    assert _counts() == _moved(before, fwd=1)         # the simt forward
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
    # dQ and dK/dV on tc32 at head dims that are multiples of 16, else simt
    assert _counts() == _moved(before, fwd=1, dq=1, dkv=1)


def _counts():
    f = tfa.flash_attention
    return (f.fwd_launches, f.dq_launches, f.dkv_launches, f.fwd_tc_launches,
            f.dq_tc_launches, f.dkv_tc_launches)


def _moved(before, fwd=0, dq=0, dkv=0, fwd_tc=0, dq_tc=0, dkv_tc=0):
    return tuple(a + n for a, n in zip(before, (fwd, dq, dkv, fwd_tc, dq_tc,
                                                dkv_tc)))


def _close_tc(got, want, terms, name):
    """Two bf16 roundings of each term: element-wise within
    ``TC_RTOL (|want| + terms) + TC_ATOL``, and a relative Frobenius error
    under ``TC_FROBENIUS``."""
    got, want = got.detach().float(), want.float()
    err = (got - want).abs()
    bound = TC_RTOL * (want.abs() + terms) + TC_ATOL
    worst = float((err / bound).max())
    assert worst <= 1.0, (name, worst, float(err.max()))
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert rel < TC_FROBENIUS, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("b, lq, lk, h, d, causal, masked", [
    (8, 1024, 1024, 8, 64, True, False),    # the training slice's shape
    (2, 1000, 1000, 2, 64, True, False),    # ragged L=1000, causal
    (2, 512, 512, 2, 64, False, True),      # key mask
    (2, 96, 160, 2, 64, False, False),      # cross lengths 96 x 160
    (1, 384, 384, 2, 128, True, False),     # head_dim 128
    (2, 200, 200, 2, 16, True, True),       # head_dim 16, ragged, masked
])
def test_tensor_core_kernels_match_plain_versions_bf16(
        cuda_device, b, lq, lk, h, d, causal, masked):
    q, k, v, do, mask = _inputs(3, b, lq, lk, h, d, torch.bfloat16, masked,
                                cuda_device)
    scale = d ** -0.5
    assert tfa._route(q.dtype, d) == "tc"
    before = _counts()
    out, lse = tfa._fwd_cuda(q, k, v, mask, scale, causal)
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, mask, scale, causal)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    dk, dv = tfa._dkv_cuda(q, k, v, mask, do, ref_lse, delta, scale, causal)
    dq = tfa._dq_cuda(q, k, v, mask, do, ref_lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert _counts() == _moved(before, fwd=1, dq=1, dkv=1, fwd_tc=1,
                               dq_tc=1, dkv_tc=1)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    terms = tfa._term_sums(q, k, v, mask, do, ref_lse, delta, scale, causal)
    _close_tc(out, ref_out, terms[0], "out")
    torch.testing.assert_close(lse, ref_lse, **F32)
    want_dq, want_dk, want_dv = tfa._bwd_reference(
        q, k, v, mask, do, ref_lse, delta, scale, causal)
    _close_tc(dk, want_dk, terms[1], "dk")
    _close_tc(dv, want_dv, terms[2], "dv")
    _close_tc(dq, want_dq, terms[3], "dq")


@pytest.mark.cuda
def test_tensor_core_row_with_no_valid_key_is_the_mean_of_v(cuda_device):
    q, k, v, do, _ = _inputs(4, 2, 256, 256, 2, 64, torch.bfloat16, False,
                             cuda_device)
    mask = torch.ones(2, 256, device=cuda_device)
    mask[1] = 0.0
    before = _counts()
    out, lse = tfa._fwd_cuda(q, k, v, mask, 0.125, False)
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, mask, 0.125, False)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    dk, dv = tfa._dkv_cuda(q, k, v, mask, do, ref_lse, delta, 0.125, False)
    dq = tfa._dq_cuda(q, k, v, mask, do, ref_lse, delta, 0.125, False)
    torch.cuda.synchronize()
    assert _counts()[3:] == _moved(before, fwd_tc=1, dq_tc=1, dkv_tc=1)[3:]
    terms = tfa._term_sums(q, k, v, mask, do, ref_lse, delta, 0.125, False)
    mean_v = v[1].float().mean(0, keepdim=True).expand_as(out[1])
    _close_tc(out[1], mean_v, terms[0][1], "out of the dead row")
    _close_tc(out, ref_out, terms[0], "out")
    torch.testing.assert_close(lse, ref_lse, **F32)
    want_dq, want_dk, want_dv = tfa._bwd_reference(q, k, v, mask, do,
                                                   ref_lse, delta, 0.125,
                                                   False)
    _close_tc(dk, want_dk, terms[1], "dk")
    _close_tc(dv, want_dv, terms[2], "dv")
    _close_tc(dq, want_dq, terms[3], "dq")


@pytest.mark.cuda
def test_bf16_autograd_matches_plain_version(cuda_device):
    q, k, v, do, _ = _inputs(1, 2, 256, 256, 4, 64, torch.bfloat16, False,
                             cuda_device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = _counts()
    out = tfa.flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    # the tensor-core forward, dQ and dK/dV
    assert _counts() == _moved(before, fwd=1, dq=1, dkv=1, fwd_tc=1,
                               dq_tc=1, dkv_tc=1)
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, None, 64 ** -0.5, True)
    assert out.dtype == torch.bfloat16
    assert all(x.grad.dtype == torch.bfloat16 for x in leaves)
    # the backward takes Δ from the bf16 output it saved
    delta = (do.float() * out.detach().float()).sum(-1).transpose(1, 2)
    args = (q, k, v, None, do, ref_lse, delta, 64 ** -0.5, True)
    terms = tfa._term_sums(*args)
    want = tfa._bwd_reference(*args)
    _close_tc(out, ref_out, terms[0], "out")
    _close_tc(leaves[0].grad, want[0], terms[3], "dq")
    _close_tc(leaves[1].grad, want[1], terms[1], "dk")
    _close_tc(leaves[2].grad, want[2], terms[2], "dv")


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


def _tc32_counts():
    f = tfa.flash_attention
    return f.dq_tc32_launches, f.dkv_tc32_launches


@pytest.mark.cuda
@pytest.mark.parametrize("b, lq, lk, h, d, causal, mask_kind", [
    (8, 1024, 1024, 8, 64, True, None),     # the training slice's shape
    (2, 1000, 1000, 4, 64, True, None),     # ragged L=1000, causal
    (2, 512, 512, 4, 64, False, "random"),  # key mask
    (2, 96, 160, 2, 32, False, None),       # cross lengths 96 x 160
    (1, 384, 384, 2, 128, True, None),      # head_dim 128
    (2, 256, 256, 2, 64, False, "dead"),    # a row with no valid key
    (2, 200, 200, 2, 16, True, "random"),   # head_dim 16, causal and mask
    (32, 128, 128, 2, 64, False, "ones"),   # BERT-tiny's shape (32 rows)
])
def test_tc32_backward_matches_plain_version_and_repeats_bitwise(
        cuda_device, b, lq, lk, h, d, causal, mask_kind):
    q, k, v, do, mask = _inputs(5, b, lq, lk, h, d, torch.float32,
                                mask_kind == "random", cuda_device)
    if mask_kind in ("dead", "ones"):
        mask = torch.ones(b, lk, device=cuda_device)
        if mask_kind == "dead":
            mask[-1] = 0.0
    scale = d ** -0.5
    assert tfa._route(q.dtype, d, "dq") == "tc32"
    assert tfa._route(q.dtype, d, "dkv") == "tc32"
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, mask, scale, causal)
    delta = (do * ref_out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, mask, do, ref_lse.contiguous(), delta, scale, causal)
    before, before32 = _counts(), _tc32_counts()
    runs = [(tfa._dq_cuda(*args), *tfa._dkv_cuda(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    assert _counts() == _moved(before, dq=2, dkv=2)
    assert _tc32_counts() == (before32[0] + 2, before32[1] + 2)
    want = tfa._bwd_reference(*args)
    simt = (tfa._dq_cuda(*args, route="simt"),
            *tfa._dkv_cuda(*args, route="simt"))
    for i, name in enumerate(("dq", "dk", "dv")):
        got = runs[0][i]
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want[i], msg=name, **GRAD)
        assert torch.equal(got, runs[1][i]), f"{name} not repeatable"
        # the SIMT kernels' f32 sums stand within the same tolerance
        torch.testing.assert_close(got, simt[i], msg=f"{name} vs simt",
                                   **GRAD)


@pytest.mark.cuda
def test_f32_autograd_takes_tc32_for_the_backward(cuda_device):
    q, k, v, do, _ = _inputs(6, 2, 256, 256, 4, 64, torch.float32, False,
                             cuda_device)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before, before32 = _counts(), _tc32_counts()
    out = tfa.flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    # the SIMT forward, the tc32 dQ and dK/dV
    assert _counts() == _moved(before, fwd=1, dq=1, dkv=1)
    assert _tc32_counts() == (before32[0] + 1, before32[1] + 1)
    ref_out, ref_lse = tfa._fwd_reference(q, k, v, None, 64 ** -0.5, True)
    delta = (do * out.detach()).sum(-1).transpose(1, 2)
    want = tfa._bwd_reference(q, k, v, None, do, ref_lse, delta, 64 ** -0.5,
                              True)
    for leaf, w, name in zip(leaves, want, "qkv"):
        torch.testing.assert_close(leaf.grad, w, msg=f"d{name}", **GRAD)


@pytest.mark.cuda
def test_tc32_refuses_16_bit_inputs(cuda_device):
    q, k, v, do, _ = _inputs(7, 1, 64, 64, 2, 64, torch.bfloat16, False,
                             cuda_device)
    lse = torch.zeros(1, 2, 64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        tfa._dq_cuda(q, k, v, None, do, lse, lse, 0.125, True, route="tc32")
