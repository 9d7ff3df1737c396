"""Port of ``ops/flash_attention.py``: the plain PyTorch versions held to the
JAX Pallas kernels in interpret mode, outside ``shard_map`` (as
``tests/test_flash_attention.py`` runs them), on that file's cases:
single and multi-block, causal and not, a ragged length, a key mask, cross
lengths, bf16 inputs; gradients against ``jax.grad`` of the kernel's
custom_vjp; the row with no valid key; the block primitives against the
JAX kernels with the padding ``flash_fwd_block``/``flash_bwd_block`` apply
on the TPU; and the wrapper's input checks.  The Hopper kernels themselves
are held to these plain versions on the card by
``tests/test_torch_flash_attention_cuda.py``.

The route choice (``_route``: the tensor-core kernels for bf16 at head
dims that are multiples of 16 up to 128) and the shared memory of both
routes are checked here; the kernels of both routes run only on the card.

Tolerances, those of ``tests/test_flash_attention.py``: outputs
``rtol=atol=1e-5`` (online-softmax reassociation against one softmax);
gradients ``1e-4``; bf16 outputs one bf16 rounding (``rtol=atol=8e-3``),
since both sides compute in f32 and round once.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("distributed_tensorflow_tpu.ops.flash_attention")

OUT = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=8e-3, atol=8e-3)


def _qkv(seed, b, l, h, d, lk=None):
    rng = np.random.default_rng(seed)
    lk = lk or l
    return (rng.standard_normal((b, l, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, h, d)).astype(np.float32))


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l, block", [(16, 512), (64, 16)])
def test_forward_matches_pallas_kernel(causal, l, block):
    """Single block (L=16 at the default blocks) and a 4x4 grid of 16-wide
    blocks (the online-softmax merge)."""
    q, k, v = _qkv(0, 2, l, 2, 8)
    want = jfa.flash_attention(*_j(q, k, v), causal=causal, block_q=block,
                               block_k=block, interpret=True)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


@pytest.mark.parametrize("case", ["ragged_50", "kv_mask", "cross_32_48"])
def test_forward_edge_cases_match_pallas_kernel(case):
    mask = None
    if case == "ragged_50":          # JAX pads 50 -> 64 and slices back
        q, k, v = _qkv(2, 1, 50, 2, 8)
    elif case == "kv_mask":
        q, k, v = _qkv(3, 2, 32, 2, 8)
        mask = (np.random.default_rng(4).uniform(size=(2, 32)) > 0.3)
        mask[:, 0] = True
        mask = mask.astype(np.float32)
    else:
        q, k, v = _qkv(5, 1, 32, 2, 8, lk=48)
    kw_j = {} if mask is None else {"kv_mask": jnp.asarray(mask)}
    kw_t = {} if mask is None else {"kv_mask": torch.from_numpy(mask)}
    want = jfa.flash_attention(*_j(q, k, v), block_q=16, block_k=16,
                               interpret=True, **kw_j)
    got = tfa.flash_attention(*_t(q, k, v), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)


def test_bfloat16_inputs_match_pallas_kernel():
    q, k, v = _qkv(9, 1, 32, 2, 8)
    want = jfa.flash_attention(*(x.astype(jnp.bfloat16) for x in _j(q, k, v)),
                               block_q=16, block_k=16, interpret=True)
    got = tfa.flash_attention(*(x.to(torch.bfloat16) for x in _t(q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def _grads_jax(q, k, v, loss, **kw):
    def f(q, k, v):
        return loss(jfa.flash_attention(q, k, v, block_q=16, block_k=16,
                                        interpret=True, **kw))

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        *_j(q, k, v))]


def _grads_port(q, k, v, loss, **kw):
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    loss(tfa.flash_attention(tq, tk, tv, **kw)).backward()
    return [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_pallas_backward(causal):
    q, k, v = _qkv(6, 2, 32, 2, 8)
    want = _grads_jax(q, k, v, lambda o: jnp.sum(jnp.sin(o)), causal=causal)
    got = _grads_port(q, k, v, lambda o: torch.sin(o).sum(), causal=causal)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)


def test_gradients_with_mask_and_padding_match_pallas_backward():
    q, k, v = _qkv(7, 1, 40, 2, 8)          # JAX pads 40 -> 48
    mask = np.ones((1, 40), np.float32)
    mask[:, 33:] = 0.0
    want = _grads_jax(q, k, v, lambda o: jnp.sum(o * o),
                      kv_mask=jnp.asarray(mask))
    got = _grads_port(q, k, v, lambda o: (o * o).sum(),
                      kv_mask=torch.from_numpy(mask))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)


def test_row_with_no_valid_key_matches_pallas_kernel():
    """The reference kernel gives such a row the mean of V over the keys it
    visits (every score is -1e30, so the weights are uniform), not 0 as its
    docstring says.  L=32 at 16-wide blocks: JAX pads no keys."""
    q, k, v = _qkv(8, 2, 32, 2, 8)
    mask = np.ones((2, 32), np.float32)
    mask[1] = 0.0
    want = jfa.flash_attention(*_j(q, k, v), kv_mask=jnp.asarray(mask),
                               block_q=16, block_k=16, interpret=True)
    got = tfa.flash_attention(*_t(q, k, v), kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT)
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(0), got[1].shape),
                               **OUT)
    want_g = _grads_jax(q, k, v, lambda o: jnp.sum(jnp.sin(o)),
                        kv_mask=jnp.asarray(mask))
    got_g = _grads_port(q, k, v, lambda o: torch.sin(o).sum(),
                        kv_mask=torch.from_numpy(mask))
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, **GRAD)


def _to_bh(x):
    b, l, h, d = x.shape
    return jnp.moveaxis(x, 2, 1).reshape(b * h, l, d)


def _from_bh(x, b, h):
    return jnp.moveaxis(x.reshape(b, h, x.shape[1], x.shape[2]), 1, 2)


def _pallas_block_pair(q, k, v, mask, do, causal, bq=16, bk=16):
    """The TPU path of ``flash_fwd_block``/``flash_bwd_block`` run in
    interpret mode: pad q/do to bq and k/v/mask to bk, call the Pallas
    ``_fwd``/``_bwd``, and give padded q rows ``lse = +1e30`` as the TPU
    path does.  Returns (out, lse, delta, dq, dk, dv) on the real rows."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5
    qp, pad_q = jfa._pad_seq(jnp.asarray(q), bq)
    dop, _ = jfa._pad_seq(jnp.asarray(do), bq)
    kp, _ = jfa._pad_seq(jnp.asarray(k), bk)
    vp, pad_k = jfa._pad_seq(jnp.asarray(v), bk)
    m = jnp.pad(jnp.asarray(mask), ((0, 0), (0, pad_k)))
    m_bh = jnp.repeat(m, h, axis=0)[:, None, :]
    out, lse = jfa._fwd(_to_bh(qp), _to_bh(kp), _to_bh(vp), m_bh, scale,
                        causal, bq, bk, True)
    out = _from_bh(out, b, h)[:, :lq]
    lse = lse.reshape(b, h, lq + pad_q)[:, :, :lq]
    delta = jnp.einsum("blhd,blhd->bhl", jnp.asarray(do), out)
    rows = ((0, 0), (0, 0), (0, pad_q))
    lse_p = jnp.pad(lse, rows, constant_values=-jfa.NEG_INF)
    delta_p = jnp.pad(delta, rows)
    dq, dk, dv = jfa._bwd(_to_bh(qp), _to_bh(kp), _to_bh(vp), m_bh,
                          lse_p.reshape(b * h, 1, -1),
                          delta_p.reshape(b * h, 1, -1), _to_bh(dop), scale,
                          causal, bq, bk, True)
    return (np.asarray(out), np.asarray(lse), np.asarray(delta),
            np.asarray(_from_bh(dq, b, h)[:, :lq]),
            np.asarray(_from_bh(dk, b, h)[:, :lk]),
            np.asarray(_from_bh(dv, b, h)[:, :lk]))


@pytest.mark.parametrize("causal, lq, lk", [(False, 40, 24), (True, 40, 40)])
def test_block_primitives_match_pallas_kernels(causal, lq, lk):
    """Padded q rows (40 -> 48) carry lse = +1e30 into the Pallas
    backward; the port masks them in the kernel instead."""
    rng = np.random.default_rng(10)
    q, k, v = _qkv(11, 2, lq, 2, 8, lk=lk)
    do = rng.standard_normal(q.shape).astype(np.float32)
    mask = (rng.uniform(size=(2, lk)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    out, lse, delta, dq, dk, dv = _pallas_block_pair(q, k, v, mask, do,
                                                     causal)
    scale = 8 ** -0.5
    t_out, t_lse = tfa.flash_fwd_block(*_t(q, k, v, mask), scale=scale,
                                       causal=causal)
    np.testing.assert_allclose(t_out.numpy(), out, **OUT)
    np.testing.assert_allclose(t_lse.numpy(), lse, **OUT)
    got = tfa.flash_bwd_block(*_t(q, k, v, mask, do, lse, delta),
                              scale=scale, causal=causal)
    for a, b, name in zip(got, (dq, dk, dv), "qkv"):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"d{name}", **GRAD)
    # and against the JAX block primitives themselves (their jnp twin)
    j_out, j_lse = jfa.flash_fwd_block(*_j(q, k, v, mask), scale=scale,
                                       causal=causal, interpret=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **OUT)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **OUT)
    j_grads = jfa.flash_bwd_block(*_j(q, k, v, mask, do, lse, delta),
                                  scale=scale, causal=causal, interpret=True)
    for a, b in zip(got, j_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def _launch_counts():
    f = tfa.flash_attention
    return (f.fwd_launches, f.dq_launches, f.dkv_launches, f.fwd_tc_launches,
            f.dq_tc_launches, f.dkv_tc_launches)


def test_grads_come_back_in_input_dtypes_and_count_no_cpu_launches():
    q, k, v = (x.to(torch.bfloat16).requires_grad_()
               for x in _t(*_qkv(12, 1, 16, 2, 8)))
    before = _launch_counts()
    tfa.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert {q.grad.dtype, k.grad.dtype, v.grad.dtype} == {torch.bfloat16}
    assert before == _launch_counts()


@pytest.mark.parametrize("dtype, d, route", [
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 64, "tc"),
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 8, "simt"),
    (torch.bfloat16, 72, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 64, "tc32"), (torch.float32, 8, "simt"),
    (torch.float32, 256, "simt")])
def test_route_takes_tensor_cores_for_bf16_at_multiples_of_16(dtype, d,
                                                               route):
    assert tfa._route(dtype, d) == route


def test_cpu_tensors_of_the_tc_route_run_the_plain_versions():
    """bf16 at head_dim 16 would take the tensor-core kernels on the card;
    on the CPU it runs the plain versions and counts no launch."""
    q, k, v = (x.to(torch.bfloat16)
               for x in _t(*_qkv(14, 2, 24, 2, 16, lk=40)))
    mask = torch.ones(2, 40)
    mask[1, 30:] = 0.0
    assert tfa._route(q.dtype, 16) == "tc"
    before = _launch_counts()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, kv_mask=mask)
    out.float().sum().backward()
    assert before == _launch_counts()
    want, _ = tfa._fwd_reference(q, k, v, mask, 0.25, False)
    assert torch.equal(out.detach(), want)


def test_term_sums_bound_the_plain_outputs():
    """The rounding bound of the tensor-core tolerance: each output is at
    most the sum of its absolute terms."""
    q, k, v = _t(*_qkv(15, 1, 32, 2, 16))
    do = torch.from_numpy(np.random.default_rng(16).standard_normal(
        q.shape).astype(np.float32))
    out, lse = tfa._fwd_reference(q, k, v, None, 0.25, True)
    delta = (do * out).sum(-1).transpose(1, 2)
    dq, dk, dv = tfa._bwd_reference(q, k, v, None, do, lse, delta, 0.25,
                                    True)
    terms = tfa._term_sums(q, k, v, None, do, lse, delta, 0.25, True)
    assert len(terms) == 4
    for got, bound in zip((out, dk, dv, dq), terms):
        assert got.shape == bound.shape
        assert bool((got.abs() <= bound * (1 + 1e-5) + 1e-6).all())


def test_wrapper_rejects_bad_inputs():
    q, k, v = _t(*_qkv(13, 1, 8, 2, 8))
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match=r"\(B, L, H, D\)"):
        tfa.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="k and v"):
        tfa.flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match="kv_mask"):
        tfa.flash_attention(q, k, v, kv_mask=torch.ones(1, 9))
    big = torch.zeros(1, 4, 1, 264)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="lse and delta"):
        tfa.flash_bwd_block(q, k, v, torch.ones(1, 8), q,
                            torch.zeros(1, 2, 7), torch.zeros(1, 2, 8),
                            scale=1.0)


@pytest.mark.parametrize("route, d", [
    ("simt", 1), ("simt", 64), ("simt", 65), ("simt", 128), ("simt", 129),
    ("simt", 256), ("tc", 16), ("tc", 64), ("tc", 80), ("tc", 128)])
def test_shared_memory_fits_the_card_at_every_head_dim_tier(route, d):
    assert max(tfa.smem_bytes(d, route).values()) <= tfa._SMEM_LIMIT


@pytest.mark.parametrize("d, kind, want", [
    # Q and dO tiles, two stages of K and V, two stages of the key mask
    (64, "dq", 6 * 64 * 72 * 2 + 2 * 64 * 4),
    (128, "dq", 6 * 64 * 136 * 2 + 2 * 64 * 4),
    (16, "dq", 6 * 64 * 72 * 2 + 2 * 64 * 4),
    (64, "fwd", 5 * 64 * 72 * 2 + 2 * 64 * 4),
    (64, "dkv", 6 * 64 * 72 * 2 + 4 * 64 * 4)])
def test_tc_shared_memory_mirrors_the_kernels(d, kind, want):
    assert tfa.smem_bytes(d, "tc")[kind] == want


def test_tc_shared_memory_is_refused_outside_its_head_dims():
    for d in (8, 72, 144, 256):
        with pytest.raises(ValueError, match="multiples of 16"):
            tfa.smem_bytes(d, "tc")


@pytest.mark.parametrize("dtype, d, op, route", [
    # float32: the forward, dQ and dK/dV on the 3xTF32 tensor-core kernels
    # at head dims that are multiples of 16 up to 128, else on SIMT
    (torch.float32, 16, "dq", "tc32"), (torch.float32, 64, "dq", "tc32"),
    (torch.float32, 128, "dq", "tc32"), (torch.float32, 16, "dkv", "tc32"),
    (torch.float32, 64, "dkv", "tc32"), (torch.float32, 128, "dkv", "tc32"),
    (torch.float32, 64, "fwd", "tc32"), (torch.float32, 128, "fwd", "tc32"),
    (torch.float32, 16, "fwd", "tc32"), (torch.float32, 8, "fwd", "simt"),
    (torch.float32, 24, "fwd", "simt"), (torch.float32, 256, "fwd", "simt"),
    (torch.float32, 8, "dq", "simt"), (torch.float32, 24, "dkv", "simt"),
    (torch.float32, 256, "dq", "simt"), (torch.float32, 256, "dkv", "simt"),
    # 16-bit routing is the same for every kernel
    (torch.bfloat16, 64, "fwd", "tc"), (torch.bfloat16, 64, "dq", "tc"),
    (torch.bfloat16, 64, "dkv", "tc"), (torch.float16, 128, "dkv", "tc"),
    (torch.bfloat16, 24, "dq", "simt"), (torch.float16, 256, "dkv",
                                         "simt")])
def test_route_is_a_function_of_dtype_head_dim_and_kernel(dtype, d, op,
                                                          route):
    assert tfa._route(dtype, d, op) == route


def test_route_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="fwd, dq or dkv"):
        tfa._route(torch.float32, 64, "bwd")


@pytest.mark.parametrize("bh, length, rows", [
    (64, 1024, 64),     # the training slice: 1024 CTAs of 64 rows
    (64, 128, 32),      # BERT-tiny's shape: 128 CTAs of 64 would be < 1 wave
    (2, 1000, 32), (264, 64, 64), (263, 64, 32), (132, 65, 64)])
def test_tc32_rows_halve_where_64_row_ctas_make_under_two_waves(bh, length,
                                                                rows):
    assert tfa._tc32_rows(bh, length) == rows


@pytest.mark.parametrize("d, rows", [(16, 64), (64, 64), (64, 32),
                                     (80, 64), (128, 64), (128, 32),
                                     (16, 32)])
def test_tc32_shared_memory_fits_and_mirrors_the_kernels(d, rows):
    got = tfa.smem_bytes(d, "tc32", rows)
    dt = 64 if d <= 64 else 128
    ld = dt + 4                    # f32 rows padded by 4 floats
    tiles = 2 * rows * ld + 4 * 64 * ld
    # own rows (Q, or Q and dO, or K and V); 2 stages of 64 staged rows of
    # two tensors; 2 stages of the key mask (forward, dQ) or of lse and
    # Delta (dK/dV)
    assert got == {"fwd": 4 * (rows * ld + 4 * 64 * ld + 2 * 64),
                   "dq": 4 * (tiles + 2 * 64), "dkv": 4 * (tiles + 4 * 64)}
    assert max(got.values()) <= tfa._SMEM_LIMIT
    assert tfa._tiles(d, "tc32") == (64, 64, dt)


def test_tc32_shared_memory_is_refused_outside_its_head_dims_and_rows():
    for d, rows in ((8, 64), (72, 64), (256, 64), (64, 16)):
        with pytest.raises(ValueError, match="tc32"):
            tfa.smem_bytes(d, "tc32", rows)


def test_cpu_tensors_of_the_tc32_route_run_the_plain_backward():
    """f32 at head_dim 16 takes the tc32 dQ and dK/dV on the card; on the
    CPU the plain versions run and no launch is counted."""
    q, k, v = _t(*_qkv(17, 2, 24, 2, 16))
    assert tfa._route(q.dtype, 16, "dq") == "tc32"
    before = _launch_counts()
    tc32 = (tfa.flash_attention.dq_tc32_launches,
            tfa.flash_attention.dkv_tc32_launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*leaves, causal=True).sum().backward()
    assert before == _launch_counts()
    assert tc32 == (tfa.flash_attention.dq_tc32_launches,
                    tfa.flash_attention.dkv_tc32_launches)
    assert all(x.grad is not None for x in leaves)


def test_cpu_tensors_of_the_tc32_route_run_the_plain_forward():
    """f32 at head_dim 16 takes the tc32 forward on the card; on the CPU
    ``_fwd_reference`` runs and no launch is counted."""
    q, k, v = _t(*_qkv(18, 2, 24, 2, 16, lk=40))
    mask = torch.ones(2, 40)
    mask[1, 30:] = 0.0
    assert tfa._route(q.dtype, 16, "fwd") == "tc32"
    f = tfa.flash_attention
    before = (_launch_counts(), f.fwd_tc32_launches, f.dq_tc32_launches,
              f.dkv_tc32_launches)
    out = tfa.flash_attention(q, k, v, kv_mask=mask)
    b_out, b_lse = tfa.flash_fwd_block(q, k, v, mask, scale=0.25,
                                       causal=True)
    assert before == (_launch_counts(), f.fwd_tc32_launches,
                      f.dq_tc32_launches, f.dkv_tc32_launches)
    want, _ = tfa._fwd_reference(q, k, v, mask, 0.25, False)
    assert torch.equal(out, want)
    want_out, want_lse = tfa._fwd_reference(q, k, v, mask, 0.25, True)
    assert torch.equal(b_out, want_out) and torch.equal(b_lse, want_lse)
