"""The port's sequence-parallel attentions against the JAX package's, on
gloo ranks (CPU).

One spawn of 4 gloo ranks on a (data, seq) mesh of shape (1, 4): each rank
holds one quarter of the sequence of q, k, v (and of the key mask and the
cotangent dO) and runs ``ring_attention``, ``ring_flash_attention``,
``ulysses_attention`` and ``ulysses_flash_attention``, causal and under a
key mask, then differentiates ``Σ out · dO``.  JAX runs the same functions
under ``shard_map`` over 4 devices of its 8-device CPU mesh.  Inside
``shard_map`` JAX's ``ring_flash`` runs the jnp twins of its Pallas block
kernels (``_fwd_block_ref``/``_bwd_block_ref``: Pallas interpret mode does
not lower there), and the port's CPU blocks run their plain versions, the
same math.  Outputs and the q/k/v gradients are held within ``rtol=1e-5,
atol=1e-5``: f32, the same algorithm, sums in other orders.  The rank
body lives at module level in this file, which imports no JAX at the top:
a spawned child re-imports the module that defines its target, and JAX
references are computed in the parent.

Without a spawn: ``ring_attention.virtual_ring`` (the ring's own
per-block functions over n virtual ranks in one process)
on the CPU's plain versions against JAX ``flash_fwd_block``/
``flash_bwd_block`` over the whole sequence (their jnp references, JAX's
interpret mode on the CPU), within ``rtol=1e-5, atol=2e-5`` (out, lse)
and ``rtol=1e-4, atol=1e-4`` (gradients); and the errors: heads that the
axis does not divide (JAX's message), and a sequence-parallel model with
no mesh bound.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib
from distributed_tensorflow_tpu_torch.parallel import ring_attention as ra

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

WORLD = 4
B, L, H, D = 2, 32, 4, 8            # blocks of 8 tokens on 4 ranks
IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")
CASES = [(impl, masked) for impl in IMPLS for masked in (False, True)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    """q, k, v, dO (B, L, H, D) and a (B, L) key mask whose every row
    keeps its first key."""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((B, L, H, D)).astype(np.float32)
                   for _ in range(4))
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return q, k, v, do, mask


def _attention_rank(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    meshlib.init_process_group("cpu", WORLD, rank, f"tcp://127.0.0.1:{port}")
    try:
        mesh = meshlib.create_mesh(WORLD, device="cpu", shape=(1, WORLD),
                                   axis_names=("data", "seq"))
        q, k, v, do, mask = _inputs()
        part = slice(rank * (L // WORLD), (rank + 1) * (L // WORLD))
        got = {}
        for impl, masked in CASES:
            local = [torch.tensor(a[:, part]).requires_grad_()
                     for a in (q, k, v)]
            out = ra.SEQ_PARALLEL[impl](
                *local, mesh, causal=not masked,
                kv_mask=torch.tensor(mask[:, part]) if masked else None)
            (out * torch.tensor(do[:, part])).sum().backward()
            tag = f"{impl}/{masked}"
            got[f"{tag}/out"] = out.detach().numpy()
            for name, t in zip("qkv", local):
                got[f"{tag}/d{name}"] = t.grad.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **got)
    finally:
        dist.destroy_process_group()


def _jax_references():
    """JAX's outputs and q/k/v gradients of each case under shard_map on 4
    devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu.parallel import ring_attention as jra

    fns = {"ring": jra.ring_attention,
           "ring_flash": jra.ring_flash_attention,
           "ulysses": jra.ulysses_attention,
           "ulysses_flash": jra.ulysses_flash_attention}
    mesh = jmesh.create_mesh(WORLD, axis_names=("seq",))
    q, k, v, do, mask = (jnp.asarray(a) for a in _inputs())
    spec = P(None, "seq")
    want = {}
    for impl, masked in CASES:
        def body(a, b, c, m, impl=impl, masked=masked):
            return fns[impl](a, b, c, axis="seq", causal=not masked,
                             kv_mask=m if masked else None)

        smapped = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                                out_specs=spec)

        def loss(a, b, c, smapped=smapped):
            out = smapped(a, b, c, mask)
            return (out * do).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        tag = f"{impl}/{masked}"
        want[f"{tag}/out"] = np.asarray(out)
        for name, g in zip("qkv", grads):
            want[f"{tag}/d{name}"] = np.asarray(g)
    return want


@pytest.fixture(scope="module")
def attention_run(tmp_path_factory):
    """The ranks run while the parent computes JAX's references."""
    out = tmp_path_factory.mktemp("ring")
    ranks = mp.spawn(_attention_rank, args=(meshlib.free_port(), str(out)),
                     nprocs=WORLD, join=False)
    want = _jax_references()
    while not ranks.join():
        pass
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    got = {key: np.concatenate([r[key] for r in ranks], axis=1)
           for key in ranks[0]}
    return got, want


@pytest.mark.parametrize("impl,masked", CASES)
def test_four_ranks_equal_jax_outputs_and_gradients(attention_run, impl,
                                                    masked):
    got, want = attention_run
    for name in ("out", "dq", "dk", "dv"):
        key = f"{impl}/{masked}/{name}"
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_four_ranks_equal_dense_attention(attention_run):
    """Every schedule's output is whole-sequence attention: the port's
    dense attention on one process."""
    got, _ = attention_run
    q, k, v, _, mask = (torch.tensor(a) for a in _inputs())
    for masked in (False, True):
        want = ra.dense_attention(q, k, v, causal=not masked,
                                  kv_mask=mask if masked else None).numpy()
        for impl in IMPLS:
            np.testing.assert_allclose(got[f"{impl}/{masked}/out"], want,
                                       err_msg=impl, **TOL)


# ------------------------------------------------------ no spawn

@pytest.mark.parametrize("n,causal", [(4, True), (2, False)])
def test_virtual_ring_equals_jax_flash_blocks(n, causal):
    """The ring's per-block functions over n virtual ranks (the chip
    smoke's check, here on the plain versions) against JAX's flash block
    primitives over the whole sequence."""
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.ops.flash_attention import (
        flash_bwd_block, flash_fwd_block)
    from test_torch_seq_parallel_cuda import ring_case

    q, k, v, do, mask = ring_case(7, b=2, l=64, h=2, d=16,
                                  masked=not causal, device="cpu")
    scale = 16 ** -0.5
    got = ra.virtual_ring(q, k, v, mask, do, n, causal=causal, scale=scale)
    jq, jk, jv, jdo, jmask = (jnp.asarray(t.numpy())
                              for t in (q, k, v, do, mask))
    out, lse = flash_fwd_block(jq, jk, jv, jmask, scale=scale,
                               causal=causal)
    delta = (jdo * out).sum(-1).transpose(0, 2, 1)
    grads = flash_bwd_block(jq, jk, jv, jmask, jdo, lse, delta, scale=scale,
                            causal=causal)
    for g, w in zip(got[:2], (out, lse)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=2e-5)
    for g, w in zip(got[2:], grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_future_pairings_launch_nothing():
    """Under the causal mask a pairing with a later block is skipped: no
    block call, zeros and an lse of NEG_INF that the merge weighs by 0."""
    q, k, v, do = (torch.ones(1, 4, 1, 16) for _ in range(4))
    mask = torch.ones(1, 4)
    out, lse = ra.ring_fwd_block(q, k, v, mask, src=2, idx=1, causal=True,
                                 scale=0.25)
    assert not out.any() and (lse == ra.NEG_INF).all()
    assert ra.ring_bwd_block(q, k, v, mask, do, lse, lse, src=2, idx=1,
                             causal=True, scale=0.25) is None
    acc, merged = ra._merge_blocks(torch.full_like(q, 3.0),
                                   torch.zeros(1, 1, 4), out, lse)
    assert (acc == 3.0).all() and (merged == 0.0).all()


def test_ulysses_rejects_indivisible_heads_as_jax():
    """JAX's message; the check comes before any collective."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_tpu.parallel import mesh as jmesh
    from distributed_tensorflow_tpu.parallel import ring_attention as jra

    q = np.zeros((1, 4, 3, 8), np.float32)
    mesh = types.SimpleNamespace(axis_size=lambda axis: 2,
                                 axis_index=lambda axis: 0)
    with pytest.raises(ValueError) as port:
        ra.ulysses_attention(*(torch.tensor(q),) * 3, mesh)
    jm = jmesh.create_mesh(2, axis_names=("seq",))
    smapped = jax.shard_map(
        lambda a: jra.ulysses_attention(a, a, a, axis="seq"), mesh=jm,
        in_specs=P(None, "seq"), out_specs=P(None, "seq"))
    with pytest.raises(ValueError) as ref:
        smapped(jnp.zeros((1, 8, 3, 8)))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kind", ["gpt", "bert_tiny"])
def test_unbound_seq_parallel_model_raises(kind):
    from distributed_tensorflow_tpu_torch.models import create_model

    model = create_model(kind, num_classes=16, vocab_size=16, hidden=16,
                         layers=1, heads=2, ffn=32, max_len=16,
                         attention_impl="ring", device="cpu")
    with pytest.raises(ValueError, match="no mesh bound"):
        model(torch.ones(1, 8, dtype=torch.long))
