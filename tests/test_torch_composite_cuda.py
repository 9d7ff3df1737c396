"""The tp×sp composite on the card.  Marked ``cuda``: skipped without an
NVIDIA GPU (the flash kernels have no CPU mode).  On the card, with no JAX
installed there:

    python -m pytest -m cuda tests/test_torch_composite_cuda.py

The card is one GPU, and NCCL takes one rank per device, so the
composites' many-rank math is held on gloo ranks on the CPU
(``tests/test_torch_composite.py``).  Here ``CompositeEngine`` on a (1, 1,
1) (data, model, seq) NCCL mesh trains a small partitioned GPT with
``ring_flash`` (f32: the ring's forward, dQ and dK/dV on the ``tc32``
kernels) for 3 steps against its ``SeqParallelEngine`` twin on a (1, 1)
mesh from the same weights, batches and Adam.  At one rank every
tensor-parallel collective is a group of one and the row-parallel bias
rides in the GEMM, so the losses and the parameters are held bitwise,
and the launches are 2 forward, dQ and dK/dV a step on ``tc32``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GPT = dict(num_classes=64, hidden=64, layers=2, heads=4, ffn=128,
           max_len=256, dropout_rate=0.0, dtype="float32",
           attention_impl="ring_flash")
STEPS = 3


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


def _run(cls, shape, axes, **model_kw):
    """STEPS eager steps of ``cls`` on a one-rank mesh: the losses, the
    final state_dict and the flash launches (tc32) a step."""
    from distributed_tensorflow_tpu_torch.models import create_model
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    rng = np.random.default_rng(0)
    tok = rng.integers(0, 64, (STEPS * 4, 129)).astype(np.int32)
    mesh = meshlib.create_mesh(1, shape=shape, axis_names=axes)
    try:
        eng = cls(create_model("gpt", **GPT, **model_kw), mesh=mesh,
                  optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
        state = eng.init_state(torch.Generator().manual_seed(0))
        for n in ("fwd", "dq", "dkv"):
            setattr(fa.flash_attention, f"{n}_tc32_launches", 0)
        losses = []
        for i in range(STEPS):
            rows = tok[4 * i:4 * i + 4]
            state, m = eng.step(state, *eng.shard_batch(rows[:, :-1],
                                                        rows[:, 1:]))
            losses.append(float(m["loss"]))
        counts = {n: getattr(fa.flash_attention, f"{n}_tc32_launches")
                  for n in ("fwd", "dq", "dkv")}
        params = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
    finally:
        mesh.close()
    return losses, params, counts


def test_tp_sp_on_one_rank_is_bitwise_its_seq_parallel_twin(cuda_device):
    from distributed_tensorflow_tpu_torch.engines import (
        CompositeEngine, SeqParallelEngine)

    got = _run(CompositeEngine, (1, 1, 1), ("data", "model", "seq"),
               partition_model=True)
    want = _run(SeqParallelEngine, (1, 1), ("data", "seq"))
    assert all(np.isfinite(got[0])), got[0]
    assert got[0] == want[0], (got[0], want[0])
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k
    n = GPT["layers"] * STEPS
    assert got[2] == want[2] == {"fwd": n, "dq": n, "dkv": n}
