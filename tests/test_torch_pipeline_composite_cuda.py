"""The pipeline's dense composites on the card.  Marked ``cuda``: skipped
without an NVIDIA GPU (the flash kernels have no CPU mode).  On the card,
with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_pipeline_composite_cuda.py

The card is one GPU and NCCL takes one rank per device, so every axis has
one rank here (the many-rank composites are held to JAX on gloo ranks on
the CPU, ``tests/test_torch_pipeline_composite.py``).  Over the GPT
stages (2 layers, bf16 compute over f32 parameters):

* pp×tp on (1, 1, 1) (data, pipe, model), with the Megatron stages and
  flash attention (the ``tc`` kernels), gives losses and parameters
  bitwise those of its (1, 1) (data, pipe) twin over the plain stages: a
  group of one is a copy, and every bias rides in its GEMM;
* pp×tp×sp on (1, 1, 1, 1) (data, pipe, seq, model) with ``ring_flash``
  (the ring's block kernels: forward on ``tc``, backward on ``tc32``) is
  bitwise pp×sp on (1, 1, 1), and both launch layers × M block forwards,
  dQ and dK/dV a step.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

LAYERS, MICRO, STEPS = 2, 2, 3
STAGES = dict(vocab_size=512, hidden=128, heads=2, ffn=256, max_len=256,
              layers_per_stage=LAYERS, dtype=torch.bfloat16)
RING = dict(attention_impl="ring_flash", seq_axis="seq")


@pytest.fixture
def group():
    """A process group of one on the card (owned by a (1, 1) mesh, closed
    last), with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU "
                    "mode")
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "pipe"))
    yield m
    m.close()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _mesh(axes):
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    return meshlib.create_mesh(1, shape=(1,) * len(axes), axis_names=axes)


def _batch():
    tok = np.random.default_rng(0).integers(0, 512, (4, 129))
    return tok[:, :-1].astype(np.int32), tok[:, 1:].astype(np.int32)


def _counts():
    from distributed_tensorflow_tpu_torch.ops import flash_attention as fa

    f = fa.flash_attention
    return {k: getattr(f, f"{k}_launches") for k in (
        "fwd_tc", "dq_tc", "dkv_tc", "fwd_tc32", "dq_tc32", "dkv_tc32")}


def _run(mesh, **kw):
    """STEPS steps of ``PipelineEngine`` over the GPT stages drawn from
    seed 0; the losses, the flash launches and the final parameters."""
    from distributed_tensorflow_tpu_torch.engines import PipelineEngine
    from distributed_tensorflow_tpu_torch.models.gpt import (
        gpt_pipeline_stages)

    eng = PipelineEngine(
        microbatches=MICRO, mesh=mesh,
        stages=gpt_pipeline_stages(**STAGES, **kw),
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-3))
    state = eng.init_state(torch.Generator().manual_seed(0))
    xs, ys = eng.shard_batch(*_batch())
    before = _counts()
    losses = []
    for _ in range(STEPS):
        state, m = eng.step(state, xs, ys)
        losses.append(float(m["loss"]))
    counts = {k: v - before[k] for k, v in _counts().items()}
    return losses, counts, {k: v.detach().clone()
                            for k, v in state.model.state_dict().items()}


def _same(a, b):
    assert a[0] == b[0], (a[0], b[0])
    for k, v in b[2].items():
        assert torch.equal(a[2][k], v), k


def test_pp_tp_is_bitwise_its_pipeline_twin(group):
    twin = _run(group, attention_impl="flash")
    mesh = _mesh(("data", "pipe", "model"))
    try:
        losses, counts, params = _run(mesh, partition_model=True,
                                      attention_impl="flash")
    finally:
        mesh.close()
    _same((losses, counts, params), twin)
    n = LAYERS * MICRO * STEPS
    assert counts == twin[1] == {"fwd_tc": n, "dq_tc": n, "dkv_tc": n,
                                 "fwd_tc32": 0, "dq_tc32": 0,
                                 "dkv_tc32": 0}, counts


def test_pp_tp_sp_is_bitwise_pp_sp(group):
    runs = {}
    for name, axes, kw in (
            ("pp_sp", ("data", "pipe", "seq"), RING),
            ("pp_tp_sp", ("data", "pipe", "seq", "model"),
             dict(RING, partition_model=True))):
        mesh = _mesh(axes)
        try:
            runs[name] = _run(mesh, **kw)
        finally:
            mesh.close()
    _same(runs["pp_tp_sp"], runs["pp_sp"])
    n = LAYERS * MICRO * STEPS
    assert runs["pp_sp"][1] == {"fwd_tc": n, "dq_tc": 0, "dkv_tc": 0,
                                "fwd_tc32": 0, "dq_tc32": n,
                                "dkv_tc32": n}, runs["pp_sp"][1]
    assert all(np.isfinite(runs["pp_sp"][0]))
