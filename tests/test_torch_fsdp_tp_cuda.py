"""FSDP and tensor parallelism on the card.  Marked ``cuda``: skipped
without an NVIDIA GPU (the flash kernels have no CPU mode).  On the card,
with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_fsdp_tp_cuda.py

The card is one GPU, and NCCL takes one rank per device, so the many-rank
math is held on gloo ranks on the CPU (``tests/test_torch_fsdp.py``,
``tests/test_torch_tensor_parallel.py``).  Here, on one NCCL rank, every
collective of the new paths runs on NCCL over a group of one, and:

* ``FSDPEngine`` on a ('data',) mesh of 1 trains a flash GPT with the
  recipe's ``ScheduledAdamW`` (clip and weight decay on): every shard is
  the whole leaf, so its losses and parameters are bitwise
  ``SyncEngine``'s from the same weights and batches, and each step
  makes one all-gather of every slice and one reduce-scatter;
* ``TensorParallelEngine`` on a (1, 1) (data, model) mesh trains the
  ``partition_model`` flash GPT: bitwise the flash GPT under
  ``SyncEngine`` (one Adam for both: the sync engine's default is
  capturable), with 2 × layers + 1 model-axis all-reduces in each forward
  (row-parallel outputs and the vocab-parallel embedding) and as many in
  each backward (column-parallel inputs and the tied head's input).
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda

LAYERS = 2


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


def _gpt(**kw):
    from distributed_tensorflow_tpu_torch.models import create_model

    return create_model("gpt", num_classes=512, hidden=128, layers=LAYERS,
                        heads=2, ffn=256, max_len=256, dropout_rate=0.1,
                        attention_impl="flash", **kw)


def _batches():
    tok = np.random.default_rng(0).integers(0, 512, (3, 4, 129))
    return [(x[:, :-1], x[:, 1:]) for x in tok]


def _recipe(params):
    from distributed_tensorflow_tpu_torch.utils import optim

    params = list(params)
    return optim.ScheduledAdamW(params, 1e-3, weight_decay=0.1,
                                decay_mask=[p.ndim >= 2 for p in params],
                                clip_norm=0.5)


def _train(eng):
    state = eng.init_state(torch.Generator().manual_seed(0))
    losses = []
    for x, y in _batches():
        state, m = eng.step(state, *eng.shard_batch(x, y))
        losses.append(float(m["loss"]))
    return losses, {k: v.clone() for k, v in
                    eng.eval_params(state).state_dict().items()}


def test_fsdp_on_one_rank_is_bitwise_sync(cuda_device):
    from distributed_tensorflow_tpu_torch.engines import (
        FSDPEngine, SyncEngine)
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.create_mesh(1)
    try:
        sync = _train(SyncEngine(_gpt(), mesh=mesh, optimizer=_recipe))
        gathers = coll.gather_shards.nccl_launches
        scatters = coll.gather_shards.nccl_scatter_launches
        eng = FSDPEngine(_gpt(), mesh=mesh, optimizer=_recipe)
        fsdp = _train(eng)
        assert len(eng.param_specs) == len(list(_gpt().parameters()))
        assert coll.gather_shards.nccl_launches - gathers == 3
        assert coll.gather_shards.nccl_scatter_launches - scatters == 3
    finally:
        mesh.close()
    assert fsdp[0] == sync[0], (fsdp[0], sync[0])
    for k, v in sync[1].items():
        assert torch.equal(fsdp[1][k], v), k


def test_tp_on_a_1x1_mesh_is_bitwise_sync(cuda_device):
    from distributed_tensorflow_tpu_torch.engines import (
        SyncEngine, TensorParallelEngine)
    from distributed_tensorflow_tpu_torch.parallel import collectives as coll
    from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

    opt = lambda p: torch.optim.Adam(p, lr=1e-3)  # noqa: E731
    mesh = meshlib.create_mesh(1, shape=(1, 1), axis_names=("data", "model"))
    try:
        sync = _train(SyncEngine(_gpt(), mesh=mesh, optimizer=opt))
        before = (coll.reduce_from_model.nccl_launches,
                  coll.copy_to_model.nccl_launches,
                  tfa.flash_attention.fwd_launches)
        tp = _train(TensorParallelEngine(_gpt(partition_model=True),
                                         mesh=mesh, optimizer=opt))
        torch.cuda.synchronize()
        after = (coll.reduce_from_model.nccl_launches,
                 coll.copy_to_model.nccl_launches,
                 tfa.flash_attention.fwd_launches)
    finally:
        mesh.close()
    steps = len(_batches())
    assert [a - b for a, b in zip(after, before)] == [
        steps * (2 * LAYERS + 1), steps * (2 * LAYERS + 1), steps * LAYERS]
    assert tp[0] == sync[0], (tp[0], sync[0])
    for k, v in sync[1].items():
        assert torch.equal(tp[1][k], v), k
