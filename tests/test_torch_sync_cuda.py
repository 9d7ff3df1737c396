"""The data-parallel training path on the card: ``SyncEngine`` over a
1-rank NCCL mesh, ``DevicePrefetch``'s side-stream staging, and the
``Trainer``'s chunked drain.  Marked ``cuda``: skipped without an NVIDIA
GPU.  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_sync_cuda.py

Convolutions run with cuDNN's deterministic algorithms and without TF32,
so the 1-rank NCCL path, whose all-reduce sums one rank's gradients, must
give the no-mesh step's bits exactly.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.data import loaders
from distributed_tensorflow_tpu_torch.data.device_prefetch import (
    DevicePrefetch)
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NCCL backend and CUDA "
                    "streams have no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _mnist(rows):
    ds = loaders.load_dataset("mnist")
    return ds.x[:rows], ds.y[:rows]


def _steps(mesh, x, y, n_steps=3):
    eng = SyncEngine(create_model("cnn", dropout_rate=0.25,
                                  device=None if mesh else "cuda"),
                     mesh=mesh)
    state = eng.init_state(torch.Generator().manual_seed(0), x)
    losses = []
    for i in range(n_steps):
        xs, ys = eng.shard_batch(x[32 * i:32 * i + 32], y[32 * i:32 * i + 32])
        state, m = eng.step(state, xs, ys)
        losses.append(float(m["loss"]))
    return losses, {k: v.cpu() for k, v in state.model.state_dict().items()}


def test_nccl_one_rank_step_equals_no_mesh_step(cuda_device):
    x, y = _mnist(96)
    want_losses, want = _steps(None, x, y)
    mesh = meshlib.create_mesh(1)
    try:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        before = coll.all_reduce_.nccl_launches
        got_losses, got = _steps(mesh, x, y)
        assert coll.all_reduce_.nccl_launches == before + 3
    finally:
        mesh.close()
    assert got_losses == want_losses
    for name, w in want.items():
        assert torch.equal(got[name], w), name


def test_prefetch_side_stream_delivers_the_host_batches(cuda_device):
    x, y = _mnist(64)
    eng = SyncEngine(create_model("mlp", device="cuda"))
    batches = list(loaders.Dataset(x=x, y=y, num_classes=10).batches(
        8, shuffle=True, seed=1))
    pf = DevicePrefetch(iter(batches), lambda b: eng.shard_batch(b[0], b[1]),
                        depth=2, device="cuda")
    got = []
    for xs, ys in pf:
        # consume on the default stream at once, as a train step does
        got.append(((xs * 2).cpu(), ys.cpu()))
    assert len(got) == len(batches) == 8 and pf.consumed == 8
    for (gx, gy), (bx, by, _m) in zip(got, batches):
        assert torch.equal(gx, torch.from_numpy(bx) * 2)
        assert torch.equal(gy, torch.from_numpy(by))


def test_trainer_drain_on_the_card(cuda_device):
    x, y = _mnist(256)
    ds = loaders.Dataset(x=x, y=y, num_classes=10, name="mnist")
    runs = {}
    for k in (1, 8):
        lines = []
        trainer = Trainer(create_model("mlp", device="cuda"), seed=0)
        r = trainer.fit(ds, batch_size=32, log_every=1, log_fn=lines.append,
                        steps_per_call=k)
        assert r["steps"] == 8 and np.isfinite(r["final_loss"])
        runs[k] = lines
    assert runs[1] == runs[8] and len(runs[1]) == 8
