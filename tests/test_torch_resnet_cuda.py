"""ResNet-20 and the local-SGD engine on the card.  Marked ``cuda``:
skipped without an NVIDIA GPU.  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_resnet_cuda.py

* ResNet-20 at its published widths, the same parameters and seeded
  batch on the card (TF32 off) and on the CPU: logits within
  ``rtol=atol=1e-4`` and each parameter's gradient within a relative
  Frobenius error of 1e-4 (f32 sums in other orders, cuDNN's algorithms
  among them).  A ReLU input within the two devices' rounding difference
  of 0 may fall on the other side of its kink on each, which moves the
  gradients upstream of it by ~1e-3; so the card's backward takes the
  CPU forward's ReLU masks (each checked against the card's own sign
  wherever its input is farther than 1e-5 from 0);
* ``AsyncLocalEngine`` on a 1-rank NCCL group: one all-reduce per step
  and one for ``eval_params``, and the bits of the engine without a mesh
  (the sum over one rank divided by one is exact).
"""

import pytest
import torch

from distributed_tensorflow_tpu_torch.data import loaders
from distributed_tensorflow_tpu_torch.engines import AsyncLocalEngine
from distributed_tensorflow_tpu_torch.engines.base import cross_entropy
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

pytestmark = pytest.mark.cuda

LOGITS = dict(rtol=1e-4, atol=1e-4)
GRAD_FROBENIUS = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuDNN convolutions and the NCCL "
                    "backend have no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _cifar(rows):
    ds = loaders.load_dataset("cifar10")
    return ds.x[:rows], ds.y[:rows]


def _logits_and_grads(device, state_dict, x, y, monkeypatch, masks=None):
    """Logits, gradients and the ReLU masks of one forward and backward;
    with ``masks`` the ReLUs apply them in place of their own."""
    model = create_model("resnet20", device=device)
    with torch.no_grad():
        model(torch.from_numpy(x[:1]).to(device))
    model.load_state_dict(state_dict)
    seen, given = [], iter(masks or [])

    def relu(v):
        own = v.detach() > 0
        seen.append(own.cpu())
        if masks is None:
            return v * own
        mask = next(given).to(v.device)
        far = v.detach().abs() > 1e-5
        assert torch.equal(own[far], mask[far])
        return v * mask

    monkeypatch.setattr(torch, "relu", relu)
    logits = model(torch.from_numpy(x).to(device))
    monkeypatch.undo()
    cross_entropy(logits, torch.from_numpy(y).to(device)).mean().backward()
    return (logits.detach().cpu(),
            {n: p.grad.cpu() for n, p in model.named_parameters()}, seen)


def test_resnet_card_equals_cpu(cuda_device, monkeypatch):
    x, y = _cifar(8)
    ref = create_model("resnet20", device="cpu")
    with torch.no_grad():
        ref(torch.from_numpy(x[:1]))
    ref.reset_parameters(torch.Generator().manual_seed(0))
    state_dict = ref.state_dict()
    want_logits, want, masks = _logits_and_grads("cpu", state_dict, x, y,
                                                 monkeypatch)
    got_logits, got, _ = _logits_and_grads(cuda_device, state_dict, x, y,
                                           monkeypatch, masks)
    assert len(masks) == 1 + 2 * 9
    torch.testing.assert_close(got_logits, want_logits, **LOGITS)
    for name, w in want.items():
        err = (got[name] - w).norm() / w.norm()
        assert err < GRAD_FROBENIUS, (name, float(err))


def _async_steps(mesh, x, y, n_steps=3):
    eng = AsyncLocalEngine(create_model("resnet20",
                                        device=None if mesh else "cuda"),
                           mesh=mesh, sync_every=2)
    state = eng.init_state(torch.Generator().manual_seed(0), x)
    losses = []
    for i in range(n_steps):
        xs, ys = eng.shard_batch(x[32 * i:32 * i + 32], y[32 * i:32 * i + 32])
        state, m = eng.step(state, xs, ys)
        losses.append(float(m["loss"]))
    mean = eng.eval_params(state)
    return losses, {k: v.cpu() for k, v in state.model.state_dict().items()}, \
        {k: v.cpu() for k, v in mean.state_dict().items()}


def test_async_nccl_one_rank_equals_no_mesh(cuda_device):
    x, y = _cifar(96)
    want_losses, want, _ = _async_steps(None, x, y)
    mesh = meshlib.create_mesh(1)
    try:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        before = coll.all_reduce_.nccl_launches
        got_losses, got, mean = _async_steps(mesh, x, y)
        # three steps (two metric reductions, one parameter mean) and
        # eval_params
        assert coll.all_reduce_.nccl_launches == before + 4
    finally:
        mesh.close()
    assert got_losses == want_losses
    for name, w in want.items():
        assert torch.equal(got[name], w), name
        assert torch.equal(mean[name], w), name
