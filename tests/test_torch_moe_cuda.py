"""Mixture-of-Experts on the card.  Marked ``cuda``: skipped without an
NVIDIA GPU.  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_moe_cuda.py

The MoE layer is plain PyTorch (the router, the one-hots, the cumsums and
library GEMMs under the einsums); the MoE GPT's attention runs the flash
kernels.  Here:

* ``MoELayer`` on the card against the same layer on the CPU (2048 tokens
  of width 128 in two groups of 1024, 8 experts, top-1 and top-2): the
  ``dispatch`` tensors equal (the data is drawn so that no token's two
  largest router probabilities lie within ``TIE_GAP``, where the card's
  f32 sums, in another order, could flip an argmax), ``overflow`` equal,
  the outputs within ``1e-5`` at f32 (TF32 off) and within ``BF16_TOL``
  at bf16;
* a MoE GPT (flash, bf16) trained by ``SyncEngine.many_step`` in chunks
  of 2 (eager, then captured and replayed as a CUDA graph) against eager
  chunks: losses and parameters bitwise equal;
* ``ExpertParallelEngine`` on a (1, 1) NCCL mesh against ``SyncEngine``
  (f32, SGD on both, one batch four times): the task loss within
  ``1e-5`` relative on every step with the router terms weighted 0; with
  them, ``total_loss - loss`` equal to ``aux_weight·aux +
  router_z_weight·z`` within ``1e-6``, ``overflow`` in [0, 1], and the
  loss falling.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.engines import (
    Engine, ExpertParallelEngine, SyncEngine)
from distributed_tensorflow_tpu_torch.engines.expert_parallel import (
    router_losses)
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.models.moe import MoELayer
from distributed_tensorflow_tpu_torch.parallel import mesh as meshlib

pytestmark = pytest.mark.cuda

TIE_GAP = 1e-5
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels and NCCL have "
                    "no CPU mode")
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = flag


def _layer_inputs(k, seed=8, tokens=2048, d=128):
    """A layer and tokens drawn with numpy (the same bits under any torch)
    whose router has no near-tie at f32: this seed's smallest gaps are
    3.5e-4 (first to second) and 5.1e-5 (second to third)."""
    rng = np.random.default_rng(seed)
    layer = MoELayer(d, 8, 256, 1.25, k, device="cpu")

    def draw(shape, fan_in):
        return torch.tensor((rng.standard_normal(shape)
                             / np.sqrt(fan_in)).astype(np.float32))

    with torch.no_grad():
        layer.gate.copy_(draw(layer.gate.shape, d))
        x = draw((tokens, d), 1)
        layer.w1.copy_(draw(layer.w1.shape, d))
        layer.w2.copy_(draw(layer.w2.shape, 256))
    with torch.no_grad():
        probs = torch.softmax(x @ layer.gate, dim=-1).sort(dim=-1).values
    gaps = probs[:, -1] - probs[:, -2]
    if k == 2:
        gaps = torch.minimum(gaps, probs[:, -2] - probs[:, -3])
    assert float(gaps.min()) > TIE_GAP, float(gaps.min())
    return layer, x


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_on_the_card_equals_the_cpu(cuda_device, k, dtype):
    layer, x = _layer_inputs(k)
    layer.dtype = dtype
    out = {}
    for dev in ("cpu", "cuda"):
        layer = layer.to(dev)
        with torch.no_grad():
            xg = x.to(dev).to(dtype).reshape(2, 1024, -1)
            dispatch, _ = layer.route(xg)
            y = layer(x.to(dev).to(dtype), group_size=1024)
        out[dev] = (dispatch.cpu(), float(layer.overflow), y.float().cpu())
    (d0, o0, y0), (d1, o1, y1) = out["cpu"], out["cuda"]
    assert torch.equal(d0, d1)
    assert o0 == o1
    tol = (dict(rtol=0, atol=1e-5) if dtype == torch.float32 else BF16_TOL)
    torch.testing.assert_close(y1, y0, **tol)


def _lm_batches(chunks, k, rows=4, seq=64, vocab=256):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, vocab, (chunks * k * rows, seq + 1)).astype(
        np.int32)
    return [(tok[i * rows:(i + 1) * rows, :-1], tok[i * rows:(i + 1) * rows,
                                                    1:])
            for i in range(chunks * k)]


def test_captured_moe_chunk_equals_eager_chunks(cuda_device):
    """Chunk 1 eager, chunk 2 captured and replayed, chunk 3 replayed,
    against three eager chunks: the MoE layer reads nothing back to the
    host, so the step captures, and the replays give the eager bits."""
    chunks, k = 3, 2
    batches = _lm_batches(chunks, k)
    runs = {}
    for graph in (False, True):
        mesh = meshlib.create_mesh(1)
        try:
            model = create_model("gpt", num_classes=256, hidden=128,
                                 layers=2, heads=2, ffn=256, max_len=64,
                                 dropout_rate=0.0, dtype="bfloat16",
                                 attention_impl="flash", moe_experts=4,
                                 moe_top_k=2)
            eng = SyncEngine(model, mesh=mesh)
            state = eng.init_state(torch.Generator().manual_seed(0))
            drain = eng.many_step if graph else functools.partial(
                Engine.many_step, eng)
            losses = []
            for c in range(chunks):
                xs, ys = zip(*(eng.shard_batch(*b)
                               for b in batches[c * k:(c + 1) * k]))
                state, m = drain(state, list(xs), list(ys))
                losses.append(m["loss"].cpu())
            assert bool(eng._graphs) == graph
            runs[graph] = (torch.cat(losses),
                           [p.detach().cpu() for p in model.parameters()])
        finally:
            mesh.close()
    (l0, p0), (l1, p1) = runs[False], runs[True]
    assert torch.isfinite(l0).all()
    assert torch.equal(l0, l1), (l0, l1)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_expert_parallel_engine_on_one_rank(cuda_device):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    mesh = meshlib.create_mesh(1, shape=(1, 1),
                               axis_names=("data", "expert"))
    try:
        runs = []
        for cls, kw in ((ExpertParallelEngine, dict(aux_weight=0.0)),
                        (SyncEngine, {}),
                        (ExpertParallelEngine, dict(aux_weight=0.01,
                                                    router_z_weight=1e-3))):
            model = create_model("moe", dropout_rate=0.0, router_top_k=2)
            # one optimizer for both engines (SyncEngine's default Adam is
            # capturable on the card, the expert engine's is not)
            eng = cls(model, mesh=mesh, **kw,
                      optimizer=lambda p: torch.optim.SGD(p, lr=0.1))
            state = eng.init_state(torch.Generator().manual_seed(0), x[:1])
            metrics = []
            # one batch four times: random labels, which only a batch
            # seen again can teach
            xs, ys = eng.shard_batch(x[:16], y[:16])
            for _ in range(4):
                state, m = eng.step(state, xs, ys)
                m = {key: float(v) for key, v in m.items()}
                if "total_loss" in m:
                    aux, z, _ = router_losses(model)
                    want = (eng.aux_weight * float(aux.detach())
                            + eng.router_z_weight * float(z.detach()))
                    assert abs(m["total_loss"] - m["loss"] - want) <= 1e-6
                    assert 0.0 <= m["overflow"] <= 1.0
                metrics.append(m)
            runs.append(metrics)
    finally:
        mesh.close()
    ep, sync, full = runs
    np.testing.assert_allclose([m["loss"] for m in ep],
                               [m["loss"] for m in sync], rtol=1e-5)
    assert full[0]["loss"] == pytest.approx(sync[0]["loss"], rel=1e-5)
    assert full[-1]["loss"] < full[0]["loss"]
