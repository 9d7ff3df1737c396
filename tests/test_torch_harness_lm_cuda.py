"""The optimizer recipe inside a CUDA graph on the card.  Marked ``cuda``:
skipped without an NVIDIA GPU (CUDA graphs and the Hopper kernels have no
CPU mode).  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_harness_lm_cuda.py

* A small flash GPT under ``bf16-f32master`` with the recipe (a linear
  schedule with a warmup, weight decay 0.1, a clip that fires), three
  chunks of 8 steps through ``SyncEngine.many_step`` (chunk 1 eager,
  chunk 2 captured and replayed, chunk 3 replayed) against three eager
  chunks (``Engine.many_step``): per-step losses, the flat f32 master and
  the optimizer's state bitwise equal, dropout on.  A learning rate
  written on the host would be frozen in the graph at its value at
  capture, and the replayed chunks would differ.
* The learning rate each step applies, recorded on the device at its
  count by the schedule itself: in the replayed chunks it is the
  schedule's value at every count, so a linear warmup of 12 steps rises
  within a chunk of 8 as it does eagerly.

The two tests take about 20 s on one H100 (most of it the kernels' build
when they are not built yet).
"""

import functools

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.data import loaders
from distributed_tensorflow_tpu_torch.engines import Engine, SyncEngine
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.utils import harness
from distributed_tensorflow_tpu_torch.utils import optim

pytestmark = pytest.mark.cuda

GPT = dict(num_classes=64, hidden=64, layers=2, heads=2, ffn=128,
           max_len=32, attention_impl="flash", dropout_rate=0.1,
           dtype="bfloat16")
RECIPE = dict(learning_rate=1e-3, lr_schedule="linear", warmup_steps=12,
              weight_decay=0.1, clip_norm=0.1, epochs=1)
CHUNKS, K, B = 3, 8, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the Hopper "
                    "kernels have no CPU mode")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _run(graph: bool):
    """Three chunks of K steps; returns losses, master, inner state and the
    learning rate recorded at each count."""
    ds = loaders.load_lm_dataset("lm_synth", seq_len=32, vocab_size=64,
                                 n_train=CHUNKS * K * B)
    model = create_model("gpt", **GPT)
    config = harness.ExperimentConfig(**RECIPE)
    factory = harness._make_optimizer(config, ds, B, model)
    seen = torch.zeros(CHUNKS * K + 1, device="cuda")

    def recording(params):
        opt = factory(params)
        schedule = opt.schedule

        def sched(count):
            lr = schedule(count)
            seen.index_copy_(0, count.long().reshape(1), lr.reshape(1))
            return lr

        opt.schedule = sched
        return opt

    eng = SyncEngine(model, optimizer=recording,
                     precision="bf16-f32master", device="cuda")
    state = eng.init_state(torch.Generator().manual_seed(0))
    losses = []
    drain = (eng.many_step if graph
             else functools.partial(Engine.many_step, eng))
    for c in range(CHUNKS):
        xs, ys = zip(*(eng.shard_batch(ds.x[B * i:B * (i + 1)],
                                       ds.y[B * i:B * (i + 1)])
                       for i in range(c * K, (c + 1) * K)))
        state, m = drain(state, list(xs), list(ys))
        losses.append(m["loss"].float().cpu())
    assert bool(eng._graphs) == graph
    opt = state.optimizer
    inner = opt.inner.state[opt.master]
    torch.cuda.synchronize()
    return (torch.cat(losses), opt.master.cpu(),
            {k: v.cpu() for k, v in inner.items()}, seen.cpu(),
            type(opt.inner))


def test_replayed_recipe_chunk_equals_eager(cuda_device):
    eager, replayed = _run(False), _run(True)
    assert replayed[4] is optim.ScheduledAdamW     # the recipe's optimizer
    assert torch.equal(eager[0], replayed[0]), (eager[0], replayed[0])
    assert torch.equal(eager[1], replayed[1])
    for key in eager[2]:
        assert torch.equal(eager[2][key], replayed[2][key]), key
    assert float(replayed[2]["step"]) == CHUNKS * K


def test_replayed_lr_moves_with_the_count(cuda_device):
    eager, replayed = _run(False), _run(True)
    want = harness.make_lr_schedule(
        harness.ExperimentConfig(**RECIPE), CHUNKS * K)(
        torch.arange(CHUNKS * K, dtype=torch.float32))
    got = replayed[3][:CHUNKS * K]
    assert torch.equal(got, eager[3][:CHUNKS * K])
    # the card's division and the CPU's may round a value apart: a few
    # f32 ulps
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    # chunk 2 is the captured one, chunk 3 a replay: both climb the
    # warmup (counts 8..11) and then decay, step by step
    assert np.all(np.diff(got[K:12].numpy()) > 0), got
    assert np.all(np.diff(got[12:].numpy()) < 0), got
