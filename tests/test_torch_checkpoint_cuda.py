"""Checkpoints on the card: the async snapshot's ordering, a restore into
a state whose chunk is already captured as a CUDA graph, and exactly-once
resume with the dropout generator's state.  Marked ``cuda``: skipped
without an NVIDIA GPU.  On the card, with no JAX installed there:

    python -m pytest -m cuda tests/test_torch_checkpoint_cuda.py

A small dense-attention GPT with dropout 0.1 (so the Philox stream is
part of what a resume must restore), f32, TF32 off, chunks of 4 steps
replayed as CUDA graphs by ``SyncEngine``.  Every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch.data.loaders import Dataset
from distributed_tensorflow_tpu_torch.elastic import elastic_restore
from distributed_tensorflow_tpu_torch.engines import SyncEngine, Trainer
from distributed_tensorflow_tpu_torch.engines.sync import _ChunkGraph
from distributed_tensorflow_tpu_torch.models import create_model
from distributed_tensorflow_tpu_torch.utils.checkpoint import (
    AsyncCheckpointManager, CheckpointManager)

pytestmark = pytest.mark.cuda

GPT = dict(num_classes=256, hidden=256, layers=2, heads=4, ffn=1024,
           max_len=64, dropout_rate=0.1, attention_impl="dense")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pinned non-blocking copies, CUDA "
                    "graphs and the CUDA generator have no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield "cuda"
    torch.backends.cuda.matmul.allow_tf32 = saved


def _ds(n=256):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (n, 64)).astype(np.int32)
    return Dataset(x=x, y=np.roll(x, -1, axis=1), num_classes=256,
                   name="tokens", synthetic=True)


def _engine(precision="f32"):
    return SyncEngine(create_model("gpt", device="cuda", **GPT),
                      precision=precision)


def _state_dict(path, step):
    return torch.load(f"{path}/step_{step}/state.pt", weights_only=True)


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k, v in a.items():
        assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k


def test_async_snapshot_is_the_state_of_its_step(cuda_device, tmp_path):
    """An async save followed at once by steps that change the state in
    place writes the state of its step: the same bytes as a synchronous
    save of it (the snapshot is enqueued on the compute stream before
    the next step and copied into pinned buffers)."""
    ds = _ds()
    tr = Trainer(None, engine=_engine(), seed=0)
    tr.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
           max_steps=8)
    sync = CheckpointManager(tmp_path / "sync")
    sync.save(tr.state)
    mgr = AsyncCheckpointManager(tmp_path / "async")
    mgr.save(tr.state)
    tr.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
           max_steps=8)  # in place, while the writer may still copy
    mgr.close()
    _equal(_state_dict(tmp_path / "sync", 8), _state_dict(tmp_path / "async",
                                                          8))
    assert all(t.is_pinned() for t in mgr._pinned.values()) or \
        not mgr._pinned


@pytest.mark.parametrize("precision", ["f32", "bf16-f32master"])
def test_resume_into_a_captured_state_is_bitwise(cuda_device, tmp_path,
                                                 precision):
    """Uninterrupted: 16 steps in chunks of 4 (replayed graphs).  Resumed:
    8 steps with a checkpoint, 8 more (the chunk's graph captured and
    replayed), then the step-8 checkpoint restored IN PLACE into that
    captured state (parameters, optimizer, master and generator copied
    into the tensors the graph replays) and the last 8 steps again from
    the checkpoint's data state: the final state is bitwise the
    uninterrupted one, and no new graph was captured."""
    ds = _ds()
    whole = Trainer(None, engine=_engine(precision), seed=0)
    whole.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
              max_steps=16)
    mgr = CheckpointManager(tmp_path / "c")
    tr = Trainer(None, engine=_engine(precision), seed=0)
    tr.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
           max_steps=8, checkpoint_manager=mgr, checkpoint_every=8)
    tr.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
           max_steps=8)
    captures = _ChunkGraph.captures
    state, extra = elastic_restore(mgr, tr.engine, tr.state, step=8)
    assert state is tr.state and state.step == 8
    r = tr.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
               max_steps=8, data_state=extra["data_state"])
    assert r["resume_replay_steps"] == 0 and r["start_step"] == 8
    assert _ChunkGraph.captures == captures
    a, b = (e.engine.checkpoint_state(e.state) for e in (whole, tr))
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v.cpu(), b[k].cpu()), k
        else:
            assert v == b[k], k


def test_fresh_engine_resume_is_bitwise(cuda_device, tmp_path):
    """A crash's restart: a fresh engine and Trainer restore the async
    checkpoint of step 8 (with the generator's state) and train on to the
    uninterrupted run's bits."""
    ds = _ds()
    whole = Trainer(None, engine=_engine(), seed=0)
    whole.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
              max_steps=16)
    mgr = AsyncCheckpointManager(tmp_path / "c")
    first = Trainer(None, engine=_engine(), seed=0)
    first.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
              max_steps=8, checkpoint_manager=mgr, checkpoint_every=4)
    assert mgr.steps() == [4, 8]
    tr = Trainer(None, engine=_engine(), seed=0)
    template = tr.engine.init_state(torch.Generator().manual_seed(0),
                                    ds.x[:1])
    tr.state, extra = elastic_restore(mgr, tr.engine, template)
    mgr.close()
    tr.fit(ds, epochs=1, batch_size=8, log_every=0, steps_per_call=4,
           max_steps=8, data_state=extra["data_state"])
    assert torch.equal(whole.state.generator.get_state(),
                       tr.state.generator.get_state())
    for (n, p), q in zip(whole.state.model.named_parameters(),
                         tr.state.model.parameters()):
        assert torch.equal(p, q), n
